"""Times of K9 ``bid_compute``, K1 ``auction_bid``, ``auction_loop`` and K5
``auction_loop_batch`` on the card.

    python3 bid_round_bench.py STATES [--root DIR] [--label NAME]

``STATES`` is the file that ``chip_smoke.py --save-tear-states STATES``
writes; its ``luad`` entry holds the LUAD window's problem ([12288, 24],
S = 28,672), its warm-start prices, phase 2 (a)'s schedule and that solve's
end state, and its ``k5`` entry phase 6 (a)'s stack of grid windows. The
kernels timed are those of the ``same_tpu_torch`` package under ``--root``
(default: the checkout this file is in), so that two trees are timed on the
same inputs in one call, in turns. The inputs:

- K9 on ``microbench.instance`` (the Pallas microbenchmark's) at [12288, 8]
  and [12288, 24], the prices gathered;
- K1 (a) on ``chip_smoke.k1_random_inputs``, the random [12288, 8] state of
  phase 2; (b) on the LUAD problem cold from its warm-start prices, every
  bidder active; (c) on the same problem warm, from phase 2 (a)'s end state,
  where few bidders are active;
- ``auction_loop`` (a): one solve of the LUAD window cold from its
  warm-start prices at obj_patience 128, as phase 2 (a) runs it;
- K5 on phase 6 (a)'s stack, cold, the full schedule at the batch's budget
  (left out where ``STATES`` comes from a run without phase 6, such as
  ``chip_smoke.py --no-slice``).

It prints one JSON line; for each kernel and input:

- ``wrapper_ms``: the wrapper call, the median: CUDA events around each call
  for K9 and K1, the host clock around a call and a synchronize for the
  solves (``chip_smoke.wall_ms``, 5 calls);
- ``kernel_ms``: the kernel alone, the median over the calls of a call's
  launches summed, in a ``torch.profiler`` trace (null where the trace holds
  no device time); ``launches``: its launches a call (K1: 1 in this design,
  3 before) and ``launch_ms`` the median launch;
- the solves only: ``rounds``, and ``phase_us``, us a bidding round in each
  phase of the loop (``auction_loop`` (a) only: the kernel's
  ``phase_cycles`` shares of ``kernel_ms``, over its rounds).

The timing functions are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from chip_smoke import (
    K1_KERNELS, K9_KERNEL, PHASES, k1_random_inputs, kernel_stats, median_ms, wall_ms,
)


def alone(fn, names, reps=20):
    """kernel_stats' fields under the names this script prints."""
    st = kernel_stats(fn, names, reps=reps)
    if st is None:
        return {"kernel_ms": None, "launches": None, "launch_ms": None}
    return {"kernel_ms": st["ms"], "launches": st["launches"], "launch_ms": st["launch_ms"]}


def k9_times(C, dev):
    from same_tpu_torch.kernels.bid_compute import bid_compute
    from same_tpu_torch.microbench import instance

    x = instance(12288, C, dev)
    args = (x["costs"], x["prices"][x["slots"].long()], x["valid"], x["nm"])

    def fn():
        return bid_compute(*args)

    return {"wrapper_ms": median_ms(fn), **alone(fn, K9_KERNEL)}


def k1_times(args):
    from same_tpu_torch.kernels.auction_bid import auction_bid

    def fn():
        return auction_bid(*args)

    return {"wrapper_ms": median_ms(fn), **alone(fn, K1_KERNELS)}


def loop_times(luad):
    """auction_loop (a): the solve's times, rounds and phase split."""
    import importlib

    import torch
    from same_tpu_torch.solver.auction import natural_stop_args

    tal = importlib.import_module("same_tpu_torch.kernels.auction_loop")
    costs, slots, valid, nm, slot_rows, slot_cols = luad["problem"]
    sched = luad["sched"]
    obj = natural_stop_args(costs.shape[0], float(sched[-1]), luad["patience"])
    kw = dict(slot_rows=slot_rows, slot_cols=slot_cols, obj_patience=obj[0],
              obj_tol=obj[1], obj_band=obj[2])

    def fn(**extra):
        return tal.auction_loop(costs, slots, valid, nm, luad["prices0"], sched, 500000,
                                **kw, **extra)

    cycles = torch.zeros(len(PHASES), dtype=torch.int64, device=costs.device)
    rounds = fn(phase_cycles=cycles).rounds
    out = {"wrapper_ms": wall_ms(fn), **alone(fn, "auction_loop_kernel", reps=10),
           "rounds": rounds}
    cyc = cycles.cpu().numpy().astype(np.float64)
    if out["kernel_ms"] is not None:
        share = cyc / max(cyc.sum(), 1.0)
        out["phase_us"] = {name: 1e3 * out["kernel_ms"] * x / max(rounds, 1)
                           for name, x in zip(PHASES, share.tolist())}
    return out


def k5_times(k5):
    from same_tpu_torch.kernels.auction_loop import auction_loop_batch

    def fn():
        return auction_loop_batch(*k5["args"], **k5["kw"])

    rounds = fn().rounds.tolist()
    return {"wrapper_ms": wall_ms(fn), **alone(fn, "auction_loop_batch_kernel", reps=10),
            "rounds": rounds}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("states", help="the file chip_smoke.py --save-tear-states wrote")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose same_tpu_torch is timed (default: this one)")
    ap.add_argument("--label", default="", help="a name for the tree, printed with the times")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bid_round_bench: no CUDA card")
    import same_tpu_torch

    dev = torch.device("cuda", 0)
    states = torch.load(a.states, weights_only=False)

    def on_card(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, tuple):
            return tuple(on_card(t) for t in x)
        if isinstance(x, dict):
            return {k: on_card(v) for k, v in x.items()}
        return x

    luad = on_card(states["luad"])
    costs, slots, valid, nm = luad["problem"][:4]
    n, S1 = costs.shape[0], luad["prices0"].shape[0]
    cold = (torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.full((S1,), -1, dtype=torch.int32, device=dev))
    prices, choice, owner = luad["warm"]
    out = {"label": a.label, "package": os.path.dirname(same_tpu_torch.__file__),
           "device": torch.cuda.get_device_name(0),
           "k9": {"12288x8": k9_times(8, dev), "12288x24": k9_times(24, dev)},
           "k1": {"a_random_12288x8": k1_times(k1_random_inputs(dev)),
                  "b_luad_cold": k1_times((costs, slots, valid, nm, luad["prices0"], *cold,
                                           luad["eps"])),
                  "c_luad_warm": k1_times((costs, slots, valid, nm, prices, choice, owner,
                                           luad["eps"]))},
           "auction_loop_a": loop_times(luad)}
    if "k5" in states:
        out["k5"] = k5_times(on_card(states["k5"]))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
