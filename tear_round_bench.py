"""Times of K2 ``tear_metrics``, K6 ``tear_metrics_batch``, K4
``sinkhorn_sparse``, K7 ``tear_scalars`` and K8 ``register_cuts`` on the card.

    python3 tear_round_bench.py STATES [--root DIR] [--label NAME]

``STATES`` is the file that ``chip_smoke.py --save-tear-states STATES``
writes: the inputs of K2, K7 and K8 at the LUAD window's first tear round
(``luad_round0``), of K6, K7 and K8 on phase 6's stack of grid windows
(``stack``) and of K4 on the LUAD problem ([12288, 24], 100 iterations, eps
1.0; ``sinkhorn``). The kernels timed are those of the ``same_tpu_torch``
package under ``--root`` (default: the checkout this file is in), so that two
trees are timed on the same inputs in one call, in turns. It prints one JSON
line; for each kernel and input:

- ``wrapper_ms``: the wrapper call, CUDA events around each call (a K8
  call's state is reset before its start event), the median;
- ``kernel_ms``: the kernel alone, the median over 20 calls of the device
  durations of a call's launches summed, in a ``torch.profiler`` trace (null
  where the trace holds no device time); ``launches``: the kernel's device
  launches a call (K2 and K6: 2 in this design, 1 before; K4: 1, 201 before
  at 100 iterations) and ``launch_ms`` the median launch;
- K7 and K8 only, ``floor_kernel_ms``: the kernel alone on the same input
  with its gathers taken away: K7 with every row unmatched (no cost or ref
  is gathered), K8 with no triangle flipped (no cut is tested). The gap to
  ``kernel_ms`` is what the gathers cost;
- K4 only, ``ref_entry_lists_ms``: the wrapper's ``ref_entry_lists`` alone
  (with its clamp of the refs), CUDA events, the median.

The timing functions are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chip_smoke import K4_KERNELS, kernel_ms, kernel_stats, median_ms, timed_reset


def alone(fn, names):
    """kernel_stats' fields under the names this script prints."""
    st = kernel_stats(fn, names)
    if st is None:
        return {"kernel_ms": None, "launches": None, "launch_ms": None}
    return {"kernel_ms": st["ms"], "launches": st["launches"], "launch_ms": st["launch_ms"]}


def k2_times(args, batch=False):
    """K2's (K6's with ``batch``) times on ``args`` (its 13 tensors on the card)."""
    from same_tpu_torch.kernels.tear_metrics import tear_metrics, tear_metrics_batch

    wrapper = tear_metrics_batch if batch else tear_metrics

    def fn():
        return wrapper(*args)

    return {"wrapper_ms": median_ms(fn), **alone(fn, "tear_metrics")}


def k4_times(args, kw):
    """K4's times on ``args`` (its 4 tensors on the card) with ``kw``."""
    from same_tpu_torch.kernels.sinkhorn_sparse import ref_entry_lists, sinkhorn_sparse

    def fn():
        return sinkhorn_sparse(*args, **kw)

    ref = args[1].long()
    return {"wrapper_ms": median_ms(fn, reps=20, warmup=2), **alone(fn, K4_KERNELS),
            "ref_entry_lists_ms": median_ms(
                lambda: ref_entry_lists(ref.clamp(0, kw["n_ref"] - 1), args[2], kw["n_ref"]),
                reps=20, warmup=2)}


def k7_times(args, windows=None):
    """K7's times on ``args`` (its 11 tensors on the card)."""
    import torch
    from same_tpu_torch.kernels.tear_round import tear_scalars

    def fn():
        return tear_scalars(*args, windows=windows)

    unmatched = list(args)
    unmatched[2] = torch.full_like(args[2], args[0].shape[2])  # choice = C: no match
    return {"wrapper_ms": median_ms(fn), "kernel_ms": kernel_ms(fn, "tear_scalars"),
            "floor_kernel_ms": kernel_ms(lambda: tear_scalars(*unmatched, windows=windows),
                                         "tear_scalars")}


def k8_times(args, state, register, cuts_added, kw):
    """K8's times on ``args`` (its 6 input tensors on the card) from
    ``state`` (cut_mem, cut_cnt, extra), which is left as it was."""
    import torch
    from same_tpu_torch.kernels.tear_round import register_cuts

    work = [t.clone() for t in state]

    def reset():
        for w, s in zip(work, state):
            w.copy_(s)

    def fn(inputs=args):
        return register_cuts(*inputs, register, cuts_added, *work, **kw)

    unflipped = list(args)
    unflipped[4] = torch.zeros_like(args[4])
    return {"wrapper_ms": timed_reset(reset, fn),
            "kernel_ms": kernel_ms(fn, "register_cuts", reset),
            "floor_kernel_ms": kernel_ms(lambda: fn(unflipped), "register_cuts", reset)}


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
        raise SystemExit("tear_round_bench: no CUDA card")
    import same_tpu_torch

    dev = torch.device("cuda", 0)
    states = torch.load(a.states, weights_only=False)
    out = {"label": a.label, "package": os.path.dirname(same_tpu_torch.__file__),
           "device": torch.cuda.get_device_name(0)}
    for name, st in states.items():
        def on_card(key):
            return [t.to(dev) for t in st[key]]

        out[name] = times = {}
        if "k2_args" in st:
            times["k2"] = k2_times(on_card("k2_args"))
        if "k6_args" in st:
            times["k6"] = k2_times(on_card("k6_args"), batch=True)
        if "k4_args" in st:
            times["k4"] = k4_times(on_card("k4_args"), st["k4_kw"])
        if "k7_args" in st:
            times["k7"] = k7_times(on_card("k7_args"), st.get("windows"))
            times["k8"] = k8_times(on_card("k8_args"), on_card("k8_state"), st["register"],
                                   st["cuts_added"], st["kw"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
