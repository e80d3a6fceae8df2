"""Times of K7 ``tear_scalars`` and K8 ``register_cuts`` on the card.

    python3 tear_round_bench.py STATES [--root DIR] [--label NAME]

``STATES`` is the file that ``chip_smoke.py --save-tear-states STATES``
writes: the inputs of K7 and K8 at the LUAD window's first tear round and
on phase 6's stack of grid windows. The kernels timed are those of the
``same_tpu_torch`` package under ``--root`` (default: the checkout this
file is in), so that two trees are timed on the same inputs in one call,
in turns. For each kernel and input it prints, as one JSON line:

- ``wrapper_ms``: the wrapper call, CUDA events around each call (a K8
  call's state is reset before its start event), the median;
- ``kernel_ms``: the kernel alone, the median of its launches' device
  durations in a ``torch.profiler`` trace (null where the trace holds no
  device time);
- ``floor_kernel_ms``: the kernel alone on the same input with its gathers
  taken away: K7 with every row unmatched (no cost or ref is gathered), K8
  with no triangle flipped (no cut is tested). The gap to ``kernel_ms`` is
  what the gathers cost.

The timing functions are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chip_smoke import kernel_ms, median_ms, timed_reset


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
        k7 = [t.to(dev) for t in st["k7_args"]]
        k8 = [t.to(dev) for t in st["k8_args"]]
        state = [t.to(dev) for t in st["k8_state"]]
        out[name] = {
            "k7": k7_times(k7, st.get("windows")),
            "k8": k8_times(k8, state, st["register"], st["cuts_added"], st["kw"]),
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
