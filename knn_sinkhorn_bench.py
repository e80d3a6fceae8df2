"""Times of K3 ``radius_knn`` and K10 ``sinkhorn_dense`` on the card.

    python3 knn_sinkhorn_bench.py STATES [--root DIR] [--label NAME]

``STATES`` is the file that ``chip_smoke.py --save-tear-states STATES``
writes; its ``knn`` entry holds the LUAD window's coordinates (10,681
queries, 11,418 refs). The kernels timed are those of the ``same_tpu_torch``
package under ``--root`` (default: the checkout this file is in), so that two
trees are timed on the same inputs in one call, in turns. The inputs:

- K3 (a) the LUAD window, k = 8, radius 250 (phase 2's case); (b) k = 65,
  radius 800; (c) radius inf, k = 1 (the nearest-neighbour call); (d) the
  automatic cutover, 64,000 x 64,000 points uniform over a 30,800-unit
  square at LUAD density (``chip_smoke.KNN_CUTOVER``), k = 8, radius 250;
- K10 at [4096, 4096], eps 0.05, 200 iterations (``chip_smoke.k10_inputs``).

It prints one JSON line; for each kernel and input:

- ``wrapper_ms``: the wrapper call, CUDA events around each call, the median;
- ``kernel_ms``: the kernel alone, the median over the calls of a call's
  device work summed, in a ``torch.profiler`` trace (null where the trace
  holds no device time): for K3 every launch, memset and copy of the call
  (``chip_smoke.K3_CALL``); ``launches``: those device operations a call and
  ``launch_ms`` the median one;
- K3 only: ``pass_kernel_ms`` and ``binning_kernel_ms``, the same for the
  pass kernel's launches and for the binning's device work (the bounds and
  the counting sort; null for a tree without them); ``binning_ms``:
  ``knn_grid`` as a call, CUDA events, the median (null for a tree without it).

The timing functions are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from chip_smoke import (
    K3_BINNING, K3_CALL, K3_KERNEL, K10_KERNELS, KNN_CUTOVER, k10_inputs, kernel_stats, median_ms,
)


def alone(fn, names, reps=20):
    """kernel_stats' fields under the names this script prints."""
    st = kernel_stats(fn, names, reps=reps)
    if st is None:
        return {"kernel_ms": None, "launches": None, "launch_ms": None}
    return {"kernel_ms": st["ms"], "launches": st["launches"], "launch_ms": st["launch_ms"]}


def k3_times(q, r, radius, k, reps=20):
    """K3's times on (q, r) on the card."""
    import importlib

    mod = importlib.import_module("same_tpu_torch.kernels.radius_knn")

    def fn():
        return mod.radius_knn(q, r, radius, k)

    grid = getattr(mod, "knn_grid", None)
    passes = kernel_stats(fn, K3_KERNEL, reps=reps)
    binning = None if grid is None else kernel_stats(fn, K3_BINNING, reps=reps)
    return {"wrapper_ms": median_ms(fn, reps=reps), **alone(fn, K3_CALL, reps),
            "pass_kernel_ms": passes and passes["ms"],
            "binning_kernel_ms": binning and binning["ms"],
            "binning_ms": None if grid is None else median_ms(lambda: grid(q, r, radius),
                                                              reps=reps)}


def k10_times(n, m, dev, eps=0.05, iters=200):
    """K10's times at [n, m] on the card."""
    from same_tpu_torch.kernels.sinkhorn_dense import sinkhorn_dense

    _np_in, (cost, a, b) = k10_inputs(n, m, dev)

    def fn():
        return sinkhorn_dense(cost, a, b, eps, iters)

    return {"wrapper_ms": median_ms(fn, reps=5, warmup=1), **alone(fn, K10_KERNELS, reps=5)}


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
        raise SystemExit("knn_sinkhorn_bench: no CUDA card")
    import same_tpu_torch

    dev = torch.device("cuda", 0)
    knn = torch.load(a.states, weights_only=False)["knn"]
    q, r = knn["query"].to(dev), knn["ref"].to(dev)
    rng = np.random.default_rng(KNN_CUTOVER["seed"])
    pts, ext = KNN_CUTOVER["points"], KNN_CUTOVER["extent"]
    qd = torch.as_tensor(rng.uniform(0, ext, (pts, 2)).astype(np.float32)).to(dev)
    rd = torch.as_tensor(rng.uniform(0, ext, (pts, 2)).astype(np.float32)).to(dev)
    out = {"label": a.label, "package": os.path.dirname(same_tpu_torch.__file__),
           "device": torch.cuda.get_device_name(0),
           "k3": {"a": k3_times(q, r, 250.0, 8), "b": k3_times(q, r, 800.0, 65, reps=10),
                  "c": k3_times(q, r, float("inf"), 1, reps=10),
                  "d": k3_times(qd, rd, 250.0, 8, reps=10)},
           "k10": {"4096x4096": k10_times(4096, 4096, dev)}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
