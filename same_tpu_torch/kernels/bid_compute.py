"""K9 ``bid_compute``: the compute-only step of an auction bidding round.

``bid_compute`` launches ``csrc/bid_compute.cu`` for CUDA tensors and runs
``bid_compute_plain`` for CPU tensors. Both follow the Pallas kernel of
``examples/bench_pallas.py:98-139`` line by line: masked values with the
sentinel ``NEG = -3e38``, a top-2 unrolled over the C columns and then the
no-match column with ties to the lower index, and the increment at eps = 1.
Arguments: ``costs`` and ``p_slot`` (the gathered slot prices) [n, C] f32,
``valid`` [n, C] bool, ``nm`` [n] f32. Returns ``(choice [n] int32, incr [n]
f32)``. The microbenchmark ``same_tpu_torch.microbench`` times it; no solve
path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG = -3.0e38


def bid_compute_plain(costs, p_slot, valid, nm):
    """Plain PyTorch version of K9, the Pallas kernel body."""
    n, C = costs.shape
    vals = torch.where(valid, -(costs + p_slot), NEG)
    best = torch.full((n,), NEG, dtype=torch.float32, device=costs.device)
    second = best.clone()
    bidx = torch.zeros(n, dtype=torch.int32, device=costs.device)
    columns = [vals[:, k] for k in range(C)] + [-nm]
    for k, vk in enumerate(columns):
        better = vk > best
        second = torch.where(better, best, torch.maximum(second, vk))
        bidx = torch.where(better, k, bidx)
        best = torch.where(better, vk, best)
    incr = best - torch.where(second > NEG, second, best - 1.0) + 1.0
    return bidx, incr


def _lib():
    lib = _build.load("bid_compute")
    if lib.same_bid_compute.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_bid_compute.restype = i
        lib.same_bid_compute.argtypes = [p] * 4 + [i, i] + [p] * 3
    return lib


def bid_compute(costs, p_slot, valid, nm):
    """Compute-only bid step: K9 on CUDA tensors, the plain version on CPU
    tensors."""
    if costs.device.type == "cpu":
        return bid_compute_plain(costs, p_slot, valid, nm)
    if costs.device.type != "cuda":
        raise ValueError(f"bid_compute: unsupported device {costs.device}")
    dev = costs.device
    n, C = costs.shape
    _build.check_tensors("bid_compute", dev, (
        ("costs", costs, torch.float32, (n, C)),
        ("p_slot", p_slot, torch.float32, (n, C)),
        ("valid", valid, torch.bool, (n, C)),
        ("nm", nm, torch.float32, (n,)),
    ))
    choice = torch.empty(n, dtype=torch.int32, device=dev)
    incr = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return choice, incr
    with torch.cuda.device(dev):
        lib = _lib()
        rc = lib.same_bid_compute(
            costs.data_ptr(), p_slot.data_ptr(), valid.data_ptr(), nm.data_ptr(), n, C,
            choice.data_ptr(), incr.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "bid_compute")
    _build.count_launch(bid_compute)
    return choice, incr


bid_compute.launches = 0
