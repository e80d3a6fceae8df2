"""K2 ``tear_metrics``: the tear round's flip test and cheapest-to-move vertex.

``tear_metrics`` launches ``csrc/tear_metrics.cu`` for CUDA tensors and runs
``tear_metrics_plain``, a PyTorch transcription of
``same_tpu/solver/tearing.py:72-104`` (``_tear_metrics``), for CPU tensors.
Arguments follow ``_tear_metrics``; both return ``(checked, flipped, vmove)``
as [T] bool, [T] bool and [T] int8.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.orient import matched_triangle_flips
from . import _build

NEG_INF = float("-inf")


def tear_metrics_plain(
    costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask, src,
    ref_xy, prices, choice,
):
    """Plain PyTorch twin of K2 (same_tpu/solver/tearing.py:72-104)."""
    n, C = costs.shape
    col = choice.clamp(0, C - 1).long()[:, None]
    is_match = choice < C
    match_pair = torch.where(is_match, pair_idx.gather(1, col)[:, 0], -1)
    match_ref = torch.where(is_match, cand_ref.gather(1, col)[:, 0], -1)

    checked, flipped = matched_triangle_flips(ref_xy, tris, tri_mask, match_ref, src)

    # Auction regret: held value minus best alternative outside the held pair.
    eff = costs + extra
    p_slot = prices[slots.long()]
    vals = torch.where(valid, -(eff + p_slot), NEG_INF)
    held = torch.where(is_match, vals.gather(1, col)[:, 0], -nm)
    alt_mask = valid & (pair_idx != match_pair[:, None])
    alt_best = torch.maximum(
        torch.where(alt_mask, vals, NEG_INF).max(dim=1).values, -nm
    )
    regret = held - alt_best
    tri_regret = regret[tris.clamp(0, n - 1).long()]
    vmove = tri_regret.argmin(dim=1).to(torch.int8)
    return checked, flipped, vmove


def _lib():
    lib = _build.load("tear_metrics")
    if lib.same_tear_metrics.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_tear_metrics.restype = i
        lib.same_tear_metrics.argtypes = [p] * 13 + [i, i, i, i] + [p] * 4
    return lib


def tear_metrics(
    costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask, src,
    ref_xy, prices, choice,
):
    """Flip test + vmove: K2 on CUDA tensors, the plain twin on CPU tensors."""
    args = (costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask,
            src, ref_xy, prices, choice)
    if costs.device.type == "cpu":
        return tear_metrics_plain(*args)
    if costs.device.type != "cuda":
        raise ValueError(f"tear_metrics: unsupported device {costs.device}")
    n, C = costs.shape
    T = tris.shape[0]
    m = ref_xy.shape[0]
    S1 = prices.shape[0]
    _build.check_tensors("tear_metrics", costs.device, (
        ("costs", costs, torch.float32, (n, C)),
        ("extra", extra, torch.float32, (n, C)),
        ("slots", slots, torch.int32, (n, C)),
        ("valid", valid, torch.bool, (n, C)),
        ("nm", nm, torch.float32, (n,)),
        ("pair_idx", pair_idx, torch.int32, (n, C)),
        ("cand_ref", cand_ref, torch.int32, (n, C)),
        ("tris", tris, torch.int32, (T, 3)),
        ("tri_mask", tri_mask, torch.bool, (T,)),
        ("src", src, torch.int32, (T,)),
        ("ref_xy", ref_xy, torch.float32, (m, 2)),
        ("prices", prices, torch.float32, (S1,)),
        ("choice", choice, torch.int32, (n,)),
    ))
    lib = _lib()
    checked = torch.empty(T, dtype=torch.bool, device=costs.device)
    flipped = torch.empty(T, dtype=torch.bool, device=costs.device)
    vmove = torch.empty(T, dtype=torch.int8, device=costs.device)
    stream = torch.cuda.current_stream(costs.device).cuda_stream
    rc = lib.same_tear_metrics(
        choice.data_ptr(), cand_ref.data_ptr(), pair_idx.data_ptr(),
        costs.data_ptr(), extra.data_ptr(), slots.data_ptr(), valid.data_ptr(),
        nm.data_ptr(), prices.data_ptr(), tris.data_ptr(), tri_mask.data_ptr(),
        src.data_ptr(), ref_xy.data_ptr(), n, C, m, T, checked.data_ptr(),
        flipped.data_ptr(), vmove.data_ptr(), stream,
    )
    _build.check(lib, rc, "tear_metrics")
    tear_metrics.launches += 1
    return checked, flipped, vmove


tear_metrics.launches = 0
