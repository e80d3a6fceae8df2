"""K2 ``tear_metrics``: the tear round's flip test and cheapest-to-move vertex.

``tear_metrics`` launches ``csrc/tear_metrics.cu`` for CUDA tensors and runs
``tear_metrics_plain``, a PyTorch transcription of
``same_tpu/solver/tearing.py:72-104`` (``_tear_metrics``), for CPU tensors.
Arguments follow ``_tear_metrics``; both return ``(checked, flipped, vmove)``
as [T] bool, [T] bool and [T] int8.

``tear_metrics_batch`` (kernel K6) does the same for every window of a batch
stacked on a leading axis, the vmapped tear round of
``same_tpu/solver/tearing_device.py::run_tearing_device_batch``: outputs
[B, T]; its plain version loops ``tear_metrics_plain`` over the windows.

On the card a call is two launches from one C call: the row regret (one warp
a row, into a [B * n] scratch the wrapper allocates), then the triangles.
``row_regret_plain`` is the first step's plain version, JAX's regret formula;
``launches`` counts calls.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.orient import matched_triangle_flips
from . import _build

NEG_INF = float("-inf")


def row_regret_plain(costs, extra, slots, valid, nm, pair_idx, cand_ref, prices, choice):
    """Each row's auction regret and matched ref, ``(regret [n] f32,
    match_ref [n] int)``: held value minus the best alternative outside the
    held pair (same_tpu/solver/tearing.py:85-101)."""
    C = costs.shape[1]
    col = choice.clamp(0, C - 1).long()[:, None]
    is_match = choice < C
    match_pair = torch.where(is_match, pair_idx.gather(1, col)[:, 0], -1)
    match_ref = torch.where(is_match, cand_ref.gather(1, col)[:, 0], -1)
    eff = costs + extra
    p_slot = prices[slots.long()]
    vals = torch.where(valid, -(eff + p_slot), NEG_INF)
    held = torch.where(is_match, vals.gather(1, col)[:, 0], -nm)
    alt_mask = valid & (pair_idx != match_pair[:, None])
    alt_best = torch.maximum(
        torch.where(alt_mask, vals, NEG_INF).max(dim=1).values, -nm
    )
    return held - alt_best, match_ref


def tear_metrics_plain(
    costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask, src,
    ref_xy, prices, choice,
):
    """Plain PyTorch twin of K2 (same_tpu/solver/tearing.py:72-104)."""
    n = costs.shape[0]
    regret, match_ref = row_regret_plain(
        costs, extra, slots, valid, nm, pair_idx, cand_ref, prices, choice
    )
    checked, flipped = matched_triangle_flips(ref_xy, tris, tri_mask, match_ref, src)
    tri_regret = regret[tris.clamp(0, n - 1).long()]
    vmove = tri_regret.argmin(dim=1).to(torch.int8)
    return checked, flipped, vmove


def _lib():
    lib = _build.load("tear_metrics")
    if lib.same_tear_metrics.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_tear_metrics.restype = i
        lib.same_tear_metrics.argtypes = [p] * 13 + [i] * 5 + [p] * 5
        lib.same_tear_metrics_batch.restype = i
        lib.same_tear_metrics_batch.argtypes = [p] * 13 + [i] * 6 + [p] * 5
    return lib


def _scratch(rows, device):
    """Step 1's output, one (regret f32, match_ref i32) pair a row."""
    return torch.empty((rows, 2), dtype=torch.int32, device=device)


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
    scratch = _scratch(n, costs.device)
    stream = torch.cuda.current_stream(costs.device).cuda_stream
    rc = lib.same_tear_metrics(
        choice.data_ptr(), cand_ref.data_ptr(), pair_idx.data_ptr(),
        costs.data_ptr(), extra.data_ptr(), slots.data_ptr(), valid.data_ptr(),
        nm.data_ptr(), prices.data_ptr(), tris.data_ptr(), tri_mask.data_ptr(),
        src.data_ptr(), ref_xy.data_ptr(), n, C, S1, m, T, scratch.data_ptr(),
        checked.data_ptr(), flipped.data_ptr(), vmove.data_ptr(), stream,
    )
    _build.check(lib, rc, "tear_metrics")
    _build.count_launch(tear_metrics)
    return checked, flipped, vmove


tear_metrics.launches = 0


def tear_metrics_batch_plain(
    costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask, src,
    ref_xy, prices, choice,
):
    """Plain version of K6: :func:`tear_metrics_plain` on each window."""
    outs = [tear_metrics_plain(*(a[b] for a in (
        costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask, src,
        ref_xy, prices, choice))) for b in range(costs.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def tear_metrics_batch(
    costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask, src,
    ref_xy, prices, choice,
):
    """K6 on CUDA tensors, its plain version on CPU tensors.

    Every argument of :func:`tear_metrics` with a leading batch axis B:
    [B, n, C] rows, [B, T, 3] triangles (padded ones with ``tri_mask`` False
    and ``src`` 0), [B, m, 2] ref coordinates, [B, S+1] prices, [B, n]
    choices. Returns ``(checked, flipped, vmove)`` as [B, T] tensors.
    """
    args = (costs, extra, slots, valid, nm, pair_idx, cand_ref, tris, tri_mask,
            src, ref_xy, prices, choice)
    if costs.device.type == "cpu":
        return tear_metrics_batch_plain(*args)
    if costs.device.type != "cuda":
        raise ValueError(f"tear_metrics_batch: unsupported device {costs.device}")
    B, n, C = costs.shape
    T = tris.shape[1]
    m = ref_xy.shape[1]
    S1 = prices.shape[1]
    _build.check_tensors("tear_metrics_batch", costs.device, (
        ("costs", costs, torch.float32, (B, n, C)),
        ("extra", extra, torch.float32, (B, n, C)),
        ("slots", slots, torch.int32, (B, n, C)),
        ("valid", valid, torch.bool, (B, n, C)),
        ("nm", nm, torch.float32, (B, n)),
        ("pair_idx", pair_idx, torch.int32, (B, n, C)),
        ("cand_ref", cand_ref, torch.int32, (B, n, C)),
        ("tris", tris, torch.int32, (B, T, 3)),
        ("tri_mask", tri_mask, torch.bool, (B, T)),
        ("src", src, torch.int32, (B, T)),
        ("ref_xy", ref_xy, torch.float32, (B, m, 2)),
        ("prices", prices, torch.float32, (B, S1)),
        ("choice", choice, torch.int32, (B, n)),
    ))
    checked = torch.empty((B, T), dtype=torch.bool, device=costs.device)
    flipped = torch.empty((B, T), dtype=torch.bool, device=costs.device)
    vmove = torch.empty((B, T), dtype=torch.int8, device=costs.device)
    if B == 0 or T == 0:
        return checked, flipped, vmove
    with torch.cuda.device(costs.device):
        lib = _lib()
        rc = lib.same_tear_metrics_batch(
            choice.data_ptr(), cand_ref.data_ptr(), pair_idx.data_ptr(),
            costs.data_ptr(), extra.data_ptr(), slots.data_ptr(), valid.data_ptr(),
            nm.data_ptr(), prices.data_ptr(), tris.data_ptr(), tri_mask.data_ptr(),
            src.data_ptr(), ref_xy.data_ptr(), B, n, C, S1, m, T,
            _scratch(B * n, costs.device).data_ptr(), checked.data_ptr(),
            flipped.data_ptr(), vmove.data_ptr(),
            torch.cuda.current_stream(costs.device).cuda_stream,
        )
        _build.check(lib, rc, "tear_metrics_batch")
    _build.count_launch(tear_metrics_batch)
    return checked, flipped, vmove


tear_metrics_batch.launches = 0
