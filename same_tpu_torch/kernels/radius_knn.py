"""K3 ``radius_knn``: the k nearest refs of every query within a radius.

``radius_knn`` launches ``csrc/radius_knn.cu`` for CUDA tensors and runs
``radius_knn_plain``, a PyTorch transcription of
``same_tpu/ops/pairwise.py:19-67`` (``radius_knn_tpu``), for CPU tensors.
Both take float32 ``query_xy`` [n, 2] and ``ref_xy`` [m, 2] and return
``(idx, dist, mask)`` as [n, k] int32, float32 and bool, padded with
-1 / +inf / False; neighbours ascend by distance, ties go to the lower ref
index.

Both evaluate the squared distance by the same f32 expansion in the same
order, ``(qx*qx + qy*qy) + (rx*rx + ry*ry) - 2*(qx*rx + qy*ry)``, clamp it
at 0 and test it against ``float32(radius)**2``, so on one device they agree
bit for bit. Far from the origin the expansion differs from the exact
distance in its last bits (at coordinates near 13,000 by some units^2), and
membership at the radius' edge follows the expansion, as it does in XLA.

The kernel keeps each query's best 64 in registers; a larger k takes
ceil(k / 64) launches, each pass filling the next 64 columns with the refs
that follow the previous pass's last one in (distance, ref index) order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

INF = float("inf")


def radius_sq(radius: float) -> float:
    """``float32(radius) ** 2`` rounded to f32, as XLA squares the radius."""
    r = np.float32(radius)
    return float(np.float32(r * r))


def radius_knn_plain(query_xy, ref_xy, radius: float, k: int, tile: int = 1024):
    """Plain PyTorch version of K3 (same_tpu/ops/pairwise.py:19-67)."""
    n, m = query_xy.shape[0], ref_xy.shape[0]
    dev = query_xy.device
    r2 = radius_sq(radius)
    rx, ry = ref_xy[:, 0][None, :], ref_xy[:, 1][None, :]
    ref_sq = rx * rx + ry * ry
    idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((n, k), INF, dtype=torch.float32, device=dev)
    mask = torch.zeros((n, k), dtype=torch.bool, device=dev)
    for s in range(0, n, tile):
        qx, qy = query_xy[s:s + tile, 0:1], query_xy[s:s + tile, 1:2]
        inner = qx * rx + qy * ry
        d2 = ((qx * qx + qy * qy) + ref_sq) - 2.0 * inner
        d2 = d2.clamp_min(0.0)
        key = torch.where(d2 <= r2, d2, INF)
        # A stable sort gives equal keys in ascending ref index.
        key, order = torch.sort(key, dim=1, stable=True)
        kk = min(k, m)
        valid = torch.isfinite(key[:, :kk])
        sl = slice(s, s + tile)
        idx[sl, :kk] = torch.where(valid, order[:, :kk].to(torch.int32), -1)
        # The square root in float64, rounded once to f32: the correctly
        # rounded f32 root (XLA's, numpy's and K3's sqrtf). torch's f32 CPU
        # sqrt can be one ulp off it (37.0 -> 6.0827622).
        root = torch.sqrt(key[:, :kk].double()).float()
        dist[sl, :kk] = torch.where(valid, root, INF)
        mask[sl, :kk] = valid
    return idx, dist, mask


def _lib():
    lib = _build.load("radius_knn")
    if lib.same_radius_knn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_radius_knn.restype = i
        lib.same_radius_knn.argtypes = [p, p, i, i, ctypes.c_float, i, p, p, p, p,
                                        ctypes.POINTER(i)]
    return lib


def radius_knn(query_xy, ref_xy, radius: float, k: int):
    """k nearest refs within ``radius``: K3 on CUDA tensors, the plain
    version on CPU tensors."""
    k = int(k)
    if k < 1:
        raise ValueError(f"radius_knn: k must be at least 1, got {k}")
    if query_xy.device.type == "cpu":
        return radius_knn_plain(query_xy, ref_xy, radius, k)
    if query_xy.device.type != "cuda":
        raise ValueError(f"radius_knn: unsupported device {query_xy.device}")
    dev = query_xy.device
    n, m = query_xy.shape[0], ref_xy.shape[0]
    _build.check_tensors("radius_knn", dev, (
        ("query_xy", query_xy, torch.float32, (n, 2)),
        ("ref_xy", ref_xy, torch.float32, (m, 2)),
    ))
    lib = _lib()
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    mask = torch.empty((n, k), dtype=torch.bool, device=dev)
    if n == 0:
        return idx, dist, mask
    launches = ctypes.c_int(0)
    rc = lib.same_radius_knn(
        query_xy.data_ptr(), ref_xy.data_ptr(), n, m, radius_sq(radius), k,
        idx.data_ptr(), dist.data_ptr(), mask.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launches),
    )
    _build.check(lib, rc, "radius_knn")
    _build.count_launch(radius_knn, n=launches.value)
    return idx, dist, mask


radius_knn.launches = 0
