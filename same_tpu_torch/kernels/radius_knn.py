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

On the card the refs are first binned into a uniform grid of square cells
(``knn_grid``: a counting sort of ``csrc/radius_knn.cu``; its time counts in
the wrapper call), and each query visits only the cells that overlap the square
of half-side ``reach`` around it. ``reach`` covers the radius plus a rigorous
bound on the expansion's rounding (``expansion_error``), so every ref that
the expansion admits lies in a visited cell and the answer is the plain
version's, bit for bit. Where the reach is not finite (radius ``inf``) or one
cell covers the refs, the grid is one cell and every query tests every ref.

The kernel keeps each query's best 64 in a warp's registers; a larger k takes
ceil(k / 64) launches, each pass filling the next 64 columns with the refs
that follow the previous pass's last one in (distance, ref index) order.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build

INF = float("inf")


def radius_sq(radius: float) -> float:
    """``float32(radius) ** 2`` rounded to f32, as XLA squares the radius."""
    r = np.float32(radius)
    return float(np.float32(r * r))


def squared_distances(query_xy, ref_xy):
    """The [n, m] squared distances by the f32 expansion, clamped at 0: the
    values that ``radius_knn_plain`` and the kernel test against the radius."""
    rx, ry = ref_xy[:, 0][None, :], ref_xy[:, 1][None, :]
    qx, qy = query_xy[:, 0:1], query_xy[:, 1:2]
    d2 = ((qx * qx + qy * qy) + (rx * rx + ry * ry)) - 2.0 * (qx * rx + qy * ry)
    return d2.clamp_min(0.0)


def radius_knn_plain(query_xy, ref_xy, radius: float, k: int, tile: int = 1024):
    """Plain PyTorch version of K3 (same_tpu/ops/pairwise.py:19-67)."""
    n, m = query_xy.shape[0], ref_xy.shape[0]
    dev = query_xy.device
    r2 = radius_sq(radius)
    idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    dist = torch.full((n, k), INF, dtype=torch.float32, device=dev)
    mask = torch.zeros((n, k), dtype=torch.bool, device=dev)
    for s in range(0, n, tile):
        d2 = squared_distances(query_xy[s:s + tile], ref_xy)
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


# ----------------------------------------------------------------------------
# The grid of cells
# ----------------------------------------------------------------------------

def expansion_error(s_max: float) -> float:
    """A bound on |expansion - exact squared distance| over pairs whose
    |q|^2 + |r|^2 is at most ``s_max`` (float64).

    With u = 2^-24, each of the expansion's eleven f32 roundings is relative:
    the sums of squares are off by (2u + u^2) of theirs, their sum by
    (3u + 3u^2 + u^3) S, the doubled inner product by (2u + u^2) S, and the
    final subtraction by u of a value at most 2 S (1 + 5u): 7u S + O(u^2 S)
    in all. The bound takes 16u S, and 2^-120 for the roundings of
    subnormal products, which are absolute."""
    return 2.0 ** -20 * s_max + 2.0 ** -120


def _f32_up(x: float) -> np.float32:
    """The least float32 not below ``x``."""
    y = np.float32(x)
    return np.nextafter(y, np.float32(np.inf)) if float(y) < x else y


class KnnGrid(NamedTuple):
    """Refs binned into a uniform grid of square cells, and the parameters
    that place a query's square of half-side ``reach`` on it.

    A point's cell is ``floor((x - x0) * inv)`` by ``floor((y - y0) * inv)``,
    each step an f32 operation, clamped into the grid; its id is
    ``cy * gx + cx``. Once binned, ``ref_xy`` holds the refs in ascending
    cell id (in a cell in the order of the counting sort's atomics),
    ``ref_idx`` their original indices, ``cell_start`` [gx * gy + 1] where
    each cell's refs begin, ``query_order`` the queries in ascending cell id.
    Unbinned (``unbinned_grid``), or with ``cells`` False (one cell),
    ``ref_xy`` is the input and the other tensors are None."""
    cells: bool
    x0: float
    y0: float
    inv: float
    reach: float
    gx: int
    gy: int
    ref_xy: torch.Tensor
    ref_idx: Optional[torch.Tensor]
    cell_start: Optional[torch.Tensor]
    query_order: Optional[torch.Tensor]


def grid_params(query_bounds, ref_bounds, radius: float, m: int):
    """``(x0, y0, inv, reach, gx, gy)`` of the grid for points within the
    bounds ``(min x, max x, min y, max y)`` of each set, or None for one cell.

    ``reach`` is h with h^2 >= radius^2 + E (``expansion_error`` at the
    inputs' largest |q|^2 + |r|^2), widened by the rounding of the f32 sums
    ``qx -+ reach``: any ref that the expansion admits lies within h of the
    query on each axis, and so inside the cells of the rounded square. The
    cell side is h, or larger where that would give more than 2 m + 1,024
    cells; the side changes only the work, never the answer."""
    qb = [float(v) for v in query_bounds]
    rb = [float(v) for v in ref_bounds]
    if not all(math.isfinite(v) for v in qb + rb) or m < 2:
        return None
    q_abs = max(abs(v) for v in qb)
    s_max = (max(qb[0] ** 2, qb[1] ** 2) + max(qb[2] ** 2, qb[3] ** 2)
             + max(rb[0] ** 2, rb[1] ** 2) + max(rb[2] ** 2, rb[3] ** 2))
    h = math.sqrt(radius_sq(radius) + expansion_error(s_max)) * (1.0 + 2.0 ** -40)
    if not math.isfinite(h):
        return None
    reach = _f32_up((h + 2.0 ** -22 * (q_abs + h)) * (1.0 + 2.0 ** -20))
    if not np.isfinite(reach):
        return None
    x0, y0 = np.float32(rb[0]), np.float32(rb[2])
    side = max(h, max(rb[1] - rb[0], rb[3] - rb[2]) / math.sqrt(2 * m + 1024))
    inv = np.float32(1.0 / side)
    if not (np.isfinite(inv) and inv > 0):
        return None
    # The refs' largest cells, by the same f32 steps as every other point's.
    gx = int(np.floor((np.float32(rb[1]) - x0) * inv)) + 1
    gy = int(np.floor((np.float32(rb[3]) - y0) * inv)) + 1
    if gx * gy <= 1:
        return None
    return float(x0), float(y0), float(inv), float(reach), gx, gy


def unbinned_grid(params, ref_xy) -> KnnGrid:
    """The grid of ``grid_params``' ``params`` (None: one cell) before the
    refs are binned: what ``point_cells`` and ``visited_cells`` read."""
    if params is None:
        return KnnGrid(False, 0.0, 0.0, 0.0, INF, 1, 1, ref_xy, None, None, None)
    return KnnGrid(True, *params, ref_xy, None, None, None)


def _scalar(v: float, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def point_cells(xy, grid: KnnGrid):
    """(cx, cy) of each point of ``xy`` [p, 2], clamped into the grid (int64)."""
    x0, y0, inv = (_scalar(v, xy) for v in (grid.x0, grid.y0, grid.inv))
    cx = torch.floor((xy[:, 0] - x0) * inv).clamp(0, grid.gx - 1).long()
    cy = torch.floor((xy[:, 1] - y0) * inv).clamp(0, grid.gy - 1).long()
    return cx, cy


def visited_cells(query_xy, grid: KnnGrid):
    """The cells each query visits, by the kernel's f32 steps: ``(xlo, xhi,
    ylo, yhi, any)``, the inclusive ranges of cell columns and rows that its
    square of half-side ``grid.reach`` overlaps, and whether it overlaps the
    grid at all (a NaN coordinate overlaps nothing)."""
    x0, y0, inv, h = (_scalar(v, query_xy) for v in (grid.x0, grid.y0, grid.inv, grid.reach))
    qx, qy = query_xy[:, 0], query_xy[:, 1]
    fxl = torch.floor(((qx - h) - x0) * inv)
    fxh = torch.floor(((qx + h) - x0) * inv)
    fyl = torch.floor(((qy - h) - y0) * inv)
    fyh = torch.floor(((qy + h) - y0) * inv)
    any_ = (fxh >= 0) & (fxl <= grid.gx - 1) & (fyh >= 0) & (fyl <= grid.gy - 1)
    xlo = torch.where(any_, fxl.clamp(0, grid.gx - 1), 0).long()
    xhi = torch.where(any_, fxh.clamp(0, grid.gx - 1), -1).long()
    ylo = torch.where(any_, fyl.clamp(0, grid.gy - 1), 0).long()
    yhi = torch.where(any_, fyh.clamp(0, grid.gy - 1), -1).long()
    return xlo, xhi, ylo, yhi, any_


def _decode_keys(keys) -> np.ndarray:
    """Floats from the bounds kernel's order keys (csrc ``order_key``)."""
    k = np.asarray(keys, dtype=np.uint32)
    bits = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    return bits.view(np.float32)


def _bounds(query_xy, ref_xy):
    """(min x, max x, min y, max y) of the queries and of the refs on the
    card, as 8 host floats, or None where a set is empty or a coordinate is
    not finite. One read from the card (a synchronisation)."""
    if not query_xy.shape[0] or not ref_xy.shape[0]:
        return None
    lib = _lib()
    keys = torch.empty(9, dtype=torch.int32, device=query_xy.device)
    out = (ctypes.c_uint * 9)()
    rc = lib.same_knn_bounds(query_xy.data_ptr(), query_xy.shape[0], ref_xy.data_ptr(),
                             ref_xy.shape[0], keys.data_ptr(), out,
                             torch.cuda.current_stream(query_xy.device).cuda_stream)
    _build.check(lib, rc, "radius_knn bounds")
    if out[8]:
        return None
    lo, hi = _decode_keys(out[0:4]), _decode_keys(out[4:8])
    return np.array([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], lo[3], hi[3]])


def knn_grid(query_xy, ref_xy, radius: float) -> KnnGrid:
    """Bin the CUDA tensor ``ref_xy`` for ``radius``.

    Reads the two sets' bounds to the host (one synchronisation), chooses
    the grid there (``grid_params``), then orders the refs and the queries
    by cell id by the counting sort of ``csrc/radius_knn.cu`` (within a cell
    in the order of its atomics, which the kernel's lists do not depend on)."""
    bounds = _bounds(query_xy, ref_xy)
    params = None if bounds is None else grid_params(bounds[:4], bounds[4:], radius,
                                                     ref_xy.shape[0])
    grid = unbinned_grid(params, ref_xy)
    return _card_bins(query_xy, ref_xy, grid) if grid.cells else grid


def _card_bins(query_xy, ref_xy, grid: KnnGrid) -> KnnGrid:
    """``knn_grid``'s binning on the card: one call of ``same_knn_bin``."""
    lib = _lib()
    dev = ref_xy.device
    n, m, cells = query_xy.shape[0], ref_xy.shape[0], grid.gx * grid.gy
    ints = torch.empty(m + (cells + 1) + n + 3 * cells + 1 + 2 * (m + n), dtype=torch.int32,
                       device=dev)
    ref_idx, cell_start, q_order, scratch = torch.split(ints, [m, cells + 1, n, ints.numel()
                                                               - m - cells - 1 - n])
    b_xy = torch.empty((m, 2), dtype=torch.float32, device=dev)
    rc = lib.same_knn_bin(query_xy.data_ptr(), n, ref_xy.data_ptr(), m, grid.x0, grid.y0,
                          grid.inv, grid.gx, grid.gy, scratch.data_ptr(), b_xy.data_ptr(),
                          ref_idx.data_ptr(), cell_start.data_ptr(), q_order.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "radius_knn binning")
    return grid._replace(ref_xy=b_xy, ref_idx=ref_idx, cell_start=cell_start,
                         query_order=q_order)


# ----------------------------------------------------------------------------
# The kernel
# ----------------------------------------------------------------------------

def _lib():
    lib = _build.load("radius_knn")
    if lib.same_radius_knn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.same_radius_knn.restype = i
        lib.same_radius_knn.argtypes = [
            p, i, p, i, p, p, p, p,  # queries, refs, binned refs, cells, order
            f, f, f, f, i, i,  # x0, y0, inv, reach, gx, gy
            f, i, p, p, p, p, ctypes.POINTER(i),
        ]
        lib.same_knn_bounds.restype = i
        lib.same_knn_bounds.argtypes = [p, i, p, i, p, ctypes.POINTER(ctypes.c_uint), p]
        lib.same_knn_bin.restype = i
        lib.same_knn_bin.argtypes = [p, i, p, i, f, f, f, i, i, p, p, p, p, p, p]
    return lib


def _ptr(t):
    return 0 if t is None else t.data_ptr()


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
    if ref_xy.data_ptr() % 8:  # the kernels read a ref as one float2
        ref_xy = ref_xy.clone()
    lib = _lib()
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    dist = torch.empty((n, k), dtype=torch.float32, device=dev)
    mask = torch.empty((n, k), dtype=torch.bool, device=dev)
    if n == 0:
        return idx, dist, mask
    g = knn_grid(query_xy, ref_xy, radius)
    launches = ctypes.c_int(0)
    rc = lib.same_radius_knn(
        query_xy.data_ptr(), n, ref_xy.data_ptr(), m, g.ref_xy.data_ptr(),
        _ptr(g.ref_idx), _ptr(g.cell_start), _ptr(g.query_order),
        g.x0, g.y0, g.inv, g.reach, g.gx, g.gy, radius_sq(radius), k,
        idx.data_ptr(), dist.data_ptr(), mask.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launches),
    )
    _build.check(lib, rc, "radius_knn")
    _build.count_launch(radius_knn, n=launches.value)
    return idx, dist, mask


radius_knn.launches = 0
