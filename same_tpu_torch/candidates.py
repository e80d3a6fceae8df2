"""Candidate-pair generation (radius-bounded kNN).

Array core + DataFrame wrappers preserving the reference API:
``find_knn_within_radius`` (reference src/utils.py:709-742) including its
reindex-to-participating-rows behavior, and
``find_knn_with_cell_type_priority`` (reference src/knn_utils.py:5-78).

Counterpart of ``same_tpu/candidates.py``. The host cKDTree sweep is the
default; the device brute-force backend (``ops/pairwise.py``, kernel K3) is
chosen by ``SAME_TPU_KNN=tpu`` or above 4e9 n*m. The branch value and the
variable keep the JAX package's names. ``device`` is where that backend
runs: ``None`` is the first CUDA card (and raises without one), ``"cpu"``
runs the kernel's plain version.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def radius_knn(
    query_xy: np.ndarray,
    ref_xy: np.ndarray,
    radius: float,
    k: int,
    backend: str | None = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-query k nearest refs within ``radius``.

    Returns (idx[n,k], dist[n,k], mask[n,k]) padded with -1 / inf / False.
    Neighbors sorted by (distance, ref index).
    """
    query_xy = np.asarray(query_xy, dtype=np.float64)
    ref_xy = np.asarray(ref_xy, dtype=np.float64)
    n = len(query_xy)
    if backend is None:
        backend = os.environ.get("SAME_TPU_KNN", "")
    if not backend:
        # Host cKDTree queries are C-vectorized and handle 100k-point
        # windows in well under a second; the device brute-force tiles only
        # win when the deployment has real host<->device bandwidth (force
        # with SAME_TPU_KNN=tpu), so the automatic cutover is set far above
        # any window the sliding grid produces.
        backend = "tpu" if n * len(ref_xy) > 4_000_000_000 else "host"

    if backend == "tpu":
        from .ops.pairwise import radius_knn_device

        idx, dist, mask = radius_knn_device(
            np.asarray(query_xy, np.float32), np.asarray(ref_xy, np.float32),
            float(radius), int(k), device=device,
        )
        return (
            idx.cpu().numpy(),
            dist.cpu().numpy().astype(np.float64),
            mask.cpu().numpy(),
        )

    from scipy.spatial import cKDTree

    tree = cKDTree(ref_xy)
    # query returns sorted-by-distance neighbors; distances beyond the radius
    # come back as inf with index == m.
    dist, idx = tree.query(query_xy, k=k, distance_upper_bound=radius)
    if k == 1:
        dist = dist[:, None]
        idx = idx[:, None]
    mask = np.isfinite(dist)
    idx = np.where(mask, idx, -1).astype(np.int64)
    dist = np.where(mask, dist, np.inf)
    return idx, dist, mask


def _pairs_from_padded(idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Flatten padded [n, k] candidates into an ordered [(i, j)] pair list.

    Order matches the reference: grouped by query index, then by distance
    (the padded arrays are already distance-sorted per row).
    """
    n, k = idx.shape
    qi = np.repeat(np.arange(n), k)
    flat_idx = idx.reshape(-1)
    flat_mask = mask.reshape(-1)
    return np.column_stack([qi[flat_mask], flat_idx[flat_mask]])


def find_knn_within_radius(
    aligned_df, ref_df, radius=25, knn=5, backend=None, device=None
):
    """Find kNN candidate pairs and reindex both frames to participating rows.

    Parity with reference src/utils.py:709-742: rows of ``aligned_df`` /
    ``ref_df`` that appear in no pair are dropped, both frames are
    ``reset_index(drop=True)``, and pair indices are remapped accordingly.
    """
    aligned_xy = aligned_df[["X", "Y"]].to_numpy()
    ref_xy = ref_df[["X", "Y"]].to_numpy()
    idx, _dist, mask = radius_knn(
        aligned_xy, ref_xy, radius, knn, backend=backend, device=device
    )
    pairs = _pairs_from_padded(idx, mask)
    if len(pairs) == 0:
        return (
            aligned_df.iloc[:0].reset_index(drop=True),
            ref_df.iloc[:0].reset_index(drop=True),
            np.empty((0, 2), dtype=np.int64),
        )
    uniq_a = np.unique(pairs[:, 0])
    uniq_r = np.unique(pairs[:, 1])
    new_aligned = aligned_df.iloc[uniq_a].reset_index(drop=True)
    new_ref = ref_df.iloc[uniq_r].reset_index(drop=True)
    map_a = np.full(len(aligned_df), -1, dtype=np.int64)
    map_a[uniq_a] = np.arange(len(uniq_a))
    map_r = np.full(len(ref_df), -1, dtype=np.int64)
    map_r[uniq_r] = np.arange(len(uniq_r))
    new_pairs = np.column_stack([map_a[pairs[:, 0]], map_r[pairs[:, 1]]])
    return new_aligned, new_ref, new_pairs


def preprocess_data(aligned_df, ref_df, radius):
    """Radius-only candidate pairs + reindex (reference src/utils.py:744-772).

    Like :func:`find_knn_within_radius` but keeps *all* refs within the
    radius instead of the top-k.
    """
    aligned_xy = aligned_df[["X", "Y"]].to_numpy()
    ref_xy = ref_df[["X", "Y"]].to_numpy()
    from scipy.spatial import cKDTree

    tree = cKDTree(ref_xy)
    neighbor_lists = tree.query_ball_point(aligned_xy, r=radius)
    pairs = np.asarray(
        [(i, j) for i, js in enumerate(neighbor_lists) for j in sorted(js)],
        dtype=np.int64,
    ).reshape(-1, 2)
    if len(pairs) == 0:
        return (
            aligned_df.iloc[:0].reset_index(drop=True),
            ref_df.iloc[:0].reset_index(drop=True),
            pairs,
        )
    uniq_a = np.unique(pairs[:, 0])
    uniq_r = np.unique(pairs[:, 1])
    new_aligned = aligned_df.iloc[uniq_a].reset_index(drop=True)
    new_ref = ref_df.iloc[uniq_r].reset_index(drop=True)
    map_a = np.full(len(aligned_df), -1, dtype=np.int64)
    map_a[uniq_a] = np.arange(len(uniq_a))
    map_r = np.full(len(ref_df), -1, dtype=np.int64)
    map_r[uniq_r] = np.arange(len(uniq_r))
    return new_aligned, new_ref, np.column_stack(
        [map_a[pairs[:, 0]], map_r[pairs[:, 1]]]
    )


def find_knn_with_cell_type_priority(aligned_df, ref_df, radius, knn=5, device=None):
    """kNN with same-cell-type priority (reference src/knn_utils.py:5-78).

    After the standard radius-kNN pass, each aligned point whose *closest*
    candidate shares its cell type — and whose candidate has not already been
    claimed by an earlier aligned point — keeps only that single pair;
    otherwise all its kNN pairs are kept.
    """
    aligned_df, ref_df, all_pairs = find_knn_within_radius(
        aligned_df, ref_df, radius, knn=knn, device=device
    )
    if len(all_pairs) == 0:
        return aligned_df, ref_df, all_pairs

    aligned_types = np.asarray(aligned_df["cell_type"])
    ref_types = np.asarray(ref_df["cell_type"])
    aligned_xy = aligned_df[["X", "Y"]].to_numpy()
    ref_xy = ref_df[["X", "Y"]].to_numpy()

    # Group pairs by aligned index, preserving per-group insertion order.
    groups: dict[int, List[int]] = {}
    for i, j in all_pairs:
        groups.setdefault(int(i), []).append(int(j))

    filtered: List[Tuple[int, int]] = []
    ref_claimed: set[int] = set()
    for i in range(len(aligned_df)):
        js = groups.get(i)
        if not js:
            continue
        d = np.linalg.norm(ref_xy[js] - aligned_xy[i], axis=1)
        order = np.argsort(d, kind="stable")
        js_sorted = [js[o] for o in order]
        best = js_sorted[0]
        if ref_types[best] == aligned_types[i] and best not in ref_claimed:
            filtered.append((i, best))
            ref_claimed.add(best)
        else:
            filtered.extend((i, j) for j in js_sorted)
    return aligned_df, ref_df, np.asarray(filtered, dtype=np.int64)
