"""Host-side computational geometry for SAME-TPU.

Delaunay triangulation is combinatorial and stays on host (Qhull via scipy by
default, or the first-party C++ Bowyer-Watson backend in ``native/``); all
per-triangle *tests* (edge length, min angle, same-type, orientation) are
vectorized array ops so the same code path feeds both host preprocessing and
the TPU solver.

Reference behaviors reproduced here:
- ``filter_triangles_by_radius`` (reference src/helpers.py:233-395) including
  the ensure-min-triangle-per-node same-type add-back rule and the
  unconstrained-node report.
- the metacell-collapse triangle filter (reference src/metacell_utils.py:242-294)
  which uses a strict ``> r_max`` edge test.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Triangulation backends
# ---------------------------------------------------------------------------

def delaunay_simplices(points: np.ndarray) -> np.ndarray:
    """Delaunay triangulation -> [T, 3] int array of vertex indices.

    Backend selected by env var ``SAME_TPU_DELAUNAY``:
    ``qhull`` (default, scipy) or ``native`` (first-party C++ Bowyer-Watson,
    see native/delaunay.cpp; falls back to qhull if the library is absent).
    """
    points = np.asarray(points, dtype=np.float64)
    if points.shape[0] < 3:
        return np.empty((0, 3), dtype=np.int64)
    backend = os.environ.get("SAME_TPU_DELAUNAY", "qhull")
    if backend == "native":
        try:
            from .utils.native import native_delaunay

            tris = native_delaunay(points)
            if tris is not None:
                return tris
        except Exception:
            pass
    from scipy.spatial import Delaunay, QhullError  # type: ignore

    try:
        return Delaunay(points).simplices.astype(np.int64)
    except QhullError:
        return np.empty((0, 3), dtype=np.int64)


# ---------------------------------------------------------------------------
# Vectorized triangle tests
# ---------------------------------------------------------------------------

def triangle_edge_lengths(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Edge lengths per triangle -> [T, 3] array (|ab|, |bc|, |ca|)."""
    p = points[tris]  # [T, 3, 2]
    e0 = np.linalg.norm(p[:, 1] - p[:, 0], axis=1)
    e1 = np.linalg.norm(p[:, 2] - p[:, 1], axis=1)
    e2 = np.linalg.norm(p[:, 0] - p[:, 2], axis=1)
    return np.stack([e0, e1, e2], axis=1)


def triangle_min_angles_deg(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Minimum interior angle per triangle, in degrees -> [T]."""
    p = points[tris]
    angles = np.empty((tris.shape[0], 3), dtype=np.float64)
    for k in range(3):
        a = p[:, k]
        b = p[:, (k + 1) % 3]
        c = p[:, (k + 2) % 3]
        v1 = b - a
        v2 = c - a
        n1 = np.linalg.norm(v1, axis=1)
        n2 = np.linalg.norm(v2, axis=1)
        denom = n1 * n2
        cosang = np.where(
            denom > 0, (v1 * v2).sum(axis=1) / np.where(denom > 0, denom, 1.0), 1.0
        )
        angles[:, k] = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
        # Degenerate (zero-length edge) triangles get angle 0 so they filter out.
        angles[:, k] = np.where(denom > 0, angles[:, k], 0.0)
    return angles.min(axis=1)


def triangle_cross_np(points: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Cross product (b-a) x (c-a) per triangle -> [T]."""
    p = points[tris]
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    return (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        c[:, 0] - a[:, 0]
    )


def orientation_signs_np(
    points: np.ndarray, tris: np.ndarray, round_decimals: int | None = None
) -> np.ndarray:
    """Orientation sign per triangle (+1 CCW / -1 CW / 0 degenerate)."""
    cross = triangle_cross_np(points, tris)
    if round_decimals is not None:
        cross = np.round(cross, round_decimals)
    return np.sign(cross).astype(np.int32)


# ---------------------------------------------------------------------------
# Triangle filtering (solver preprocessing)
# ---------------------------------------------------------------------------

def filter_triangles_by_radius(
    points: np.ndarray,
    triangles: np.ndarray | Sequence[Iterable[int]],
    radius: float,
    aligned_df=None,
    cell_types: np.ndarray | None = None,
    ignore_same_type_triangles: bool = False,
    ensure_min_triangle_per_node: bool = True,
    remove_unconstrained_nodes: bool = False,
    min_angle_deg: float | None = 15,
    verbose: bool = False,
):
    """Filter triangles by max edge length, min angle, and cell-type rules.

    Semantics match the reference (src/helpers.py:233-395):

    - a triangle is dropped if its longest side is ``>= radius``;
    - then dropped if its smallest interior angle is ``< min_angle_deg``;
    - if ``ignore_same_type_triangles``, triangles whose three vertices share a
      cell type are dropped, BUT each node that would end up with zero incident
      triangles gets back its minimum-perimeter same-type triangle
      (``ensure_min_triangle_per_node``);
    - nodes with no triangle passing radius+angle at all are reported as
      *unconstrained* when ``remove_unconstrained_nodes`` is set.

    ``cell_types`` may be passed directly as an array; otherwise it is pulled
    from ``aligned_df['cell_type']`` for API parity with the reference.

    Returns the filtered [T', 3] int array (input order preserved, add-backs
    appended), plus the unconstrained-node set when requested.
    """
    tris = np.asarray(triangles, dtype=np.int64)
    if tris.size == 0:
        tris = tris.reshape(0, 3)
    points = np.asarray(points, dtype=np.float64)
    n_points = len(points)

    if tris.shape[0] == 0:
        empty = tris
        unconstrained = set(range(n_points))
        if remove_unconstrained_nodes:
            return empty, unconstrained
        return empty

    edges = triangle_edge_lengths(points, tris)
    ok_radius = edges.max(axis=1) < radius
    if min_angle_deg is not None:
        ok_angle = triangle_min_angles_deg(points, tris) >= min_angle_deg
    else:
        ok_angle = np.ones(tris.shape[0], dtype=bool)
    geom_ok = ok_radius & ok_angle

    if cell_types is None and aligned_df is not None:
        cell_types = np.asarray(aligned_df["cell_type"])

    if ignore_same_type_triangles and cell_types is not None:
        tri_types = np.asarray(cell_types)[tris]
        same_type = (tri_types[:, 0] == tri_types[:, 1]) & (
            tri_types[:, 1] == tri_types[:, 2]
        )
    else:
        same_type = np.zeros(tris.shape[0], dtype=bool)

    keep = geom_ok & ~same_type
    kept = tris[keep]

    # Nodes with at least one radius+angle-valid triangle (any type mix).
    nodes_any_valid = np.zeros(n_points, dtype=bool)
    nodes_any_valid[tris[geom_ok].ravel()] = True
    truly_unconstrained = set(np.flatnonzero(~nodes_any_valid).tolist())

    kept_list = [kept]
    if ignore_same_type_triangles and ensure_min_triangle_per_node and cell_types is not None:
        nodes_with_kept = np.zeros(n_points, dtype=bool)
        nodes_with_kept[kept.ravel()] = True
        missing = np.flatnonzero(~nodes_with_kept & nodes_any_valid)
        if missing.size:
            # Best (min perimeter) same-type geometric-valid triangle per node.
            cand_idx = np.flatnonzero(geom_ok & same_type)
            if cand_idx.size:
                perim = edges[cand_idx].sum(axis=1)
                best_score = np.full(n_points, np.inf)
                best_tri = np.full(n_points, -1, dtype=np.int64)
                # Iterate in candidate order so ties resolve like the
                # reference's strict-< update (first candidate wins ties).
                for t, s in zip(cand_idx, perim):
                    for v in tris[t]:
                        if s < best_score[v]:
                            best_score[v] = s
                            best_tri[v] = t
                added_keys = set(map(tuple, kept.tolist()))
                addbacks = []
                for node in missing:
                    t = best_tri[node]
                    if t < 0:
                        continue
                    key = tuple(tris[t].tolist())
                    if key not in added_keys:
                        added_keys.add(key)
                        addbacks.append(tris[t])
                if addbacks:
                    kept_list.append(np.asarray(addbacks, dtype=np.int64))

    filtered = np.concatenate(kept_list, axis=0) if len(kept_list) > 1 else kept

    if verbose:
        print(
            f"Triangle filtering: total={tris.shape[0]} "
            f"skipped_radius={int((~ok_radius).sum())} "
            f"skipped_angle={int((ok_radius & ~ok_angle).sum())} "
            f"skipped_same_type={int((geom_ok & same_type).sum())} "
            f"kept={filtered.shape[0]}"
        )

    if remove_unconstrained_nodes:
        return filtered, truly_unconstrained
    return filtered


def filter_triangles_collapse(
    coords: np.ndarray,
    triangles: np.ndarray,
    r_max: float | None,
    min_angle_deg: float | None,
) -> np.ndarray:
    """Geometry-only triangle filter used by metacell collapse.

    Matches reference src/metacell_utils.py:242-294: strict ``> r_max`` edge
    rejection (note: ``>=`` in the solver-side filter above) and
    ``< min_angle_deg`` angle rejection. Alpha-shape filtering is handled by
    the caller (optional dependency).
    """
    tris = np.asarray(triangles, dtype=np.int64)
    if tris.size == 0:
        return tris.reshape(0, 3)
    keep = np.ones(tris.shape[0], dtype=bool)
    if r_max is not None:
        keep &= triangle_edge_lengths(coords, tris).max(axis=1) <= r_max
    if min_angle_deg is not None:
        keep &= triangle_min_angles_deg(coords, tris) >= min_angle_deg
    return tris[keep]


def calculate_signed_area(p1, p2, p3) -> float:
    """Signed area of one triangle (reference src/helpers.py:73-77)."""
    x1, y1 = p1
    x2, y2 = p2
    x3, y3 = p3
    return 0.5 * (x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2))


def order_triangle_ccw(points):
    """Order a 3-row DataFrame's vertices counterclockwise by angle from the
    centroid (reference src/helpers.py:414-421)."""
    cx = points["X"].mean()
    cy = points["Y"].mean()
    angles = np.arctan2(points["Y"] - cy, points["X"] - cx)
    return points.iloc[np.argsort(angles)]


def order_vertices_for_positive_area(points: dict):
    """Return the vertex-name ordering giving positive signed area
    (reference src/helpers.py:80-99). ``points`` maps name -> (x, y)."""
    from itertools import permutations

    for perm in permutations(points.items()):
        names = [name for name, _ in perm]
        (x1, y1), (x2, y2), (x3, y3) = (p for _, p in perm)
        area = x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2)
        if area > 0:
            return names
    return []


def signed_area_terms(points, x_col: str = "X", y_col: str = "Y") -> int:
    """Orientation of a 3-row DataFrame: 1 CCW, -1 CW, 0 degenerate.

    Parity with reference src/helpers.py:398-411 (rounds to 3 decimals).
    """
    x1, y1 = points.iloc[0][x_col], points.iloc[0][y_col]
    x2, y2 = points.iloc[1][x_col], points.iloc[1][y_col]
    x3, y3 = points.iloc[2][x_col], points.iloc[2][y_col]
    area = np.round((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1), 3)
    if area > 0:
        return 1
    if area < 0:
        return -1
    return 0
