"""Whole-array passes over a window's pairs and triangles on the host.

``core.prepare_window`` and ``core.finalize_window`` call these in place of
per-pair and per-triangle Python loops. Each pass returns exactly what the
loop it replaces returns, in the same order and with the same types:

- :func:`greedy_pairs`: ``warmstart.compute_warm_start_pairs`` with
  ``init_method="greedy"``;
- :func:`simplex_map` and :func:`triangle_info`: the vertex-to-triangle map
  and ``eval.precompute_triangle_info``;
- :func:`warm_start_prices`: ``warmstart.warm_start_prices``;
- :func:`spatial_violations`: ``eval.verify_spatial_preservation``;
- :func:`triangle_areas`: ``geometry.calculate_signed_area`` over the
  triangles, before and after the matching.

The loops stay in the modules the port copies from the JAX package, as the
API and as the oracles of ``tests/test_torch_host_arrays.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

# A triangle's vertex pairs in the order the loops compare them.
_FIRST = np.array([0, 0, 1])
_SECOND = np.array([1, 2, 2])


def greedy_pairs(
    valid_pairs: np.ndarray,
    costs: np.ndarray,
    n_aligned: int,
    n_ref: int,
    unmatched_cost: np.ndarray,
) -> Tuple[np.ndarray, int]:
    """The greedy matching: ``([k, 3] (i, j, pair index) in the order the
    greedy scan takes them, rounds)``.

    The scan walks the pairs by stable cost order and takes a pair when
    neither end is taken yet, skipping rows whose best pair costs no less
    than their no-match cost. Under that strict order, a pair that comes
    first at both of its ends is taken by the scan, and the pairs touching
    it never are; so rounds that take every such pair and drop their
    neighbours take the same set. Each round takes at least the first pair
    left. One pair per row and per ref, as the scan gives.
    """
    valid_pairs = np.asarray(valid_pairs, dtype=np.int64).reshape(-1, 2)
    costs = np.asarray(costs, dtype=float)
    rows, refs = valid_pairs[:, 0], valid_pairs[:, 1]
    # fmin skips NaN costs as the scan's min() does.
    best = np.full(n_aligned, np.inf)
    np.fmin.at(best, rows, costs)
    order = np.argsort(costs, kind="stable")
    order = order[(best < unmatched_cost)[rows[order]]]
    r_rows, r_refs = rows[order], refs[order]
    m = len(order)
    taken = np.zeros(m, dtype=bool)
    used_a = np.zeros(n_aligned, dtype=bool)
    used_r = np.zeros(n_ref, dtype=bool)
    live = np.arange(m)
    rounds = 0
    while len(live):
        rounds += 1
        a, r = r_rows[live], r_refs[live]
        first_a = np.full(n_aligned, m)
        first_r = np.full(n_ref, m)
        np.minimum.at(first_a, a, live)
        np.minimum.at(first_r, r, live)
        win = (first_a[a] == live) & (first_r[r] == live)
        taken[live[win]] = True
        used_a[a[win]] = True
        used_r[r[win]] = True
        live = live[~(used_a[a] | used_r[r])]
    sel = np.flatnonzero(taken)
    return np.stack([r_rows[sel], r_refs[sel], order[sel]], axis=1), rounds


def simplex_map(tris: np.ndarray, n_aligned: int) -> Dict[int, set]:
    """Vertex -> set of the triangles it belongs to, every vertex a key;
    each set filled in triangle order, as the loop fills it."""
    flat = np.asarray(tris, dtype=np.int64).reshape(-1)
    by_vertex = (np.argsort(flat, kind="stable") // 3).tolist()
    ends = np.cumsum(np.bincount(flat, minlength=n_aligned)).tolist()
    starts = [0] + ends[:-1]
    return {v: set(by_vertex[s:e]) for v, (s, e) in enumerate(zip(starts, ends))}


def triangle_info(aligned_df, tris: np.ndarray) -> Dict[int, Dict[str, Any]]:
    """``eval.precompute_triangle_info(aligned_df, tris)`` from ``[T]``
    arrays: each triangle's bounds and the first of its vertices (in
    triangle order) at each extreme."""
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    tx = aligned_df["X"].to_numpy()[tris]
    ty = aligned_df["Y"].to_numpy()[tris]
    t = np.arange(len(tris))

    def vertex(col):
        return tris[t, col].tolist()

    return {
        k: {
            "vertices": tri,
            "bounds": {"min_x": x0, "max_x": x1, "min_y": y0, "max_y": y1},
            "max_x_vertex": vx1,
            "min_x_vertex": vx0,
            "max_y_vertex": vy1,
            "min_y_vertex": vy0,
        }
        for k, (tri, x0, x1, y0, y1, vx1, vx0, vy1, vy0) in enumerate(zip(
            tris, tx.min(axis=1), tx.max(axis=1), ty.min(axis=1), ty.max(axis=1),
            vertex(tx.argmax(axis=1)), vertex(tx.argmin(axis=1)),
            vertex(ty.argmax(axis=1)), vertex(ty.argmin(axis=1)),
        ))
    }


def warm_start_prices(problem, chosen) -> np.ndarray:
    """Initial slot prices from a warm-start matching ``chosen`` (rows of
    (i, j, pair index)): each chosen pair's slot is priced at the row's
    no-match cost less the pair's cost, in the first column holding that
    pair, where that slack is positive."""
    prices = np.zeros(problem.n_slots + 1, dtype=problem.costs.dtype)
    chosen = np.asarray(chosen, dtype=np.int64).reshape(-1, 3)
    hit = problem.pair_idx[chosen[:, 0]] == chosen[:, 2:3]
    found = hit.any(axis=1)
    rows, cols = chosen[found, 0], hit[found].argmax(axis=1)
    # The difference in the problem's dtype, then float64, as the loop's
    # float(nm_cost[i] - costs[i, c]).
    slack = (problem.nm_cost[rows] - problem.costs[rows, cols]).astype(np.float64)
    pos = slack > 0
    np.maximum.at(prices, problem.slots[rows[pos], cols[pos]], slack[pos])
    return prices


def ref_of_aligned(matches_df, n_aligned: int) -> np.ndarray:
    """``[n_aligned]`` matched ref row of each aligned row, -1 where
    unmatched (each aligned row at most once in ``matches_df``)."""
    ref_of = np.full(n_aligned, -1, dtype=np.int64)
    ref_of[matches_df["aligned_idx"].to_numpy(dtype=np.int64)] = (
        matches_df["ref_idx"].to_numpy(dtype=np.int64)
    )
    return ref_of


def _order_records(idx, v1, v2, r1, r2, a, r, axis):
    """The loop's violation records of one axis, for flat (triangle, pair)
    positions ``idx``."""
    v1, v2 = v1[idx], v2[idx]
    orig, matched = f"orig_{axis}", f"matched_{axis}"
    return [
        {
            "triangle_idx": t,
            "point1": {"aligned_idx": p1, "ref_idx": q1, orig: o1, matched: m1},
            "point2": {"aligned_idx": p2, "ref_idx": q2, orig: o2, matched: m2},
        }
        for t, p1, q1, o1, m1, p2, q2, o2, m2 in zip(
            (idx // 3).tolist(), v1, r1[idx].tolist(), a[v1], r[r1[idx]],
            v2, r2[idx].tolist(), a[v2], r[r2[idx]],
        )
    ]


def spatial_violations(aligned_df, ref_df, tris, ref_of) -> Dict[str, Any]:
    """``eval.verify_spatial_preservation`` over the ``[T, 3]`` triangles,
    with ``ref_of`` from :func:`ref_of_aligned`.

    For each triangle, its matched vertices in triangle order and their
    pairs (0, 1), (0, 2), (1, 2) are compared in X, then in Y, with strict
    ``<``. Records and the two sets are made in the loop's order (triangle,
    then pair, then X before Y), so ``list(set)`` comes out the same.
    """
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    T = len(tris)
    ax, ay = aligned_df["X"].to_numpy(), aligned_df["Y"].to_numpy()
    rx, ry = ref_df["X"].to_numpy(), ref_df["Y"].to_numpy()
    ref = ref_of[tris]
    v1, v2 = tris[:, _FIRST].reshape(-1), tris[:, _SECOND].reshape(-1)
    r1, r2 = ref[:, _FIRST].reshape(-1), ref[:, _SECOND].reshape(-1)
    both = np.flatnonzero((r1 >= 0) & (r2 >= 0))
    p1, p2, q1, q2 = v1[both], v2[both], r1[both], r2[both]
    x_bad = np.zeros(3 * T, dtype=bool)
    y_bad = np.zeros(3 * T, dtype=bool)
    x_bad[both] = (ax[p1] < ax[p2]) != (rx[q1] < rx[q2])
    y_bad[both] = (ay[p1] < ay[p2]) != (ry[q1] < ry[q2])
    x_idx, y_idx = np.flatnonzero(x_bad), np.flatnonzero(y_bad)

    n_bad = x_bad.astype(np.int64) + y_bad
    points = set(np.repeat(np.stack([v1, v2], axis=1), n_bad, axis=0).reshape(-1))
    bad_tris = np.flatnonzero((n_bad.reshape(-1, 3) > 0).any(axis=1)).tolist()

    summary: Dict[str, Any] = {
        "total_triangles": T,
        "violated_triangles": len(bad_tris),
        "total_comparisons": len(both),
        "total_violations": len(x_idx) + len(y_idx),
    }
    summary["percent_triangles_violated"] = (
        summary["violated_triangles"] / summary["total_triangles"] * 100
        if summary["total_triangles"] > 0
        else 0
    )
    summary["percent_violations"] = (
        summary["total_violations"] / summary["total_comparisons"] * 100
        if summary["total_comparisons"] > 0
        else 0
    )
    return {
        "x_order_violations": _order_records(x_idx, v1, v2, r1, r2, ax, rx, "x"),
        "y_order_violations": _order_records(y_idx, v1, v2, r1, r2, ay, ry, "y"),
        "triangles_with_violations": list(set(bad_tris)),
        "points_with_violations": list(points),
        "violation_summary": summary,
    }


def _signed_areas(p1, p2, p3):
    """``geometry.calculate_signed_area``'s expression, elementwise."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    x3, y3 = p3[:, 0], p3[:, 1]
    return 0.5 * (x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2))


def triangle_areas(
    tris, aligned_coords, ref_coords, ref_of
) -> Tuple[Dict[int, Any], Dict[int, Any], List[int], Dict[int, List[bool]]]:
    """``(areas_before, areas_after, flipped_tris, matched_vertices)`` of
    ``finalize_window``'s triangle-area analysis: signed areas in float64,
    ``None`` after where a vertex is unmatched, flipped where the two areas'
    product is negative."""
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    T = len(tris)
    before = _signed_areas(*(aligned_coords[tris[:, k]] for k in range(3)))
    ref = ref_of[tris]
    matched = ref >= 0
    full = np.flatnonzero(matched.all(axis=1))
    after = np.full(T, np.nan)
    after[full] = _signed_areas(*(ref_coords[ref[full, k]] for k in range(3)))
    flipped = full[before[full] * after[full] < 0].tolist()
    is_full = np.zeros(T, dtype=bool)
    is_full[full] = True
    areas_after = {
        t: (a if ok else None) for t, a, ok in zip(range(T), after, is_full.tolist())
    }
    return (
        dict(zip(range(T), before)),
        areas_after,
        flipped,
        dict(zip(range(T), matched.tolist())),
    )


def vertices_of(tris, which) -> set:
    """The set of the vertices of triangles ``which``, filled in triangle
    order."""
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    return set(tris[np.asarray(which, dtype=np.int64)].reshape(-1).tolist())
