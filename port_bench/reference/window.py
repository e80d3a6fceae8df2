"""Plain reference of one SAME window, in NumPy and SciPy.

It works everything out again from the two metacell tables that the
benchmark made: the radius-kNN candidate pairs, the filtered Delaunay
triangles whose orientation counts, the reference capacities, the objective
and the flipped triangles of a matching, and the optimum of the assignment
without the tearing term. It imports nothing of the program.

Semantics (the SAME paper's model, as the configuration states it):

- candidates: for each aligned metacell the ``knn`` nearest reference
  metacells closer than ``radius``; rows with no candidate leave the problem;
- capacity: ``ref_metacell_match_multiplier * max_matches`` for a reference
  metacell of size > 1 (when the reference has any), else ``max_matches``;
- cost of a pair: ``dist_ct_coeff * (L1 of the type probabilities
  + 0.001 * L1 of the coordinates)``; an extra match on a reference pays
  ``penalty_coeff``; an aligned metacell left unmatched pays
  ``no_match_penalty * size``;
- triangles: the Delaunay triangles of the aligned rows with every edge
  shorter than ``radius`` and every angle at least ``min_angle_deg``, less
  those of one cell type, plus, for each vertex left with none, its
  shortest such triangle of one type;
- a triangle is flipped when all three vertices are matched and its signed
  area changes sign; flipped triangles pay ``delaunay_penalty`` times the
  summed sizes of their vertices, less an allowance of
  ``lazy_allowed_flip_fraction`` of the summed weight of the triangles with
  an orientation (the flips the configuration lets go unpaid). This needs
  nothing of the solver's cut set: it is worked out from the inputs and the
  matching alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import min_weight_full_bipartite_matching
from scipy.spatial import Delaunay, QhullError, cKDTree


def candidate_pairs(aligned_xy, ref_xy, radius, k):
    """[P, 2] (aligned row, ref row) pairs: per aligned row its ``k`` nearest
    refs strictly inside ``radius``, by (distance, ref row)."""
    tree = cKDTree(ref_xy)
    near = tree.query_ball_point(aligned_xy, r=radius)
    rows, cols = [], []
    for i, js in enumerate(near):
        if not js:
            continue
        js = np.asarray(js, np.int64)
        d = np.hypot(*(ref_xy[js] - aligned_xy[i]).T)
        inside = d < radius
        js, d = js[inside], d[inside]
        order = np.lexsort((js, d))[:k]
        rows.append(np.full(len(order), i, np.int64))
        cols.append(js[order])
    if not rows:
        return np.zeros((0, 2), np.int64)
    return np.column_stack([np.concatenate(rows), np.concatenate(cols)])


def _edges(xy, tris):
    p = xy[tris]
    return np.stack(
        [np.hypot(*(p[:, (k + 1) % 3] - p[:, k]).T) for k in range(3)], axis=1
    )


def _min_angle_deg(xy, tris):
    p = xy[tris]
    out = np.full(len(tris), np.inf)
    for k in range(3):
        v1 = p[:, (k + 1) % 3] - p[:, k]
        v2 = p[:, (k + 2) % 3] - p[:, k]
        denom = np.hypot(*v1.T) * np.hypot(*v2.T)
        cos = (v1 * v2).sum(axis=1) / np.where(denom > 0, denom, 1.0)
        ang = np.where(denom > 0, np.degrees(np.arccos(np.clip(cos, -1, 1))), 0.0)
        out = np.minimum(out, ang)
    return out


def filtered_triangles(xy, types, radius, min_angle_deg):
    """The triangles whose orientation counts, as a [T, 3] array of rows."""
    if len(xy) < 3:
        return np.zeros((0, 3), np.int64)
    try:
        tris = Delaunay(xy).simplices.astype(np.int64)
    except QhullError:
        return np.zeros((0, 3), np.int64)
    edges = _edges(xy, tris)
    geom = (edges.max(axis=1) < radius) & (_min_angle_deg(xy, tris) >= min_angle_deg)
    t = types[tris]
    one_type = (t[:, 0] == t[:, 1]) & (t[:, 1] == t[:, 2])
    kept = tris[geom & ~one_type]
    has = np.zeros(len(xy), bool)
    has[kept.ravel()] = True
    any_geom = np.zeros(len(xy), bool)
    any_geom[tris[geom].ravel()] = True
    cand = np.flatnonzero(geom & one_type)
    if cand.size:
        # Each vertex's shortest one-type triangle: sort (vertex, perimeter).
        vert = tris[cand].ravel()
        tri_of = np.repeat(cand, 3)
        perim = np.repeat(edges[cand].sum(axis=1), 3)
        order = np.lexsort((tri_of, perim, vert))
        first = np.ones(len(order), bool)
        first[1:] = vert[order][1:] != vert[order][:-1]
        best = np.full(len(xy), -1, np.int64)
        best[vert[order][first]] = tri_of[order][first]
        need = best[np.flatnonzero(any_geom & ~has)]
        need = np.unique(need[need >= 0])
        if need.size:
            kept = np.concatenate([kept, tris[need]])
    return kept


def signed_area2(xy, tris):
    p = xy[tris]
    return (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])


def capacities(ref_size, optim):
    """Matches each reference row may take."""
    mm = int(optim["max_matches"])
    if (ref_size > 1).any():
        mult = int(optim["ref_metacell_match_multiplier"])
        return np.where(ref_size > 1, mult * mm, mm).astype(np.int64)
    return np.full(len(ref_size), mm, np.int64)


def problem_shapes(ref_df, aligned_df, optim):
    """``(n_rows, n_entries, n_slots)`` of a window's assignment: aligned
    rows with a candidate, candidate pairs times the capacity of their
    reference, and the capacity of the reference rows with a candidate."""
    pairs = candidate_pairs(
        aligned_df[["X", "Y"]].to_numpy(np.float64),
        ref_df[["X", "Y"]].to_numpy(np.float64),
        float(optim["radius"]), int(optim["knn"]),
    )
    ur, inv_r = np.unique(pairs[:, 1], return_inverse=True)
    cap = capacities(ref_df["size"].to_numpy(np.float64)[ur], optim)
    return len(np.unique(pairs[:, 0])), int(cap[inv_r].sum()), int(cap.sum())


@dataclass
class Window:
    """One window's problem as the reference sees it (rows are the aligned
    and reference rows with a candidate, in table order)."""

    aligned_ids: np.ndarray   # [n] metacell ids of the rows
    ref_ids: np.ndarray       # [m]
    pairs: np.ndarray         # [P, 2] rows
    pair_cost: np.ndarray     # [P]
    capacity: np.ndarray      # [m]
    no_match: np.ndarray      # [n]
    tris: np.ndarray          # [T, 3] aligned rows
    tri_weight: np.ndarray    # [T]
    source_sign: np.ndarray   # [T]
    ref_xy: np.ndarray        # [m, 2]
    penalty_coeff: float
    delaunay_penalty: float
    flip_allowance: float     # unpaid flip weight x delaunay_penalty


def build_window(ref_df, aligned_df, type_cols, optim, allowed_flip_fraction):
    """The reference's problem for one window from the two tables."""
    a_xy = aligned_df[["X", "Y"]].to_numpy(np.float64)
    r_xy = ref_df[["X", "Y"]].to_numpy(np.float64)
    pairs = candidate_pairs(a_xy, r_xy, float(optim["radius"]), int(optim["knn"]))
    ua, inv_a = np.unique(pairs[:, 0], return_inverse=True)
    ur, inv_r = np.unique(pairs[:, 1], return_inverse=True)
    pairs_rows = np.column_stack([inv_a, inv_r])
    a_probs = aligned_df[type_cols].to_numpy(np.float64)[ua]
    r_probs = ref_df[type_cols].to_numpy(np.float64)[ur]
    a_xy, r_xy = a_xy[ua], r_xy[ur]
    coef = float(optim["dist_ct_coeff"])
    cost = coef * np.abs(a_probs[inv_a] - r_probs[inv_r]).sum(axis=1) + (
        0.001 * coef
    ) * np.abs(a_xy[inv_a] - r_xy[inv_r]).sum(axis=1)
    a_size = aligned_df["size"].to_numpy(np.float64)[ua]
    cap = capacities(ref_df["size"].to_numpy(np.float64)[ur], optim)
    types = aligned_df["cell_type"].to_numpy()[ua]
    tris = filtered_triangles(
        a_xy, types, float(optim["radius"]), float(optim["min_angle_deg"])
    )
    tri_weight = a_size[tris].sum(axis=1) if len(tris) else np.zeros(0)
    source_sign = np.sign(signed_area2(a_xy, tris)).astype(np.int64)
    dp = float(optim["delaunay_penalty"])
    return Window(
        aligned_ids=aligned_df["metacell_id"].to_numpy()[ua],
        ref_ids=ref_df["metacell_id"].to_numpy()[ur],
        pairs=pairs_rows,
        pair_cost=cost,
        capacity=cap,
        no_match=float(optim["no_match_penalty"]) * a_size,
        tris=tris,
        tri_weight=tri_weight,
        source_sign=source_sign,
        ref_xy=r_xy,
        penalty_coeff=float(optim["penalty_coeff"]),
        delaunay_penalty=dp,
        flip_allowance=dp * float(allowed_flip_fraction)
        * float(tri_weight[source_sign != 0].sum()),
    )


@dataclass
class Judged:
    """What the reference finds of one matching."""

    infeasible: int        # non-candidate pairs + aligned matched twice
                           # + matches over a capacity + unknown ids
    objective: float       # the objective above, with the flip allowance
    assignment: float      # the same without the tearing term
    flips: int             # flipped triangles
    flip_excess_pct: float  # flipped weight beyond the allowance, in %
                            # of the allowance


def judge(w: Window, aligned_ids, ref_ids):
    """Judge a matching given as two id arrays (one entry a match)."""
    aligned_ids = np.asarray(aligned_ids)
    ref_ids = np.asarray(ref_ids)
    a_row = {v: i for i, v in enumerate(w.aligned_ids.tolist())}
    r_row = {v: j for j, v in enumerate(w.ref_ids.tolist())}
    pair_of = {(int(i), int(j)): p for p, (i, j) in enumerate(w.pairs.tolist())}
    bad = 0
    match = np.full(len(w.aligned_ids), -1, np.int64)
    match_pair = np.full(len(w.aligned_ids), -1, np.int64)
    for a, r in zip(aligned_ids.tolist(), ref_ids.tolist()):
        i, j = a_row.get(a), r_row.get(r)
        p = pair_of.get((i, j)) if i is not None and j is not None else None
        if p is None or match[i] >= 0:
            bad += 1
            continue
        match[i], match_pair[i] = j, p
    used = np.bincount(match[match >= 0], minlength=len(w.ref_ids))
    bad += int(np.maximum(used - w.capacity, 0).sum())
    matched = match >= 0
    assignment = (
        float(w.pair_cost[match_pair[matched]].sum())
        + w.penalty_coeff * float(np.maximum(used - 1, 0).sum())
        + float(w.no_match[~matched].sum())
    )
    flipped = flipped_triangles(w, match)
    paid = w.delaunay_penalty * float(w.tri_weight[flipped].sum())
    tear = max(0.0, paid - w.flip_allowance)
    flip_excess = (
        100.0 * (paid - w.flip_allowance) / w.flip_allowance if w.flip_allowance else 0.0
    )
    return Judged(bad, assignment + tear, assignment, int(flipped.sum()), flip_excess)


def flipped_triangles(w: Window, match):
    """[T] bool: all three vertices matched and the orientation reversed."""
    if not len(w.tris):
        return np.zeros(0, bool)
    m = match[w.tris]
    ok = (m >= 0).all(axis=1)
    out = np.zeros(len(w.tris), bool)
    after = np.sign(signed_area2(w.ref_xy, np.where(ok[:, None], m, 0)))
    out[ok] = (w.source_sign[ok] * after[ok]) < 0
    return out


def optimum(w: Window):
    """Least assignment objective without the tearing term, and its matching
    (ref row per aligned row, -1 for none): a min-weight full matching of the
    aligned rows over one column per unit of reference capacity, the first
    of each reference free of the congestion penalty, and a private
    no-match column per row."""
    cap = w.capacity
    n, m = len(w.aligned_ids), len(w.ref_ids)
    base = np.zeros(m + 1, np.int64)
    np.cumsum(cap, out=base[1:])
    rows, cols, vals = [], [], []
    i, j = w.pairs[:, 0], w.pairs[:, 1]
    for s in range(int(cap.max())):
        sel = s < cap[j]
        rows.append(i[sel])
        cols.append(base[j[sel]] + s)
        vals.append(w.pair_cost[sel] + (w.penalty_coeff if s else 0.0))
    rows.append(np.arange(n))
    cols.append(base[-1] + np.arange(n))
    vals.append(w.no_match)
    offset = 1.0  # every row takes one column; keeps each weight nonzero
    g = sp.csr_matrix(
        (np.concatenate(vals) + offset, (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, int(base[-1]) + n),
    )
    _, col = min_weight_full_bipartite_matching(g)
    total = float(np.asarray(g[np.arange(n), col]).ravel().sum()) - n * offset
    slot_ref = np.repeat(np.arange(m), cap)
    match = np.where(col < base[-1], slot_ref[np.minimum(col, base[-1] - 1)], -1)
    return total, match
