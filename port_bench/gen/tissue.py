"""Seeded LUAD-like tissue at metacell level: the benchmark's input generator.

A frozen copy of the tissue model of ``same_tpu_torch.instances.make_instance``
(one window) and of ``same_tpu_torch.examples.bench_grid.make_tissue`` (the
whole tissue): cells uniform over a square, five spatially coherent types
(nearest of ``centers_per_type * 5`` random centres), probability columns x100,
a reference copy and a query copy jittered by N(0, 15) units, the query
keeping ``query_keep`` of the cells.

The port's ``greedy_triangle_collapse`` (MS = 3) takes tens of seconds a
window on the host, so every run would pay it. :func:`group_cells` gives the
same grouping, vectorised: each round triangulates the current points, keeps
the triangles of three single cells of one type with every edge at most
``r_max`` and every angle at least ``min_angle_deg``, and takes them in
order of perimeter, skipping any that touches a cell already taken; the
collapse's own loop does the same one triangle at a time. A triangle is taken
exactly when its rank is the least among the open triangles at each of its
vertices, so the rounds below take the same set as that loop.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.spatial import Delaunay, QhullError

LUAD_TYPES = ["B cell", "Epithelial", "Mesenchymal", "Myeloid", "T cell"]


def make_cells(rng_seed, n_cells, extent, centers_per_type, query_keep,
               jitter=15.0):
    """Two jittered copies of one tissue: ``(ref, query)``, each a tuple
    ``(xy [m, 2] float64, type index [m], probs [m, 5])``."""
    rng = np.random.default_rng([*rng_seed, 0])
    n_types = len(LUAD_TYPES)
    xy = rng.uniform(0, extent, (n_cells, 2))
    centers = rng.uniform(0, extent, (n_types * centers_per_type, 2))
    center_type = rng.integers(0, n_types, len(centers))
    types = np.empty(n_cells, np.int64)
    for s in range(0, n_cells, 20000):
        d = ((xy[s:s + 20000, None, :] - centers[None, :, :]) ** 2).sum(-1)
        types[s:s + 20000] = center_type[np.argmin(d, axis=1)]
    probs = np.full((n_cells, n_types), 2.0)
    probs[np.arange(n_cells), types] = 86.0
    probs += rng.uniform(0, 2, probs.shape)
    probs = probs / probs.sum(1, keepdims=True) * 100.0

    def copy(stream, keep_frac):
        r = np.random.default_rng([*rng_seed, stream])
        keep = r.random(n_cells) < keep_frac
        moved = xy[keep] + r.normal(0, jitter, (int(keep.sum()), 2))
        return moved, types[keep], probs[keep]

    return copy(1, 1.0), copy(2, query_keep)


def _filtered_triangles(xy, r_max, min_angle_deg):
    """Delaunay triangles with every edge <= r_max and every angle >=
    min_angle_deg (the collapse's geometric filter)."""
    if len(xy) < 4:
        return np.zeros((0, 3), np.int64)
    try:
        tris = Delaunay(xy).simplices.astype(np.int64)
    except QhullError:
        return np.zeros((0, 3), np.int64)
    p = xy[tris]
    keep = np.ones(len(tris), bool)
    edges = np.stack(
        [np.linalg.norm(p[:, (k + 1) % 3] - p[:, k], axis=1) for k in range(3)],
        axis=1,
    )
    keep &= edges.max(axis=1) <= r_max
    for k in range(3):
        v1 = p[:, (k + 1) % 3] - p[:, k]
        v2 = p[:, (k + 2) % 3] - p[:, k]
        denom = np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1)
        cos = np.where(
            denom > 0, (v1 * v2).sum(axis=1) / np.where(denom > 0, denom, 1.0), 1.0
        )
        ang = np.where(denom > 0, np.degrees(np.arccos(np.clip(cos, -1, 1))), 0.0)
        keep &= ang >= min_angle_deg
    return tris[keep]


def _disjoint_by_rank(tris, n_points):
    """Indices of the triangles that a pass in ascending perimeter order
    takes when it skips any triangle touching a vertex already taken.
    ``tris`` is in that order, so a triangle's rank is its index."""
    picks = []
    open_ = np.ones(len(tris), bool)
    taken = np.zeros(n_points, bool)
    while open_.any():
        idx = np.flatnonzero(open_)
        best = np.full(n_points, len(tris), np.int64)
        np.minimum.at(best, tris[idx].ravel(), np.repeat(idx, 3))
        pick = idx[(best[tris[idx]] == idx[:, None]).all(axis=1)]
        picks.append(pick)
        taken[tris[pick].ravel()] = True
        open_[idx] = ~taken[tris[idx]].any(axis=1)
    return np.sort(np.concatenate(picks)) if picks else np.zeros(0, np.int64)


def group_cells(xy, types, probs, r_max=250.0, min_angle_deg=15.0,
                max_size=3):
    """Group single cells into metacells of up to three, as the MS = 3
    collapse does. Returns ``(xy, type index, probs, size)`` of the
    metacells: the cells never grouped first, in their order, then each
    round's groups in order of perimeter."""
    if max_size != 3:
        raise ValueError("only groups of three are modelled")
    xy = np.asarray(xy, np.float64)
    size = np.ones(len(xy), np.int64)
    types = np.asarray(types)
    probs = np.asarray(probs, np.float64)
    while True:
        tris = _filtered_triangles(xy, r_max, min_angle_deg)
        t = types[tris]
        ok = (
            (t[:, 0] == t[:, 1]) & (t[:, 1] == t[:, 2])
            & (size[tris].sum(axis=1) <= max_size)
        )
        cand = tris[ok]
        if len(cand) == 0:
            break
        p = xy[cand]
        perim = sum(
            np.linalg.norm(p[:, k] - p[:, (k + 1) % 3], axis=1) for k in range(3)
        )
        cand = cand[np.argsort(perim, kind="stable")]
        chosen = cand[_disjoint_by_rank(cand, len(xy))]
        if len(chosen) == 0:
            break
        keep = np.ones(len(xy), bool)
        keep[chosen.ravel()] = False
        xy = np.concatenate([xy[keep], xy[chosen].mean(axis=1)])
        types = np.concatenate([types[keep], types[chosen[:, 0]]])
        probs = np.concatenate([probs[keep], probs[chosen].mean(axis=1)])
        size = np.concatenate([size[keep], size[chosen].sum(axis=1)])
    return xy, types, probs, size


def metacell_frame(xy, types, probs, size):
    """The metacell table as the port's entries take it."""
    df = pd.DataFrame({"X": xy[:, 0], "Y": xy[:, 1]})
    df["cell_type"] = np.asarray(LUAD_TYPES)[types]
    for k, name in enumerate(LUAD_TYPES):
        df[name] = probs[:, k]
    df["size"] = size
    df["metacell_id"] = np.arange(len(df))
    return df


def make(rng_seed, traffic, config):
    """One seeded input of a traffic mix: ``(ref_df, aligned_df)`` at
    metacell level. ``rng_seed`` is a sequence of whole numbers (the run's
    seed and the call's index); the tissue's size comes from the traffic
    mix, the grouping's from the configuration's ``metacell`` group."""
    ref, qry = make_cells(
        rng_seed, int(traffic["n_cells"]), float(traffic["extent"]),
        int(traffic["centers_per_type"]), float(traffic["query_keep"]),
        float(traffic["jitter"]),
    )
    mc = config["metacell"]
    if int(mc["max_metacell_size"]) != 3:
        raise ValueError("the generator models metacells of up to three cells")
    r_max, angle = float(mc["r_max"]), float(mc["min_angle_deg"])
    return (
        metacell_frame(*group_cells(*ref, r_max=r_max, min_angle_deg=angle)),
        metacell_frame(*group_cells(*qry, r_max=r_max, min_angle_deg=angle)),
    )
