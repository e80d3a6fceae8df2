"""Evaluation and verification utilities.

Solver-independent oracles reproduced from the reference:
- ``verify_spatial_preservation`` / ``print_violation_report``
  (reference src/violationhelper.py:1-167): pairwise X/Y-order preservation
  checks over triangle vertices.
- ``check_alignment`` (reference src/eval_utils.py:6-53): k-NN cell-type
  agreement between matched query positions and a template.
- ``check_triangle_violations`` (reference src/eval_utils.py:66-223):
  signed-area flip statistics over a MetaCell triangulation, with
  same-type skipping and optional node-local majority voting.

All heavy inner loops are vectorized numpy; the structured outputs keep the
reference's exact dict/DataFrame shapes so downstream notebooks work.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def precompute_triangle_info(aligned_df, aligned_delaunay, aligned_simplex_map=None):
    """Per-triangle info dict (reference src/helpers.py:184-210).

    Keys per simplex index: vertices, bounds, and the (first) vertex attaining
    each extreme coordinate.
    """
    tris = np.asarray(aligned_delaunay, dtype=np.int64).reshape(-1, 3)
    xs = aligned_df["X"].to_numpy()
    ys = aligned_df["Y"].to_numpy()
    info = {}
    for t, tri in enumerate(tris):
        tx = xs[tri]
        ty = ys[tri]
        info[t] = {
            "vertices": tri,
            "bounds": {
                "min_x": tx.min(),
                "max_x": tx.max(),
                "min_y": ty.min(),
                "max_y": ty.max(),
            },
            "max_x_vertex": int(tri[int(np.argmax(tx))]),
            "min_x_vertex": int(tri[int(np.argmin(tx))]),
            "max_y_vertex": int(tri[int(np.argmax(ty))]),
            "min_y_vertex": int(tri[int(np.argmin(ty))]),
        }
    return info


def verify_spatial_preservation(
    aligned_df, ref_df, matches_df, triangle_info, tolerance=1e-6
):
    """Pairwise coordinate-order preservation report.

    Semantics match reference src/violationhelper.py:1-134: for every triangle
    with >= 2 matched vertices, every matched vertex pair is checked for X- and
    Y-order preservation (strict ``<`` comparisons).
    """
    violations = {
        "x_order_violations": [],
        "y_order_violations": [],
        "triangles_with_violations": set(),
        "points_with_violations": set(),
        "violation_summary": {
            "total_triangles": len(triangle_info),
            "violated_triangles": 0,
            "total_comparisons": 0,
            "total_violations": 0,
        },
    }

    match_lookup = dict(
        zip(matches_df["aligned_idx"].tolist(), matches_df["ref_idx"].tolist())
    )
    ax = aligned_df["X"].to_numpy()
    ay = aligned_df["Y"].to_numpy()
    rx = ref_df["X"].to_numpy()
    ry = ref_df["Y"].to_numpy()

    for simplex_idx, info in triangle_info.items():
        vertices = info["vertices"]
        matched = [v for v in vertices if v in match_lookup]
        if len(matched) < 2:
            continue
        triangle_violated = False
        for i, v1 in enumerate(matched):
            for v2 in matched[i + 1 :]:
                violations["violation_summary"]["total_comparisons"] += 1
                r1, r2 = match_lookup[v1], match_lookup[v2]
                if (ax[v1] < ax[v2]) != (rx[r1] < rx[r2]):
                    violations["x_order_violations"].append(
                        {
                            "triangle_idx": simplex_idx,
                            "point1": {
                                "aligned_idx": v1,
                                "ref_idx": r1,
                                "orig_x": ax[v1],
                                "matched_x": rx[r1],
                            },
                            "point2": {
                                "aligned_idx": v2,
                                "ref_idx": r2,
                                "orig_x": ax[v2],
                                "matched_x": rx[r2],
                            },
                        }
                    )
                    triangle_violated = True
                    violations["points_with_violations"].update([v1, v2])
                    violations["violation_summary"]["total_violations"] += 1
                if (ay[v1] < ay[v2]) != (ry[r1] < ry[r2]):
                    violations["y_order_violations"].append(
                        {
                            "triangle_idx": simplex_idx,
                            "point1": {
                                "aligned_idx": v1,
                                "ref_idx": r1,
                                "orig_y": ay[v1],
                                "matched_y": ry[r1],
                            },
                            "point2": {
                                "aligned_idx": v2,
                                "ref_idx": r2,
                                "orig_y": ay[v2],
                                "matched_y": ry[r2],
                            },
                        }
                    )
                    triangle_violated = True
                    violations["points_with_violations"].update([v1, v2])
                    violations["violation_summary"]["total_violations"] += 1
        if triangle_violated:
            violations["triangles_with_violations"].add(simplex_idx)
            violations["violation_summary"]["violated_triangles"] += 1

    violations["triangles_with_violations"] = list(
        violations["triangles_with_violations"]
    )
    violations["points_with_violations"] = list(violations["points_with_violations"])
    summary = violations["violation_summary"]
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
    return violations


def print_violation_report(violations):
    """Human-readable summary (reference src/violationhelper.py:136-147)."""
    summary = violations["violation_summary"]
    print("\nSpatial Preservation Violation Report")
    print("=====================================")
    print(f"Total triangles analyzed: {summary['total_triangles']}")
    print(
        f"Triangles with violations: {summary['violated_triangles']} "
        f"({summary['percent_triangles_violated']:.2f}%)"
    )
    print(f"Total position comparisons: {summary['total_comparisons']}")
    print(
        f"Total violations found: {summary['total_violations']} "
        f"({summary['percent_violations']:.2f}%)"
    )
    print(
        "Number of points involved in violations: "
        f"{len(violations['points_with_violations'])}"
    )


def check_alignment(queryDF, templateDF, xcol, ycol, ctype_col="cell_type", kNN=1):
    """k-NN cell-type agreement score (reference src/eval_utils.py:6-53).

    Returns ``(queryDF_with_match_column, alignment_score)``.
    """
    queryDF = queryDF.copy()
    required = {xcol, ycol, ctype_col}
    if not required.issubset(queryDF.columns) or not required.issubset(
        templateDF.columns
    ):
        raise ValueError(f"Both DataFrames must contain the columns: {required}")

    from scipy.spatial import cKDTree

    tree = cKDTree(templateDF[[xcol, ycol]].to_numpy())
    _dist, indices = tree.query(queryDF[[xcol, ycol]].to_numpy(), k=kNN)

    q_types = queryDF[ctype_col].to_numpy()
    t_types = templateDF[ctype_col].to_numpy()
    col = f"_{kNN}NN_match"
    if kNN == 1:
        match = q_types == t_types[indices]
        queryDF[col] = match
        queryDF[f"_{kNN}NN_match_ctype"] = t_types[indices]
    else:
        match = np.array(
            [q_types[i] in t_types[indices[i]] for i in range(len(queryDF))]
        )
        queryDF[col] = match
    return queryDF, float(queryDF[col].mean())


def check_triangle_violations(
    outputDF,
    mc_align,
    aligned_id_col="aligned_metacell_index",
    ref_id_col="matched_ref_index",
    mapped_x_col="mapped_x",
    mapped_y_col="mapped_y",
    cell_type_col="cell_type",
    ignore_same_type_triangles=True,
    node_local=False,
    majority_threshold=0.5,
    min_flips=1,
    verbose=False,
):
    """Triangle-flip statistics after alignment (reference src/eval_utils.py:66-223).

    ``outputDF`` rows are matched aligned entities with their mapped (ref)
    coordinates; ``mc_align`` provides ``metacell_df`` (source coordinates)
    and ``metacell_delaunay``.
    """
    outputDF = outputDF.copy()
    triangles = np.asarray(mc_align.metacell_delaunay, dtype=np.int64).reshape(-1, 3)

    out_ids = outputDF[aligned_id_col].to_numpy()
    id_to_row = {int(v): i for i, v in enumerate(out_ids)}

    src_xy = mc_align.metacell_df[["X", "Y"]].to_numpy(dtype=float)
    mapped_xy = outputDF[[mapped_x_col, mapped_y_col]].to_numpy(dtype=float)
    out_types = outputDF[cell_type_col].to_numpy()

    node_in_violating = {int(x): False for x in np.unique(out_ids)}
    node_tri_counts = {k: 0 for k in node_in_violating}
    node_flip_counts = {k: 0 for k in node_in_violating}

    sign_flips = []
    tri_with_matched = tri_processed = tri_same_type_skipped = 0

    def _sgn(p1, p2, p3):
        return np.sign(
            0.5
            * (
                p1[0] * (p2[1] - p3[1])
                + p2[0] * (p3[1] - p1[1])
                + p3[0] * (p1[1] - p2[1])
            )
        )

    for tri in triangles:
        rows = [id_to_row.get(int(v)) for v in tri]
        if any(r is None for r in rows):
            continue
        tri_with_matched += 1

        is_same_type = False
        if ignore_same_type_triangles:
            t0, t1, t2 = (out_types[r] for r in rows)
            if t0 == t1 == t2:
                is_same_type = True
                tri_same_type_skipped += 1
        tri_processed += 1

        before = _sgn(*(src_xy[int(v)] for v in tri))
        after = _sgn(*(mapped_xy[r] for r in rows))
        is_flipped = (before != after) and (before != 0) and (after != 0)

        if not is_same_type:
            sign_flips.append(is_flipped)
            for v in tri:
                v = int(v)
                if v in node_tri_counts:
                    node_tri_counts[v] += 1
                    if is_flipped:
                        node_flip_counts[v] += 1
            if (not node_local) and is_flipped:
                for v in tri:
                    node_in_violating[int(v)] = True

    if node_local:
        for v, n_tri in node_tri_counts.items():
            n_flip = node_flip_counts[v]
            if n_tri == 0:
                node_in_violating[v] = False
                continue
            node_in_violating[v] = (n_flip >= min_flips) and (
                n_flip / n_tri >= majority_threshold
            )

    outputDF["in_violating_triangle"] = (
        outputDF[aligned_id_col].map(node_in_violating).fillna(False)
    )

    stats = {
        "total_triangles": len(triangles),
        "triangles_with_all_matched": tri_with_matched,
        "triangles_processed": tri_processed,
        "triangles_same_type_skipped": tri_same_type_skipped,
        "triangles_flipped": int(np.sum(sign_flips)) if len(sign_flips) else 0,
        "percent_flipped": (
            100.0 * np.sum(sign_flips) / len(sign_flips) if len(sign_flips) else 0.0
        ),
        "nodes_in_violating_triangles": int(outputDF["in_violating_triangle"].sum()),
        "percent_nodes_violating": 100.0 * outputDF["in_violating_triangle"].mean(),
    }
    if verbose:
        print(stats)
    return outputDF, stats


def topk_type_match(
    individual_matches,
    aligned_types,
    ref_probs,
    cell_types,
    ks=(1, 2, 3),
    aligned_col="Aligned_cell_id",
    ref_col="Ref_cell_id",
):
    """Top-k cell-type agreement over an unpacked match table (Fig S19).

    Semantics of reference examples/luad/reproduce_figures.ipynb cells
    12-13: a matched pair scores a top-k hit when the aligned cell's
    dominant type is among the ``k`` highest-probability types of its
    matched REF cell. Rows whose ref id has no probability row (or whose
    aligned id has no type label) score False but STAY in the denominator,
    exactly as the reference's vectorized evaluation does.

    Parameters
    ----------
    individual_matches : DataFrame with ``aligned_col`` / ``ref_col``
        (the ``unpack_metacell_matches`` output shape).
    aligned_types : Series mapping aligned cell id -> dominant cell type
        (e.g. ``original_df.set_index(id_col)['cell_type']``).
    ref_probs : DataFrame indexed by ref cell id whose columns include
        ``cell_types`` (per-type probabilities or scores).
    cell_types : list of type-column names; order defines tie-breaking via
        ``np.argpartition`` (matches the reference).
    ks : iterable of k values to score.

    Returns ``(matches_with_top_k_columns, {k: fraction})``.
    """
    out = individual_matches.copy()
    cell_types = list(cell_types)
    ct_array = np.asarray(cell_types)

    probs = ref_probs[cell_types].astype(float)
    valid = out[ref_col].isin(probs.index).to_numpy()
    ref_rows = probs.loc[out.loc[valid, ref_col]].to_numpy()

    dom = out[aligned_col].map(aligned_types)
    dom_valid = dom.to_numpy()[valid]

    scores = {}
    for k in ks:
        k = int(k)
        hits = np.zeros(len(out), dtype=bool)
        if len(ref_rows) and 0 < k <= ref_rows.shape[1]:
            top_k_idx = np.argpartition(ref_rows, -k, axis=1)[:, -k:]
            top_k_types = ct_array[top_k_idx]
            hits[valid] = np.any(
                top_k_types == dom_valid[:, np.newaxis], axis=1
            )
        out[f"top_{k}_match"] = hits
        scores[k] = float(hits.mean()) if len(out) else 0.0
    return out, scores
