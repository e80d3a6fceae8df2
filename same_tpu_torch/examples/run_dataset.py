#!/usr/bin/env python
"""Run SAME-TPU on the paper datasets (heart / tongue / luad).

Input CSVs come from the SAME Zenodo archive (zenodo.org/records/19056915);
this script reproduces the per-dataset preprocessing and parameterization of
the reference run scripts (examples/{heart,tongue,luad}/run_same.sh):

  heart : ISS serial sections, 8 types, `_percentage` prob columns,
          coords = spot_x + 75; window=4000/overlap=100/radius=50, MS sweep.
  tongue: MERSCOPE RNA template vs PCF protein query, 5 types, probs x100;
          window=4000/overlap=300/radius=300, MS=1.
  luad  : Xenium RNA template vs PCF protein query, 5 types, probs x100;
          MS=3 metacells both sides, window=13000/overlap=250/radius=250.

Usage:
  python -m same_tpu_torch.examples.run_dataset heart  --data DIR [--dp 10 --knn 8 --ms 1]
  python -m same_tpu_torch.examples.run_dataset tongue --data DIR [--dp 10]
  python -m same_tpu_torch.examples.run_dataset luad   --data DIR [--dp 10 --ms 3]
"""

import argparse
import time

import numpy as np
import pandas as pd

from same_tpu_torch.examples import card

HEART_TYPES = [
    "Smooth muscle cells", "Fibroblast", "Atrial cardiomyocytes",
    "Cardiomyocytes", "Endothelium", "Epicardium", "Schwan progenitors",
    "Ventricular cardiomyocytes",
]
LUAD_TYPES = ["B cell", "Epithelial", "Mesenchymal", "Myeloid", "T cell"]


def load_heart(data_dir):
    """ISS heart serial sections: rename ``<type>_percentage`` -> bare names
    (reference heart/reproduce_figures.ipynb cell 5) and use the
    valis-registered ``New_X/New_Y`` coordinates.

    The packaged reference scripts say ``spot_x + 75``, but that coordinate
    system cannot produce the published results: raw spots sit on a
    242.5-pitch grid (every triangle dies at r_max=50, and 10% of query
    spots have no ref spot within the kNN radius), while ``New_X`` has
    12.8-unit pitch and reproduces the published image-only baseline
    exactly (1-NN accuracy 57.60% == INITIAL_ACCURACY in
    reproduce_figures.ipynb cell 3; spot_x gives 43.06%).
    """
    align = pd.read_csv(f"{data_dir}/queryAD_valis.csv")
    ref = pd.read_csv(f"{data_dir}/refAD_valis.csv")
    rename = {t + "_percentage": t for t in HEART_TYPES}
    for df in (align, ref):
        df.rename(columns=rename, inplace=True)
        df["X"] = df["New_X"] + 75
        df["Y"] = df["New_Y"] + 75
        df["cell_type"] = df[HEART_TYPES].idxmax(axis=1)
    return ref, align, HEART_TYPES, dict(
        window_size=4000, overlap=100, radius=50, r_max=50, id_col="Cell_Num"
    )


TONGUE_TYPES = [
    "Endothelial cells", "Epithelial cells", "Fibroblasts",
    "Lymphoid cells", "Myeloid cells",
]


def load_tongue(data_dir):
    """MERSCOPE RNA template vs PCF protein query (reference
    examples/tongue/run_same.sh:74-88): coords = transformed_x/y, probs x100."""
    ref = pd.read_csv(f"{data_dir}/mer_df.csv", index_col=0)
    align = pd.read_csv(f"{data_dir}/prot_df.csv", index_col=0)
    for df in (ref, align):
        df["X"] = df["transformed_x"]
        df["Y"] = df["transformed_y"]
        df[TONGUE_TYPES] = df[TONGUE_TYPES] * 100
        df["cell_type"] = df[TONGUE_TYPES].idxmax(axis=1)
    return ref, align, TONGUE_TYPES, dict(
        window_size=4000, overlap=300, radius=300, r_max=300,
        id_col="Cell_Num",
    )


def load_luad(data_dir):
    align = pd.read_csv(f"{data_dir}/align_pcf.csv", index_col=0)
    ref = pd.read_csv(f"{data_dir}/ref_xen.csv", index_col=0)
    for df in (align, ref):
        df["Cell_Num_Old"] = df.index.values
        df["cell_type"] = df[LUAD_TYPES].idxmax(axis=1)
        df[LUAD_TYPES] = df[LUAD_TYPES] * 100
    return ref, align, LUAD_TYPES, dict(
        window_size=13000, overlap=250, radius=250, r_max=250,
        id_col="Cell_Num_Old",
    )


def load_synthetic(data_dir):
    """The paper's 4-quadrant benchmark (reference examples/synthetic/run_same.sh:30-55)."""
    ref = pd.read_csv(f"{data_dir}/ref.csv", index_col=0)
    align = pd.read_csv(f"{data_dir}/query.csv", index_col=0)
    return ref, align, ["c1", "c2", "c3"], dict(
        window_size=100, overlap=0, radius=5, r_max=5, id_col="cell_idx",
        min_angle_deg=5, max_matches=2, mip_gap=0.025,
        ignore_same_type_triangles=False,
    )


LOADERS = {
    "heart": load_heart, "tongue": load_tongue, "luad": load_luad,
    "synthetic": load_synthetic,
}


def evaluate_synthetic(matches, mc_ref, mc_align):
    """Synthetic-benchmark evaluation (reference
    examples/synthetic/reproduce_figures.ipynb cells 16+22): direct matched
    cell-type agreement plus node-level triangle_violation counts with
    ``ignore_same_type_triangles=False``.
    """
    from same_tpu_torch import check_triangle_violations

    matches = matches.copy()
    matches["align_cell_type"] = mc_align.metacell_df.loc[
        matches["Aligned_metacell_id"].values, "cell_type"
    ].values
    matches["ref_cell_type"] = mc_ref.metacell_df.loc[
        matches["Ref_metacell_id"].values, "cell_type"
    ].values
    ct_accuracy = float(
        (matches["align_cell_type"] == matches["ref_cell_type"]).mean()
    )
    matches["cell_type"] = matches["align_cell_type"]
    matches.index = matches["Aligned_metacell_id"].values
    tri_df, stats = check_triangle_violations(
        matches, mc_align,
        aligned_id_col="Aligned_metacell_id", ref_id_col="Ref_metacell_id",
        mapped_x_col="ref_X", mapped_y_col="ref_Y",
        cell_type_col="cell_type", ignore_same_type_triangles=False,
        node_local=False, verbose=False,
    )
    return {
        "dataset": "synthetic",
        "matches": int(len(matches)),
        "ct_accuracy_pct": round(100 * ct_accuracy, 2),
        "violation_nodes": int(tri_df["triangle_violation"].sum()),
        "in_violating_only": int(
            (
                tri_df["in_violating_triangle"] & ~tri_df["triangle_violation"]
            ).sum()
        ),
        "triangles_flipped": int(stats["triangles_flipped"]),
        "total_triangles": int(stats["total_triangles"]),
    }


def evaluate_luad_topk(matches, mc_ref, mc_align, common, id_col):
    """LUAD downstream evaluation (reference
    examples/luad/reproduce_figures.ipynb cells 12-13, Fig S19): unpack the
    metacell matches to individual cells with the 'nearest' strategy, score
    direct cell-type agreement, then top-1/2/3 agreement of each aligned
    cell's dominant type against its matched ref cell's probability ranking.
    The reference unpacks ``matchedDF`` as written by the sliding-window run
    (central-cropped, no unique-ref merge), so this does too.
    """
    from same_tpu_torch import topk_type_match, unpack_metacell_matches

    individual = unpack_metacell_matches(
        matches, mc_align.metacell_df, mc_ref.metacell_df,
        aligned_df=mc_align.original_df, ref_df=mc_ref.original_df,
        strategy="nearest",
        aligned_original_idx_col=id_col, ref_original_idx_col=id_col,
    )
    aligned_ct = mc_align.original_df.set_index(id_col)["cell_type"]
    ref_ct = mc_ref.original_df.set_index(id_col)["cell_type"]
    individual["aligned_celltype"] = individual["Aligned_cell_id"].map(aligned_ct)
    individual["ref_celltype"] = individual["Ref_cell_id"].map(ref_ct)
    ct_match = (
        individual["aligned_celltype"] == individual["ref_celltype"]
    ).mean()

    ref_probs = mc_ref.original_df.set_index(id_col)[common]
    individual, topk = topk_type_match(
        individual, aligned_ct, ref_probs, common
    )
    return {
        "individual_matches": int(len(individual)),
        "individual_ct_accuracy_pct": round(100 * float(ct_match), 2),
        "top1_pct": round(100 * topk[1], 2),
        "top2_pct": round(100 * topk[2], 2),
        "top3_pct": round(100 * topk[3], 2),
    }


def evaluate(matches, mc_ref, mc_align, common, dataset):
    """Reference-notebook evaluation: 1-NN cell-type accuracy of matched
    query cells placed at their matched ref positions, plus triangle-flip
    statistics over the aligned Delaunay. The heart notebook counts flips
    with ``ignore_same_type_triangles=True`` (reproduce_figures.ipynb cell
    21), the tongue notebook with ``False`` (tongue cell 11).
    """
    from same_tpu_torch import check_alignment, check_triangle_violations

    matches = matches.copy()
    matches["cell_type"] = matches[common].idxmax(axis=1)
    matches["SAME_X"] = matches["ref_X"]
    matches["SAME_Y"] = matches["ref_Y"]

    ref_df = mc_ref.metacell_df.copy()
    ref_df["cell_type"] = ref_df[common].idxmax(axis=1)
    ref_df["SAME_X"] = ref_df["X"]
    ref_df["SAME_Y"] = ref_df["Y"]

    eval_df, _ = check_alignment(
        matches, ref_df, xcol="SAME_X", ycol="SAME_Y",
        ctype_col="cell_type", kNN=1,
    )
    accuracy = 100 * eval_df["_1NN_match"].sum() / len(eval_df)

    matches.index = matches["Aligned_metacell_id"].values
    _tri_df, stats = check_triangle_violations(
        matches, mc_align,
        aligned_id_col="Aligned_metacell_id", ref_id_col="Ref_metacell_id",
        mapped_x_col="ref_X", mapped_y_col="ref_Y",
        cell_type_col="cell_type",
        ignore_same_type_triangles=(dataset == "heart"),
        verbose=False,
    )
    violations = 100 * stats["triangles_flipped"] / max(
        stats["total_triangles"], 1
    )
    return {
        "dataset": dataset,
        "matches": int(len(matches)),
        "ct_accuracy_pct": round(float(accuracy), 2),
        "triangle_violations_pct": round(float(violations), 2),
        "triangles_flipped": int(stats["triangles_flipped"]),
        "total_triangles": int(stats["total_triangles"]),
    }


def exact_window_objective(pw, match_ref, match_pair, frac=0.05):
    """Exact flips-pay objective of a matching on a prepared window.

    The accounting of solver/repair._RepairState with no registered cuts:
    base assignment cost + congestion + no-match + dp * flipped weight
    beyond the ``frac`` budget allowance — the common yardstick used to
    compare our solutions against the recovered published Gurobi
    alignments (BENCH_NOTES round 4).
    """
    import numpy as np

    from same_tpu_torch.solver.repair import _RepairState

    dp = float(pw.optim["delaunay_penalty"])
    src = np.asarray(pw.source_signs)
    checkable_w = (
        float(np.asarray(pw.tri_weights)[src != 0].sum())
        if len(pw.tris)
        else 0.0
    )
    st = _RepairState(
        pw.problem, pw.pair_costs, pw.tris, pw.tri_weights, pw.source_signs,
        np.asarray(pw.ref_coords, float),
        np.asarray(match_ref, np.int64).copy(),
        np.asarray(match_pair, np.int64).copy(),
        None, dp, float(pw.optim["penalty_coeff"]),
        flip_penalty=dp, flip_allowance=dp * frac * checkable_w,
    )
    return float(st.obj)


def matching_from_matches_df(pw, matches, cell_id_col="metacell_id"):
    """Map a matches DataFrame onto window rows -> (match_ref, match_pair).

    Returns (mr, mp, n_dropped) — rows whose (aligned, ref) pair is not in
    the window's candidate set are dropped (counted).
    """
    import numpy as np

    a_of = {v: i for i, v in enumerate(pw.aligned_df[cell_id_col])}
    r_of = {v: i for i, v in enumerate(pw.ref_df[cell_id_col])}
    pair_of = {
        (int(i), int(j)): p
        for p, (i, j) in enumerate(np.asarray(pw.valid_pairs))
    }
    n = pw.problem.n_aligned
    mr = np.full(n, -1, np.int64)
    mp = np.full(n, -1, np.int64)
    dropped = 0
    for a_id, r_id in zip(
        matches[f"Aligned_{cell_id_col}"], matches[f"Ref_{cell_id_col}"]
    ):
        a, r = a_of.get(a_id), r_of.get(r_id)
        p = pair_of.get((a, r)) if a is not None and r is not None else None
        if p is None:
            dropped += 1
            continue
        mr[a], mp[a] = r, p
    return mr, mp, dropped


def published_consistent_matching(pw, rec_csv, ref_loaded, id_col):
    """Cheapest full assignment consistent with a recovered published figure.

    ``rec_csv`` (examples/results/reference_*_matches.csv, from
    recover_published_alignment.py) lists each published match's
    (query_type, ref_row) — ref_row positional in the loaded ref frame.
    The published per-query assignment is not recoverable from the figure,
    so the most favorable interpretation is taken: for each query type,
    the MIN-COST assignment of that type's query cells onto exactly the
    recovered ref rows over the window's candidate graph; uncovered
    queries pay no-match. Returns (mr, mp, n_unmapped).
    """
    import numpy as np
    import pandas as pd
    from scipy.optimize import linear_sum_assignment

    rec = pd.read_csv(rec_csv)
    orig_ids = ref_loaded[id_col].to_numpy()
    member_to_row = {m[0]: i for i, m in enumerate(pw.ref_df["members"])}
    qt = pw.aligned_df["cell_type"].to_numpy()
    pair_of = {
        (int(i), int(j)): p
        for p, (i, j) in enumerate(np.asarray(pw.valid_pairs))
    }
    costs = np.asarray(pw.pair_costs)
    BIG = 1e9
    n = pw.problem.n_aligned
    mr = np.full(n, -1, np.int64)
    mp = np.full(n, -1, np.int64)
    unmapped = 0
    for t in rec["query_type"].unique():
        wrows = []
        for rr in rec.loc[rec["query_type"] == t, "ref_row"]:
            wr = member_to_row.get(orig_ids[int(rr)])
            if wr is None:
                unmapped += 1
            else:
                wrows.append(wr)
        qrows = np.flatnonzero(qt == t)
        if not len(wrows) or not len(qrows):
            continue
        M = np.full((len(qrows), len(wrows)), BIG)
        for qi, q in enumerate(qrows):
            for wi, w in enumerate(wrows):
                p = pair_of.get((int(q), int(w)))
                if p is not None:
                    M[qi, wi] = costs[p]
        ri, ci = linear_sum_assignment(M)
        for qi, wi in zip(ri, ci):
            if M[qi, wi] >= BIG / 2:
                unmapped += 1
                continue
            q, w = int(qrows[qi]), int(wrows[wi])
            mr[q], mp[q] = w, pair_of[(q, w)]
    return mr, mp, unmapped


def prepare_paper_window(mc_ref, mc_align, common, cfg, dp=10, knn=8, ms=1,
                         device=None):
    """PreparedWindow over the full extent (heart/tongue are single-window)."""
    from same_tpu_torch.core import prepare_window

    min_angle = cfg.get("min_angle_deg", 15)
    optim = dict(
        max_matches=cfg.get("max_matches", 1), radius=cfg["radius"], knn=knn,
        no_match_penalty=10000, dist_ct_coeff=1, penalty_coeff=100,
        delaunay_penalty=dp, cell_id_col="metacell_id",
        ref_metacell_match_multiplier=ms, min_angle_deg=min_angle,
        ignore_same_type_triangles=cfg.get("ignore_same_type_triangles", True),
    )
    return prepare_window(
        mc_ref.metacell_df, mc_align, common,
        optim_params=optim,
        solver_params=dict(mip_gap=cfg.get("mip_gap", 0.05)),
        verbose=False, device=device,
    )


def run_and_evaluate(
    dataset, data_dir, dp=10, knn=8, ms=None, out=None, solver_overrides=None,
    optim_overrides=None, return_artifacts=False, device=None,
):
    """Collapse -> sliding windows -> reference-notebook evaluation.

    The callable core of this script (used by the parity regression tests,
    tests/test_real_datasets.py). Returns the evaluation dict.
    """
    from same_tpu_torch import greedy_triangle_collapse, sliding_window_matching

    ref, align, common, cfg = LOADERS[dataset](data_dir)
    ms = ms if ms is not None else (3 if dataset == "luad" else 1)
    print(f"{dataset}: ref={ref.shape}, align={align.shape}, MS={ms}")

    min_angle = cfg.get("min_angle_deg", 15)
    mc_align = greedy_triangle_collapse(
        align, cell_type_col="cell_type", original_idx_col=cfg["id_col"],
        x_col="X", y_col="Y", max_metacell_size=ms, r_max=cfg["r_max"],
        min_angle_deg=min_angle, use_alpha_shape=False, return_object=True,
    )
    mc_ref = greedy_triangle_collapse(
        ref, cell_type_col="cell_type", original_idx_col=cfg["id_col"],
        x_col="X", y_col="Y", max_metacell_size=ms, r_max=cfg["r_max"],
        min_angle_deg=min_angle, use_alpha_shape=False, return_object=True,
    )

    optim = dict(
        window_size=cfg["window_size"], overlap=cfg["overlap"],
        min_cells_per_window=30, max_matches=cfg.get("max_matches", 1),
        radius=cfg["radius"], knn=knn, no_match_penalty=10000,
        dist_ct_coeff=1, penalty_coeff=100, delaunay_penalty=dp,
        cell_id_col="metacell_id", ref_metacell_match_multiplier=ms,
        min_angle_deg=min_angle,
        ignore_same_type_triangles=cfg.get("ignore_same_type_triangles", True),
    )
    optim.update(optim_overrides or {})
    solver = dict(
        mip_gap=cfg.get("mip_gap", 0.05),
        lazy_allowed_flip_fraction=(
            0.0 if dataset == "synthetic" else 0.05
        ),
    )
    solver.update(solver_overrides or {})

    t0 = time.time()
    matches = sliding_window_matching(
        mc_ref, mc_align, outprefix=out,
        optim_params=optim, solver_params=solver, device=device,
    )
    minutes = (time.time() - t0) / 60
    print(
        f"Done in {minutes:.1f} min — {len(matches)} matches, "
        f"{matches['triangle_violation'].mean():.1%} violation nodes; {card(device)}"
    )

    if dataset == "synthetic":
        result = evaluate_synthetic(matches, mc_ref, mc_align)
        result.update(dp=dp, knn=knn, ms=ms, minutes=round(minutes, 2),
                      device=card(device))
        print(
            f"Eval: accuracy={result['ct_accuracy_pct']}% "
            f"violation_nodes={result['violation_nodes']} "
            f"(+{result['in_violating_only']} in_violating_only)"
        )
    else:
        result = evaluate(matches, mc_ref, mc_align, common, dataset)
        result.update(dp=dp, knn=knn, ms=ms, minutes=round(minutes, 2),
                      device=card(device))
        print(
            f"Eval: accuracy={result['ct_accuracy_pct']}% "
            f"violations={result['triangle_violations_pct']}% "
            f"({result['triangles_flipped']}/{result['total_triangles']})"
        )
        if dataset == "luad":
            result.update(
                evaluate_luad_topk(
                    matches, mc_ref, mc_align, common, cfg["id_col"]
                )
            )
            print(
                f"LUAD top-k (Fig S19): {result['individual_matches']} "
                f"individual matches, ct={result['individual_ct_accuracy_pct']}% "
                f"top-1/2/3 = {result['top1_pct']}/{result['top2_pct']}/"
                f"{result['top3_pct']}%"
            )
    if return_artifacts:
        return result, dict(
            matches=matches, mc_ref=mc_ref, mc_align=mc_align,
            ref=ref, align=align, common=common, cfg=cfg, dp=dp, knn=knn,
            ms=ms,
        )
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=sorted(LOADERS))
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dp", type=float, default=10)
    ap.add_argument("--knn", type=int, default=8)
    ap.add_argument("--ms", type=int, default=None)
    ap.add_argument("--json", default=None, help="write evaluation JSON here")
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU (the same as --device cpu)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device to solve on (default: the first CUDA card; "
        "'cpu' runs the kernels' plain versions)",
    )
    args = ap.parse_args()

    if args.cpu:
        args.device = "cpu"
    card(args.device)

    result = run_and_evaluate(
        args.dataset, args.data, dp=args.dp, knn=args.knn, ms=args.ms,
        out=args.out, device=args.device,
    )
    if args.json:
        import json

        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
