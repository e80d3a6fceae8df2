#!/usr/bin/env python
"""Diagnose tear quality on the REAL paper synthetic dataset vs the exact MIP.

Builds the exact single-window problem the paper's synthetic config produces
(reference examples/synthetic/run_same.sh:30-55: dp=10, knn=8, radius=5,
max_matches=2, min_angle=5, zero flip budget), solves it with (a) the TPU
tearing solver and (b) the HiGHS milp_oracle with identical lazy-cut
semantics, and reports objective + flip structure for both. This is the
apples-to-apples harness for VERDICT round-2 item 2 (78 violation nodes vs
Gurobi's 46).

Usage: python -m same_tpu_torch.examples.diagnose_synthetic [--dp 10] [--skip-oracle]
"""

import argparse
import time

import numpy as np
import pandas as pd

from same_tpu_torch.examples import REFERENCE_DIR, card

DATA = f"{REFERENCE_DIR}/examples/synthetic/data"


def build_window(dp, verbose=True, device=None):
    from same_tpu_torch import greedy_triangle_collapse
    from same_tpu_torch.core import prepare_window

    ref_df = pd.read_csv(f"{DATA}/ref.csv", index_col=0)
    query_df = pd.read_csv(f"{DATA}/query.csv", index_col=0)

    mc_align = greedy_triangle_collapse(
        query_df, cell_type_col="cell_type", original_idx_col="cell_idx",
        x_col="X", y_col="Y", max_metacell_size=1, r_max=5, min_angle_deg=5,
        use_alpha_shape=False, return_object=True,
    )
    mc_ref = greedy_triangle_collapse(
        ref_df, cell_type_col="cell_type", original_idx_col="cell_idx",
        x_col="X", y_col="Y", max_metacell_size=1, r_max=5, min_angle_deg=5,
        use_alpha_shape=False, return_object=True,
    )

    optim = dict(
        window_size=100, overlap=0, min_cells_per_window=30, max_matches=2,
        radius=5, knn=8, no_match_penalty=10000, dist_ct_coeff=1,
        penalty_coeff=100, delaunay_penalty=dp, cell_id_col="metacell_id",
        ref_metacell_match_multiplier=1, min_angle_deg=5,
        ignore_same_type_triangles=False, lazy_constraints=True,
    )
    solver = dict(mip_gap=0.025, lazy_allowed_flip_fraction=0.0)

    pw = prepare_window(
        mc_ref.metacell_df, mc_align, ["c1", "c2", "c3"],
        optim_params=optim, solver_params=solver, verbose=verbose,
        device=device,
    )
    return pw, mc_ref, mc_align


def flip_report(pw, match_ref, label):
    tris = pw.tris
    src = np.asarray(pw.source_signs)
    ref_xy = np.asarray(pw.ref_coords, np.float64)
    mr = match_ref[tris]
    ok = (mr >= 0).all(axis=1)
    p = ref_xy[np.clip(mr, 0, len(ref_xy) - 1)]
    cross = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    rs = np.sign(cross).astype(np.int32)
    checked = ok & (src != 0) & (rs != 0)
    flipped = checked & (rs != src)
    viol_nodes = np.unique(tris[flipped])
    n_match = int((match_ref >= 0).sum())
    print(
        f"{label}: matched={n_match}/{pw.problem.n_aligned} "
        f"flipped_tris={int(flipped.sum())}/{int(checked.sum())} "
        f"violation_nodes={len(viol_nodes)}"
    )
    return flipped


def objective_of(pw, match_ref, match_pair, dp, flipped):
    from same_tpu_torch.models.assignment import matching_objective

    n = pw.problem.n_aligned
    matched_costs = np.zeros(n)
    sel = match_pair >= 0
    matched_costs[sel] = pw.pair_costs[match_pair[sel]]
    base = matching_objective(
        match_ref, matched_costs, pw.problem.n_ref,
        float(pw.optim["penalty_coeff"]),
        np.asarray(pw.problem.nm_cost[:n], np.float64),
    )
    tear = dp * float(np.asarray(pw.tri_weights)[flipped].sum())
    return base, base + tear


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=float, default=10)
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--skip-solver", action="store_true")
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
    device_line = card(args.device)

    pw, mc_ref, mc_align = build_window(args.dp, device=args.device)
    print(
        f"Window: n_aligned={pw.problem.n_aligned} n_ref={pw.problem.n_ref} "
        f"pairs={len(pw.valid_pairs)} tris={len(pw.tris)}"
    )

    if not args.skip_solver:
        from same_tpu_torch.core import solve_prepared

        t0 = time.time()
        res = solve_prepared(pw, verbose=False, device=args.device)
        t_solve = time.time() - t0
        flipped = flip_report(pw, res.match_ref, "tearing-solver")
        base, mip = objective_of(
            pw, res.match_ref, res.match_pair, args.dp, flipped
        )
        print(
            f"  objective={mip:.3f} (assignment {base:.3f}) "
            f"cuts={res.cuts_added} rounds={res.tear_rounds} "
            f"wall={t_solve:.1f}s; {device_line}"
        )

    if not args.skip_oracle:
        from same_tpu_torch.solver.milp_oracle import solve_mip_oracle

        prob = pw.problem
        slot_ref = prob.slot_ref
        limits = np.bincount(slot_ref[slot_ref >= 0], minlength=prob.n_ref)
        t0 = time.time()
        oracle = solve_mip_oracle(
            pw.valid_pairs, pw.pair_costs, prob.n_aligned, prob.n_ref,
            limits, float(pw.optim["penalty_coeff"]),
            np.asarray(prob.nm_cost[: prob.n_aligned], np.float64),
            triangles=pw.tris, tri_weights=pw.tri_weights,
            source_signs=pw.source_signs, ref_coords=pw.ref_coords,
            delaunay_penalty=args.dp, lazy_allowed_flip_fraction=0.0,
            max_outer_iters=200, mip_gap=0.001, time_limit=600.0,
        )
        t_oracle = time.time() - t0
        match_pair = np.full(prob.n_aligned, -1, np.int64)
        sel = oracle.x > 0.5
        for p in np.flatnonzero(sel):
            match_pair[pw.valid_pairs[p, 0]] = p
        flipped = flip_report(pw, oracle.match_ref, "milp-oracle  ")
        base, mip = objective_of(
            pw, oracle.match_ref, match_pair, args.dp, flipped
        )
        print(
            f"  objective={mip:.3f} (assignment {base:.3f}) "
            f"reported={oracle.objective:.3f} cuts={len(oracle.cuts)} "
            f"wall={t_oracle:.1f}s; {device_line}"
        )


if __name__ == "__main__":
    main()
