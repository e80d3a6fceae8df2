#!/usr/bin/env python
"""Synthetic 4-quadrant benchmark, end to end (reference Fig 2 workflow).

Mirrors the reference's examples/synthetic/run_same.sh parameterization:
MS=1 metacell pass (filtered Delaunay only), window=100/overlap=0 (here the
tissue fits one window), max_matches=2, radius=5, knn=8, dp configurable.

Usage: python -m same_tpu_torch.examples.run_synthetic [--dp 10] [--out results/synthetic]
"""

import argparse
import json
import os
import time

import numpy as np
import pandas as pd

from same_tpu_torch.examples import card


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=8899)
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--figures", action="store_true",
        help="write Fig-2-style panels (requires --out)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device to solve on (default: the first CUDA card; "
        "'cpu' runs the kernels' plain versions)",
    )
    args = ap.parse_args()
    device_line = card(args.device)

    from same_tpu_torch import (
        check_alignment,
        create_full_benchmark,
        greedy_triangle_collapse,
        run_same,
    )

    ref_df, query_df, quadrants, gt, _expr = create_full_benchmark(seed=args.seed)
    print(f"Benchmark: {len(ref_df)} template / {len(query_df)} query cells")

    mc_align = greedy_triangle_collapse(
        query_df, cell_type_col="cell_type", original_idx_col="cell_idx",
        x_col="X", y_col="Y", max_metacell_size=1, r_max=5, min_angle_deg=5,
        return_object=True,
    )

    ref_in = ref_df.copy()
    ref_in["metacell_id"] = np.arange(len(ref_in))
    t0 = time.time()
    matches, var_out = run_same(
        ref_df=ref_in,
        aligned_df=mc_align,
        commonCT=["c1", "c2", "c3"],
        optim_params=dict(
            max_matches=2, radius=5, knn=8, no_match_penalty=10000,
            dist_ct_coeff=1, min_angle_deg=5, penalty_coeff=100,
            delaunay_penalty=args.dp, cell_id_col="metacell_id",
            ref_metacell_match_multiplier=1, ignore_same_type_triangles=False,
        ),
        solver_params=dict(mip_gap=0.025, lazy_allowed_flip_fraction=0.0),
        outprefix=args.out, device=args.device,
    )
    elapsed = time.time() - t0

    acc = (
        query_df["cell_type"].to_numpy()[matches["Aligned_metacell_id"]]
        == ref_df["cell_type"].to_numpy()[matches["Ref_metacell_id"]]
    ).mean()
    mapped = matches.rename(columns={"ref_X": "X2", "ref_Y": "Y2"})
    mapped = mapped.assign(X=mapped["X2"], Y=mapped["Y2"])
    mapped["cell_type"] = query_df["cell_type"].to_numpy()[
        matches["Aligned_metacell_id"]
    ]
    _q, nn_score = check_alignment(mapped, ref_df, "X", "Y")

    print(
        json.dumps(
            {
                "matches": int(len(matches)),
                "query_cells": int(len(query_df)),
                "cell_type_accuracy": round(float(acc), 4),
                "one_nn_alignment": round(float(nn_score), 4),
                "violation_nodes": int(matches["triangle_violation"].sum()),
                "objective": var_out["tpu"]["objective"],
                "seconds": round(elapsed, 2),
                "device": device_line,
            },
            indent=2,
        )
    )

    # --- Per-quadrant evaluation (reference Fig 2 / S1 flow) ---------------
    from same_tpu_torch.synthetic import check_triangle_violations_within_quadrants

    qmatches = check_triangle_violations_within_quadrants(matches, mc_align)
    gt_map = dict(zip(gt["query_idx"], gt["ref_idx"]))
    rows = []
    quad_of_query = query_df["quadrant"].to_numpy()
    for name in ("top_left", "top_right", "bottom_right", "bottom_left"):
        sel = qmatches[quad_of_query[qmatches["Aligned_metacell_id"]] == name]
        n_quad = int((quad_of_query == name).sum())
        correct = sum(
            gt_map.get(int(a), -2) == int(r)
            for a, r in zip(sel["Aligned_metacell_id"], sel["Ref_metacell_id"])
        )
        rows.append(
            {
                "quadrant": name,
                "query_cells": n_quad,
                "matched": len(sel),
                "accuracy": round(correct / max(len(sel), 1), 4),
                "violation_frac": round(
                    float(sel["triangle_violation"].mean()) if len(sel) else 0.0,
                    4,
                ),
            }
        )
    per_quad = pd.DataFrame(rows)
    print("\nPer-quadrant results:")
    print(per_quad.to_string(index=False))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        per_quad.to_csv(os.path.join(args.out, "per_quadrant.csv"), index=False)

    if args.figures and args.out:
        import matplotlib

        matplotlib.use("Agg")
        from same_tpu_torch.viz import (
            plot_quadrant_summary,
            visualize_benchmark_v2,
            visualize_matches,
            visualize_space_tearing,
            visualize_topological_merger,
        )

        figs = {
            "benchmark": visualize_benchmark_v2(ref_df, query_df),
            "matches": visualize_matches(qmatches, ref_df=ref_df),
            "space_tearing": visualize_space_tearing(quadrants),
            "topological_merger": visualize_topological_merger(quadrants),
            "quadrant_summary": plot_quadrant_summary(per_quad),
        }
        for name, fig in figs.items():
            path = os.path.join(args.out, f"fig_{name}.png")
            fig.savefig(path, dpi=150)
            print(f"wrote {path}")


if __name__ == "__main__":
    main()
