#!/usr/bin/env python
"""Parameter sweep harness: knn x MS x dp grids over a dataset.

Reproduces the reference's ISS-heart sweep protocol
(reference examples/heart/run_parameter_sweep.sh:15-27):

  kNN sweep : knn in {1, 2, 4, 6, 8, 10} at dp=5, MS=1       (Fig S4)
  MS/dp grid: MS in {1, 3, 7} x dp in {0, 1, 5, 10, 25, 50}  (Fig S5-S7)

Each run goes through run_dataset.py's loader + pipeline and
appends one summary row (matches, CT accuracy, violation %, wall-clock) to
``<out>/sweep_summary.csv`` so interrupted sweeps resume where they left
off.

Usage:
  python -m same_tpu_torch.examples.run_parameter_sweep heart --data DIR --out OUT \
      [--sweep knn|msdp|both] [--mesh N]
"""

import argparse
import os
import time

import pandas as pd

from same_tpu_torch.examples import card
from same_tpu_torch.examples.run_dataset import LOADERS


def run_one(dataset, data_dir, out_dir, dp, knn, ms, mesh_devices=None,
            device=None):
    from same_tpu_torch import (
        check_alignment,
        greedy_triangle_collapse,
        merge_window_matches_unique_ref,
        sliding_window_matching,
        unpack_metacell_matches,
    )

    ref, align, common, cfg = LOADERS[dataset](data_dir)
    mc_align = greedy_triangle_collapse(
        align, cell_type_col="cell_type", original_idx_col=cfg["id_col"],
        x_col="X", y_col="Y", max_metacell_size=ms, r_max=cfg["r_max"],
        min_angle_deg=15, use_alpha_shape=False, return_object=True,
    )
    mc_ref = greedy_triangle_collapse(
        ref, cell_type_col="cell_type", original_idx_col=cfg["id_col"],
        x_col="X", y_col="Y", max_metacell_size=ms, r_max=cfg["r_max"],
        min_angle_deg=15, use_alpha_shape=False, return_object=True,
    )
    optim = dict(
        window_size=cfg["window_size"], overlap=cfg["overlap"],
        min_cells_per_window=30, max_matches=1, radius=cfg["radius"],
        knn=knn, no_match_penalty=10000, dist_ct_coeff=1, penalty_coeff=100,
        delaunay_penalty=dp, cell_id_col="metacell_id",
        ref_metacell_match_multiplier=ms,
    )
    solver = dict(mip_gap=0.05, lazy_allowed_flip_fraction=0.05)

    mesh = None
    if mesh_devices:
        from same_tpu_torch.parallel import make_mesh

        mesh = make_mesh(mesh_devices)

    run_out = os.path.join(out_dir, f"dp{dp}_knn{knn}_ms{ms}")
    t0 = time.time()
    matches = sliding_window_matching(
        mc_ref, mc_align, outprefix=run_out,
        optim_params=optim, solver_params=solver, mesh=mesh, verbose=False,
        device=device,
    )
    elapsed = time.time() - t0
    merged = merge_window_matches_unique_ref([matches], cell_id_col="metacell_id")

    # Unpack to individual cells and score 1-NN cell-type accuracy against
    # the template at the matched positions (reference notebooks' flow).
    unpacked = unpack_metacell_matches(merged, mc_align, mc_ref, strategy="nearest")
    a_idx = align.set_index(cfg["id_col"])
    r_idx = ref.set_index(cfg["id_col"])
    moved = pd.DataFrame(
        {
            "X": r_idx.loc[unpacked["Ref_cell_id"], "X"].to_numpy(),
            "Y": r_idx.loc[unpacked["Ref_cell_id"], "Y"].to_numpy(),
            "cell_type": a_idx.loc[
                unpacked["Aligned_cell_id"], "cell_type"
            ].to_numpy(),
        }
    )
    _scored, accuracy = check_alignment(moved, ref, "X", "Y", "cell_type")
    return {
        "dataset": dataset, "dp": dp, "knn": knn, "ms": ms,
        "matches": len(merged), "unpacked": len(unpacked),
        "ct_accuracy": accuracy,
        "violation_frac": float(merged["triangle_violation"].mean()),
        "runtime_s": round(elapsed, 1),
        "device": card(device),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=sorted(LOADERS))
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--sweep", choices=["knn", "msdp", "both"], default="both")
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard windows over N devices")
    ap.add_argument(
        "--device", default=None,
        help="torch device to solve on (default: the first CUDA card; "
        "'cpu' runs the kernels' plain versions)",
    )
    args = ap.parse_args()
    card(args.device)

    grid = []
    if args.sweep in ("knn", "both"):
        grid += [(5, k, 1) for k in (1, 2, 4, 6, 8, 10)]
    if args.sweep in ("msdp", "both"):
        grid += [(dp, 8, ms) for ms in (1, 3, 7) for dp in (0, 1, 5, 10, 25, 50)]

    os.makedirs(args.out, exist_ok=True)
    summary_path = os.path.join(args.out, "sweep_summary.csv")
    done = set()
    if os.path.exists(summary_path):
        prev = pd.read_csv(summary_path)
        done = set(zip(prev["dp"], prev["knn"], prev["ms"]))
        rows = prev.to_dict("records")
    else:
        rows = []

    for dp, knn, ms in grid:
        if (dp, knn, ms) in done:
            print(f"skip dp={dp} knn={knn} ms={ms} (done)")
            continue
        print(f"run dp={dp} knn={knn} ms={ms}")
        rows.append(run_one(args.dataset, args.data, args.out, dp, knn, ms,
                            mesh_devices=args.mesh, device=args.device))
        pd.DataFrame(rows).to_csv(summary_path, index=False)
    print(pd.DataFrame(rows).to_string(index=False))


if __name__ == "__main__":
    main()
