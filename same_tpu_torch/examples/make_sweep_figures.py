#!/usr/bin/env python
"""Regenerate the heart-sweep and robustness figure panels from artifacts.

Reads ``examples/results/heart_sweep_summary.csv`` (written by
run_parameter_sweep.py) and ``examples/results/heart_robustness.json``
(written by run_robustness.py) and renders the Fig 3c / S4-S7 style panels
into ``examples/figures/`` — the reference's supplementary-figure protocol
(reference examples/heart/run_parameter_sweep.sh, run_robustness.sh).

Usage: python -m same_tpu_torch.examples.make_sweep_figures [--results DIR] [--out DIR]
"""

import argparse
import json
import os
import sys

import matplotlib

matplotlib.use("Agg")
import pandas as pd

from same_tpu_torch.examples import REPO  # noqa: E402
from same_tpu_torch.viz import (  # noqa: E402
    plot_accuracy_violation_sweep,
    plot_knn_sweep,
    plot_ms_dp_heatmap,
    plot_noise_robustness,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=os.path.join(
        REPO, "examples", "results"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "examples", "figures"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    sweep_csv = os.path.join(args.results, "heart_sweep_summary.csv")
    if os.path.exists(sweep_csv):
        df = pd.read_csv(sweep_csv).drop_duplicates(
            subset=["dp", "knn", "ms"], keep="last"
        )
        knn_df = df[(df.ms == 1) & (df.dp == 5)]
        if len(knn_df) > 1:
            plot_knn_sweep(knn_df).savefig(
                os.path.join(args.out, "FigS4_knn_sweep.png"), dpi=150
            )
        ms1 = df[(df.knn == 8) & (df.ms == 1)].assign(
            accuracy_pct=lambda d: d.ct_accuracy * 100.0,
            violations_pct=lambda d: d.violation_frac * 100.0,
        )
        if len(ms1) > 1:
            plot_accuracy_violation_sweep(ms1).savefig(
                os.path.join(args.out, "Fig3c_dp_frontier.png"), dpi=150
            )
        grid = df[df.knn == 8]
        if grid.ms.nunique() > 1:
            plot_ms_dp_heatmap(grid, value="ct_accuracy").savefig(
                os.path.join(args.out, "FigS6_ms_dp_accuracy.png"), dpi=150
            )
            plot_ms_dp_heatmap(grid, value="violation_frac").savefig(
                os.path.join(args.out, "FigS7_ms_dp_violations.png"), dpi=150
            )
        print(f"sweep panels written from {sweep_csv}")
    else:
        print(f"no sweep summary at {sweep_csv}, skipping", file=sys.stderr)

    noise_json = os.path.join(args.results, "heart_robustness.json")
    if os.path.exists(noise_json):
        with open(noise_json) as f:
            noise = json.load(f)
        noise_df = pd.DataFrame(noise["runs"] if "runs" in noise else noise)
        plot_noise_robustness(noise_df).savefig(
            os.path.join(args.out, "FigS5_noise_robustness.png"), dpi=150
        )
        print(f"robustness panel written from {noise_json}")
    else:
        print(f"no robustness json at {noise_json}, skipping", file=sys.stderr)


if __name__ == "__main__":
    main()
