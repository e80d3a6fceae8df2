"""The twins of tests/test_viz.py on ``same_tpu_torch.viz``, the port's copy
of ``same_tpu/viz.py``: every public plotter renders on tiny inputs without
error."""

import numpy as np
import pandas as pd
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from same_tpu_torch import viz  # noqa: E402


@pytest.fixture
def tissue():
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6)), -1).reshape(-1, 2) * 2.0
    types = np.asarray(["A", "B", "C"])[np.arange(len(g)) % 3]

    def frame(seed):
        df = pd.DataFrame(
            g + rng.normal(0, 0.1, g.shape), columns=["X", "Y"]
        )
        df["cell_type"] = types
        return df

    return frame(1), frame(2)


def _close(fig):
    assert fig is not None
    plt.close(fig)


def test_benchmark_panels(tissue):
    ref, qry = tissue
    _close(viz.visualize_benchmark(ref, qry))
    _close(viz.visualize_benchmark_v2(ref, qry))


def test_match_and_triangulation_panels(tissue):
    ref, qry = tissue
    matches = pd.DataFrame(
        {
            "X": qry["X"][:10],
            "Y": qry["Y"][:10],
            "ref_X": ref["X"][:10],
            "ref_Y": ref["Y"][:10],
            "cell_type": qry["cell_type"][:10],
            "triangle_violation": [False] * 9 + [True],
        }
    )
    _close(viz.visualize_matches(matches, ref, qry))
    _close(viz.plot_match_lines(matches, ref))
    tris = np.array([[0, 1, 2], [1, 2, 3]])
    _close(
        viz.visualize_triangulation(
            qry[["X", "Y"]].to_numpy(), tris, flipped=np.array([False, True])
        )
    )


def test_sweep_panels():
    sweep = pd.DataFrame(
        {
            "dp": [0, 5, 10, 25],
            "knn": [8, 8, 8, 8],
            "ms": [1, 1, 1, 1],
            "ct_accuracy": [0.72, 0.71, 0.70, 0.67],
            "violation_frac": [0.5, 0.4, 0.3, 0.1],
        }
    )
    _close(viz.plot_knn_sweep(sweep.assign(knn=[1, 4, 8, 10])))
    _close(
        viz.plot_accuracy_violation_sweep(
            sweep.assign(
                accuracy_pct=sweep.ct_accuracy * 100,
                violations_pct=sweep.violation_frac * 100,
            )
        )
    )
    grid = pd.concat([sweep.assign(ms=m) for m in (1, 3, 7)])
    _close(viz.plot_ms_dp_heatmap(grid, value="ct_accuracy"))
    _close(viz.plot_ms_dp_heatmap(grid, value="violation_frac"))


def test_noise_panel():
    noise = pd.DataFrame(
        {"noise": [0.0, 0.5, 1.0], "accuracy_pct": [71.0, 63.0, 55.0]}
    )
    _close(viz.plot_noise_robustness(noise, baseline_pct=57.6))


def test_window_grid_panel():
    matches = pd.DataFrame(
        {
            "X": np.random.default_rng(0).uniform(0, 10, 30),
            "Y": np.random.default_rng(1).uniform(0, 10, 30),
            "window_id": np.arange(30) % 4,
        }
    )
    _close(viz.plot_window_grid(matches))
