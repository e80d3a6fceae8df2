"""The benchmark's input generator: seeded, and the same metacells as the
port's collapse."""

import numpy as np
import pandas as pd

from port_bench import spec
from port_bench.gen import tissue

SMALL = dict(n_cells=2500, extent=4000, centers_per_type=6, query_keep=0.94, jitter=15)


def _config():
    return spec.load_json("configs", "luad_ms3_dp25.json")


def test_generator_is_deterministic_per_seed():
    a = tissue.make([2**33 + 5, 0], SMALL, _config())
    b = tissue.make([2**33 + 5, 0], SMALL, _config())
    c = tissue.make([2**33 + 5, 1], SMALL, _config())
    for x, y in zip(a, b):
        pd.testing.assert_frame_equal(x, y)
    assert len(a[1]) != len(c[1]) or not np.array_equal(a[1]["X"], c[1]["X"])


def test_grouping_gives_the_collapse_metacells():
    from same_tpu_torch import greedy_triangle_collapse

    _ref, (xy, types, probs) = tissue.make_cells([17, 0], 3000, 4500.0, 6, 0.94)
    cells = pd.DataFrame(xy, columns=["X", "Y"])
    cells["cell_type"] = np.asarray(tissue.LUAD_TYPES)[types]
    for k, name in enumerate(tissue.LUAD_TYPES):
        cells[name] = probs[:, k]
    cells["Cell_Num_Old"] = np.arange(len(cells))
    mc = greedy_triangle_collapse(
        cells, original_idx_col="Cell_Num_Old", max_metacell_size=3,
        r_max=250, min_angle_deg=15, return_object=True, verbose=False,
    ).metacell_df
    g_xy, g_types, g_probs, g_size = tissue.group_cells(xy, types, probs)
    assert len(g_xy) == len(mc)
    assert (g_size == 3).sum() == (mc["size"] == 3).sum()
    np.testing.assert_allclose(g_xy, mc[["X", "Y"]].to_numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(g_probs, mc[tissue.LUAD_TYPES].to_numpy(), atol=1e-9)
    assert list(np.asarray(tissue.LUAD_TYPES)[g_types]) == list(mc["cell_type"])


def test_window_counts_are_near_the_luad_window():
    """One window of the window mix: close to the collapse's counts for the
    drivers' LUAD window (10,681 aligned, 11,418 reference metacells)."""
    traffic = spec.load_json("traffic", "window.json")
    ref_df, aligned_df = tissue.make([3, 0], traffic, _config())
    assert abs(len(aligned_df) - 10681) < 0.03 * 10681
    assert abs(len(ref_df) - 11418) < 0.03 * 11418
    assert set(aligned_df["size"]) <= {1, 3}
