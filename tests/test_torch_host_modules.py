"""Port parity of the small host modules the port copies from the JAX
package: ``synthetic``, ``io``, ``mesh_checks`` and ``robustness``. They hold
no device code, so the outputs are compared exactly.
"""

import numpy as np
import pandas as pd
import pytest

import same_tpu
import same_tpu_torch
from same_tpu import mesh_checks as mesh_jax
from same_tpu_torch import mesh_checks as mesh_torch
from torch_parity import labeled_window, run_window


def test_synthetic_benchmark_is_the_jax_packages():
    """The copy writes sklearn's RBF kernel out with scipy; the seed-8899
    tissue must still come out value for value."""
    got = same_tpu_torch.create_full_benchmark(seed=8899)
    want = same_tpu.create_full_benchmark(seed=8899)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if isinstance(w, pd.DataFrame):
            pd.testing.assert_frame_equal(g, w, check_exact=True)
        else:
            assert sorted(g) == sorted(w)
            for key in w:
                for name, value in w[key].items():
                    np.testing.assert_array_equal(g[key][name], value)


def test_load_matching_results_reads_a_window(tmp_path):
    ref, qry = labeled_window(n_side=5)
    matches, var_out = run_window(same_tpu_torch, ref, qry, outprefix=str(tmp_path))
    for loader in (same_tpu_torch.load_matching_results, same_tpu.load_matching_results):
        v, aligned_df, ref_df, m = loader(str(tmp_path))
        assert v["tpu"]["objective"] == var_out["tpu"]["objective"]
        assert len(aligned_df) > 0 and len(ref_df) > 0
        assert list(m["aligned_idx"]) == list(matches["aligned_idx"])
        assert list(m["ref_idx"]) == list(matches["ref_idx"])


@pytest.mark.parametrize("alpha", [None, 1.5])
def test_mesh_checks_match_jax(alpha):
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 10, (80, 2))
    tris_t = mesh_torch.compute_filtered_delaunay(pts, min_angle_deg=10, alpha=alpha)
    tris_j = mesh_jax.compute_filtered_delaunay(pts, min_angle_deg=10, alpha=alpha)
    np.testing.assert_array_equal(tris_t, tris_j)
    assert len(tris_t) > 0
    for name in ("find_min_angle_triangles", "check_mesh_orientation", "check_mesh_bounds"):
        got, want = getattr(mesh_torch, name)(pts, tris_t), getattr(mesh_jax, name)(pts, tris_t)
        if isinstance(want, dict):
            assert got == want
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("noise", [0.0, 0.3, 1.0])
def test_dirichlet_noise_matches_jax(noise):
    rng = np.random.default_rng(9)
    cols = ["a", "b", "c"]
    df = pd.DataFrame(rng.uniform(0, 100, (25, 3)), columns=cols)
    got = same_tpu_torch.add_dirichlet_mixture_noise(
        df, cols, noise, rng=np.random.default_rng(4))
    want = same_tpu.add_dirichlet_mixture_noise(
        df, cols, noise, rng=np.random.default_rng(4))
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    np.testing.assert_allclose(got[cols].sum(axis=1), 100.0)
    with pytest.raises(ValueError, match="noise must be"):
        same_tpu_torch.add_dirichlet_mixture_noise(df, cols, 1.5)
