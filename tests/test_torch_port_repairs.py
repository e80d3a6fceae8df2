"""Port repairs, each held to the JAX package on the CPU.

- The plain kNN's distances are correctly rounded f32 square roots (the
  square root is taken in float64 and rounded once), as XLA's, numpy's and
  K3's are.
- The kNN takes any k: k = 65, beyond the kernel's one-pass list of 64,
  against ``radius_knn_tpu`` under test_torch_pairwise.py's rule.
- The host separation loop adds a round's surcharge deltas in list order, as
  the JAX host loop does: at dp = 0.1 with a vertex that is the cheapest to
  move of two cut triangles, every ``extra`` handed to the auction is
  bit-equal to JAX's.
- ``same_tpu_torch.instances.make_instance`` is ``bench.make_instance``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import same_tpu.solver.tearing as jax_tearing
import same_tpu_torch.solver.tearing as torch_tearing
from same_tpu.models.assignment import build_assignment_problem
from same_tpu.ops.pairwise import radius_knn_tpu
from same_tpu_torch.kernels.radius_knn import radius_knn_plain
from test_tearing import _swap_instance
from torch_parity import as_np, capture_finish, knn_points


@pytest.mark.parametrize("unbounded", [False, True], ids=["radius", "nearest"])
def test_knn_plain_distances_are_correctly_rounded(unbounded):
    qry, ref, radius, k = knn_points("ties")
    if unbounded:  # test_nearest_neighbors_device_matches_jax's call
        radius, k = float("inf"), 3
    idx, dist, mask = (as_np(a) for a in radius_knn_plain(
        torch.as_tensor(qry), torch.as_tensor(ref), radius, k))
    # On the half-integer lattice the squared distances are exact in f32.
    d2 = ((qry[:, None, :].astype(np.float64)
           - ref[np.clip(idx, 0, None)].astype(np.float64)) ** 2).sum(-1)
    want = np.sqrt(d2).astype(np.float32)
    assert mask.any()
    np.testing.assert_array_equal(dist[mask].view(np.int32), want[mask].view(np.int32))
    if unbounded:  # sqrt(37) = 6.0827627, one ulp above torch's f32 CPU sqrt
        assert np.isin(37.0, d2[mask])


def test_knn_takes_k_beyond_the_one_pass_list():
    rng = np.random.default_rng(65)
    qry = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    ref = rng.uniform(0, 10, (150, 2)).astype(np.float32)
    radius, k = 5.0, 65
    ij, dj, mj = (np.asarray(a) for a in radius_knn_tpu(qry, ref, radius, k))
    it, dt, mt = (as_np(a) for a in radius_knn_plain(
        torch.as_tensor(qry), torch.as_tensor(ref), radius, k))
    assert it.shape == (len(qry), k)
    assert mt.all(axis=1).any() and (~mt).any(axis=1).any()  # full and short rows
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(it[~mt], -1)
    assert np.isinf(dt[~mt]).all()
    diff = (it != ij) & mt
    np.testing.assert_allclose(dt[diff], dj[diff], atol=1e-4)
    np.testing.assert_allclose(dt[mt] ** 2, dj[mt] ** 2, rtol=0, atol=1e-4)
    for i in range(len(qry)):
        d, j = dt[i][mt[i]], it[i][mt[i]]
        assert (np.diff(d) >= 0).all()
        assert (np.diff(j)[np.diff(d) == 0] > 0).all()


def test_host_loop_surcharges_in_list_order(monkeypatch):
    rng = np.random.default_rng(0)
    pairs, costs, n, limits, nm, tris, _w, src, ref_xy = _swap_instance(
        rng, n_side=6, n_swaps=4)
    # Unequal triangle weights at dp = 0.1: non-dyadic surcharges whose f32
    # sum on one cell depends on the order of the adds.
    w = np.random.default_rng(3).uniform(1.0, 5.0, len(tris))
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)

    deltas = []
    orig_add = torch_tearing.add_in_list_order

    def spy_add(extra, rows, cols, vals):
        deltas.append((list(rows), list(cols), list(vals)))
        return orig_add(extra, rows, cols, vals)

    monkeypatch.setattr(torch_tearing, "add_in_list_order", spy_add)
    extras, calls = {}, {}
    for name, module, dev in (
        ("jax", jax_tearing, {}), ("torch", torch_tearing, {"device": "cpu"}),
    ):
        seen = extras[name] = []
        orig = module.solve_assignment

        def spy(*a, _orig=orig, _seen=seen, **kw):
            extra = kw.get("extra_costs")
            _seen.append(None if extra is None else np.array(extra, np.float32))
            return _orig(*a, **kw)

        monkeypatch.setattr(module, "solve_assignment", spy)
        calls[name] = capture_finish(monkeypatch, module)
        module.solve_with_tearing(
            problem, costs, tris, w, src, ref_xy, delaunay_penalty=0.1,
            penalty_coeff=100.0, allowed_flip_fraction=0.0, eps_final=1e-3,
            device_loop=False, repair_budget=120.0, **dev,
        )
    assert calls["torch"][-1]["cut_tris"] == calls["jax"][-1]["cut_tris"]
    # The instance is one where the order shows: some round adds several
    # different surcharges to one cell, and adding each round's deltas in
    # reverse order gives other bits.
    fwd = np.zeros_like(extras["jax"][-1])
    rev = fwd.copy()
    for rows, cols, vals in deltas:
        orig_add(fwd, rows, cols, vals)
        orig_add(rev, rows[::-1], cols[::-1], vals[::-1])
    assert (fwd.view(np.int32) != rev.view(np.int32)).any()
    assert len(extras["torch"]) == len(extras["jax"]) >= 3
    for r, (a, b) in enumerate(zip(extras["torch"], extras["jax"])):
        assert (a is None) == (b is None), f"solve {r}"
        if a is not None:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f"solve {r}")


def test_make_instance_is_bench_make_instance():
    from bench import make_instance as jax_side
    from same_tpu_torch.instances import make_instance

    for want, got in zip(jax_side(n_cells=400, seed=5), make_instance(n_cells=400, seed=5)):
        if isinstance(want, pd.DataFrame):
            pd.testing.assert_frame_equal(got, want, check_exact=True)
        else:
            assert got == want
