"""Port parity: the Sinkhorn warm start (kernel K4's plain version on the
CPU) against ``same_tpu.ops.sinkhorn``, and ``run_same`` with
``init_method="sinkhorn"`` against the JAX package.

The port sums a row's logsumexp and a ref's mass in a fixed order (the
kernel's), XLA in its own: duals and prices are compared to rtol 1e-4, atol
1e-5, and every row of the plan sums to 1 within 1e-4.
"""

import numpy as np
import pytest
import torch

import same_tpu
import same_tpu_torch
from same_tpu.models.assignment import build_assignment_problem as build_jax
from same_tpu.ops import sinkhorn as sj
from same_tpu_torch.kernels.sinkhorn_sparse import (
    ref_entry_lists, sinkhorn_sparse as k4, sinkhorn_sparse_plain,
)
from same_tpu_torch.models.assignment import build_assignment_problem
from same_tpu_torch.ops import sinkhorn as st
from torch_parity import WINDOW_SOLVER, as_np, labeled_window, run_window, sinkhorn_problem

# (seed, n, m, candidates per row, eps): tests/test_sinkhorn.py:30-48, :59-71.
INSTANCES = {"30x25": (1, 30, 25, 4, 1.0), "40x40": (2, 40, 40, 5, 0.5)}


def _tensors(pb):
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    return (t(pb.costs, torch.float32), t(np.clip(pb.cand_ref, 0, None), torch.int32),
            t(pb.valid, torch.bool), t(pb.nm_cost, torch.float32))


@pytest.mark.parametrize("name", list(INSTANCES))
def test_sinkhorn_sparse_matches_jax(name):
    import jax.numpy as jnp

    seed, n, m, per_row, eps = INSTANCES[name]
    pb = build_assignment_problem(*sinkhorn_problem(seed, n, m, per_row))
    assert pb.costs.shape[0] > n  # padded rows: no valid candidate
    plan_j, g_j = sj.sinkhorn_sparse(
        jnp.asarray(pb.costs), jnp.asarray(np.clip(pb.cand_ref, 0, None)),
        jnp.asarray(pb.valid), jnp.asarray(pb.nm_cost), n_ref=m, eps=eps,
    )
    plan_t, g_t = st.sinkhorn_sparse(*_tensors(pb), n_ref=m, eps=eps)
    plan_t, g_t = as_np(plan_t), as_np(g_t)
    assert plan_t.shape == np.asarray(plan_j).shape and plan_t.dtype == np.float32
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(plan_t, np.asarray(plan_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(plan_t.sum(1), 1.0, atol=1e-4)
    assert (g_t <= 0).all()
    # Invalid columns carry no mass; padded rows send all of theirs to the sink.
    assert (plan_t[:, :-1][~pb.valid] == 0).all()
    np.testing.assert_array_equal(plan_t[n:, -1], 1.0)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_sinkhorn_prices_match_jax(name):
    seed, n, m, per_row, eps = INSTANCES[name]
    args = sinkhorn_problem(seed, n, m, per_row)
    prices_j = sj.sinkhorn_prices(build_jax(*args), eps=eps, n_iters=100)
    pb = build_assignment_problem(*args)
    prices_t = st.sinkhorn_prices(pb, eps=eps, n_iters=100, device="cpu")
    assert prices_t.shape == prices_j.shape == (pb.n_slots + 1,)
    assert prices_t.dtype == prices_j.dtype
    np.testing.assert_allclose(prices_t, prices_j, rtol=1e-4, atol=1e-5)
    assert (prices_t >= 0).all() and prices_t[-1] == 0


def test_sinkhorn_prices_need_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pb = build_assignment_problem(*sinkhorn_problem(1, 30, 25, 4))
    with pytest.raises(RuntimeError, match="CUDA card"):
        st.sinkhorn_prices(pb)


def test_sinkhorn_dense_matches_jax():
    rng = np.random.default_rng(12345)
    n, m = 16, 20  # tests/test_sinkhorn.py:7-16
    cost = rng.uniform(0, 5, (n, m)).astype(np.float32)
    a = np.full(n, 1.0 / n, np.float32)
    b = np.full(m, 1.0 / m, np.float32)
    out_j = sj.sinkhorn_dense(cost, a, b, eps=0.05, n_iters=500)
    out_t = st.sinkhorn_dense(cost, a, b, eps=0.05, n_iters=500, device="cpu")
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)
    plan = as_np(out_t[0])
    assert np.allclose(plan.sum(0), b, atol=1e-3) and np.allclose(plan.sum(1), a, atol=1e-3)


def test_ref_entry_lists_are_sorted_by_ref_row_column():
    pb = build_assignment_problem(*sinkhorn_problem(3, 12, 7, 3))
    _costs, ref, valid, _nm = _tensors(pb)
    n, K = valid.shape
    ptr, ent = ref_entry_lists(ref.long(), valid, 7)
    assert ptr.dtype == ent.dtype == torch.int32
    assert int(ptr[0]) == 0 and int(ptr[-1]) == int(valid.sum()) == len(ent)
    seen = []
    for r in range(7):
        e = ent[int(ptr[r]):int(ptr[r + 1])].tolist()
        assert e == sorted(e)  # row-major: by row, then column
        for flat in e:
            i, k = divmod(flat, K + 1)
            assert k < K and valid[i, k] and int(ref[i, k]) == r
        seen += e
    assert len(set(seen)) == len(seen)


def test_wrapper_on_cpu_is_the_plain_version():
    pb = build_assignment_problem(*sinkhorn_problem(1, 30, 25, 4))
    out = k4(*_tensors(pb), n_ref=25, eps=0.7, n_iters=20)
    ref = sinkhorn_sparse_plain(*_tensors(pb), n_ref=25, eps=0.7, n_iters=20)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert k4.launches == 0  # a CPU tensor launches nothing


@pytest.fixture(scope="module")
def sinkhorn_windows():
    ref, qry = labeled_window()
    solver = dict(WINDOW_SOLVER, init_method="sinkhorn")
    return (run_window(same_tpu, ref, qry, solver_params=solver),
            run_window(same_tpu_torch, ref, qry, solver_params=solver))


def test_run_same_sinkhorn_start_matches_jax(sinkhorn_windows):
    (mj, vj), (mt, vt) = sinkhorn_windows
    assert vt["tpu"]["warm_start"]["method"] == "sinkhorn" == vj["tpu"]["warm_start"]["method"]
    assert len(mj) > 0.8 * 64
    assert list(zip(mt["aligned_idx"], mt["ref_idx"])) == list(zip(mj["aligned_idx"], mj["ref_idx"]))
    assert vt["tpu"]["objective"] == pytest.approx(vj["tpu"]["objective"], rel=1e-6)
    assert vt["tpu"]["tear_rounds"] == vj["tpu"]["tear_rounds"]
