"""Port parity: the auction (solver/auction.py) and _tear_metrics.

The instances are those of tests/test_auction.py:47-118. Each is solved by
the JAX package and by same_tpu_torch (the bidding round through K1's plain
twin), cold and warm-started, at obj_patience 0 and 128. ``choice``,
``rounds``, ``phase``, ``polish`` and ``owner`` must be identical; prices
agree to rtol 1e-6 and atol 1e-6 x the cost scale (both packages add the
same f32 values in the same order, so they agree bit for bit in practice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from same_tpu.models.assignment import build_assignment_problem
from same_tpu.solver import auction as ja
from same_tpu.solver.tearing import _tear_metrics as jax_tear_metrics
from same_tpu_torch.models.assignment import auction_state_from_numpy, to_device
from same_tpu_torch.solver import auction as ta
from same_tpu_torch.solver.tearing import _tear_metrics as torch_tear_metrics
from test_auction import _random_instance
from torch_parity import as_np, assert_bit_equal


def _inst_simple(rng):
    return _random_instance(rng)


def _inst_scarce(rng):
    return _random_instance(rng, n=40, m=15, k=6, nm=20.0, radius=6.0)


def _inst_two(rng):
    return _random_instance(rng, n=30, m=12, k=5, max_matches=2, nm=30.0, radius=6.0)


def _inst_dense(rng):
    n = m = 20
    cost_mat = rng.uniform(0, 10, (n, m))
    pairs = np.array([(i, j) for i in range(n) for j in range(m)])
    return pairs, cost_mat.ravel(), n, m, np.ones(m, dtype=int), np.full(n, 1e5)


def _inst_all_nm(rng):
    pairs = np.array([(0, 0), (1, 0)])
    return pairs, np.array([10.0, 12.0]), 2, 1, np.array([1]), np.array([1.0, 1.0])


def _inst_metacell(rng):
    pairs = np.array([(0, 0), (1, 0), (2, 0)])
    return pairs, np.array([1.0, 1.0, 1.0]), 3, 1, np.array([3]), np.full(3, 1000.0)


INSTANCES = {
    "simple": (_inst_simple, 100.0, 1e-3),
    "scarce": (_inst_scarce, 100.0, 1e-3),
    # At eps 1e-3 this congestion instance takes ~210k rounds without the
    # stall stop; 3e-2 keeps it to ~3k rounds.
    "max_matches_two": (_inst_two, 10.0, 3e-2),
    "dense": (_inst_dense, 100.0, 1e-4),
    "all_no_match": (_inst_all_nm, 100.0, 1e-2),
    "metacell_capacity": (_inst_metacell, 5.0, 1e-2),
}


def _problem(name):
    make, penalty, eps_final = INSTANCES[name]
    pairs, costs, n, m, limits, nm = make(np.random.default_rng(0))
    return build_assignment_problem(pairs, costs, n, m, limits, penalty, nm), eps_final


def _cost_scale(problem):
    finite = problem.costs[problem.valid]
    return max(float(np.max(problem.nm_cost)), float(np.ptp(finite)) if finite.size else 1.0)


def _assert_same_result(got, want, problem):
    np.testing.assert_array_equal(as_np(got.choice), np.asarray(want.choice))
    np.testing.assert_array_equal(as_np(got.owner), np.asarray(want.owner))
    assert got.rounds == int(want.rounds)
    assert got.phase == int(want.phase)
    assert got.polish == int(want.polish)
    np.testing.assert_allclose(
        as_np(got.prices), np.asarray(want.prices),
        rtol=1e-6, atol=1e-6 * _cost_scale(problem),
    )


def _jax_run(problem, costs, prices, sched, max_rounds, patience, eps_final,
             assigned0=None, owner0=None):
    obj = ja.natural_stop_args(problem.costs.shape[0], eps_final, patience)
    return ja._auction_run(
        jnp.asarray(costs), jnp.asarray(problem.slots), jnp.asarray(problem.valid),
        jnp.asarray(problem.nm_cost), jnp.asarray(prices), jnp.asarray(sched),
        max_rounds=max_rounds,
        assigned0=None if assigned0 is None else jnp.asarray(assigned0),
        owner0=None if owner0 is None else jnp.asarray(owner0),
        slot_rows=jnp.asarray(problem.slot_rows),
        slot_cols=jnp.asarray(problem.slot_cols),
        obj_patience=obj[0], obj_tol=obj[1], obj_band=obj[2],
    )


def _torch_run(problem, costs, state, sched, max_rounds, patience, eps_final,
               warm=True):
    pd = to_device(problem, "cpu")
    obj = ta.natural_stop_args(problem.costs.shape[0], eps_final, patience)
    return ta._auction_run(
        torch.as_tensor(costs), pd.slots, pd.valid, pd.nm_cost, state.prices,
        sched, max_rounds=max_rounds,
        assigned0=state.assigned if warm else None,
        owner0=state.owner if warm else None,
        slot_rows=pd.slot_rows, slot_cols=pd.slot_cols,
        obj_patience=obj[0], obj_tol=obj[1], obj_band=obj[2],
    )


@pytest.mark.parametrize("patience", [0, 128])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_solve_assignment_cold(name, patience):
    problem, eps_final = _problem(name)
    want = ja.solve_assignment(
        problem, eps_final=eps_final, return_raw=True, obj_patience=patience
    )
    got = ta.solve_assignment(
        problem, eps_final=eps_final, return_raw=True, obj_patience=patience
    )
    _assert_same_result(got, want, problem)
    # The decoded matching agrees as well.
    mr_j, mp_j, info_j = ja.solve_assignment(problem, eps_final=eps_final, obj_patience=patience)
    mr_t, mp_t, info_t = ta.solve_assignment(problem, eps_final=eps_final, obj_patience=patience)
    np.testing.assert_array_equal(mr_t, mr_j)
    np.testing.assert_array_equal(mp_t, mp_j)
    assert info_t["rounds"] == info_j["rounds"]


@pytest.mark.parametrize("patience", [0, 128])
@pytest.mark.parametrize("name", list(INSTANCES))
def test_auction_warm_started(name, patience):
    """A JAX solve's end state, handed across, re-solved after a surcharge."""
    problem, eps_final = _problem(name)
    cold = ja.solve_assignment(
        problem, eps_final=eps_final, return_raw=True, obj_patience=patience
    )
    # Surcharge a few held pairs, as a tear round does, and re-solve warm.
    rng = np.random.default_rng(1)
    extra = np.zeros_like(problem.costs)
    choice = np.asarray(cold.choice)
    C = problem.costs.shape[1]
    held = np.flatnonzero(choice < C)
    for v in rng.permutation(held)[:4]:
        extra[v, choice[v]] += 7.5
    costs = problem.costs + extra
    sched = ja.warm_eps_schedule(eps_final, 7.5, _cost_scale(problem))
    want = _jax_run(
        problem, costs, cold.prices, sched, 5000, patience, eps_final,
        assigned0=cold.choice, owner0=cold.owner,
    )
    state = auction_state_from_numpy(cold.prices, cold.owner, cold.choice)
    got = _torch_run(problem, costs, state, sched, 5000, patience, eps_final)
    _assert_same_result(got, want, problem)


@pytest.mark.parametrize("name", ["scarce", "max_matches_two"])
def test_bid_rounds_step_for_step(name):
    """After every round count k the two loops hold the same state.

    ``max_rounds`` is a traced argument of the JAX loop, so the sweep costs
    one compile; each k ends with the same final placement passes.
    """
    problem, eps_final = _problem(name)
    sched = ja.default_eps_schedule(problem, eps_final)
    S = problem.n_slots
    prices0 = np.zeros(S + 1, np.float32)
    state = auction_state_from_numpy(
        prices0, np.full(S + 1, -1), np.full(problem.costs.shape[0], -1)
    )
    total = int(
        ja.solve_assignment(problem, eps_final=eps_final, obj_patience=128)[2]["rounds"]
    )
    for k in list(range(1, 31)) + [total // 2, total]:
        want = _jax_run(problem, problem.costs, prices0, sched, k, 128, eps_final)
        got = _torch_run(problem, problem.costs, state, sched, k, 128, eps_final, warm=False)
        _assert_same_result(got, want, problem)
        assert_bit_equal(got.prices, want.prices, f"prices after {k} rounds")


def test_tear_metrics_bit_equal():
    """_tear_metrics: checked, flipped and vmove bit-equal to JAX."""
    from test_tearing import _swap_instance

    rng = np.random.default_rng(0)
    pairs, costs, n, limits, nm, tris, w, src, ref_xy = _swap_instance(rng, n_swaps=3)
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)
    raw = ja.solve_assignment(problem, eps_final=1e-3, return_raw=True)
    extra = np.zeros_like(problem.costs)
    extra[rng.random(extra.shape) < 0.2] = 15.0
    ref32 = np.asarray(ref_xy, np.float32)
    T = len(tris)
    want = jax_tear_metrics(
        jnp.asarray(problem.costs), jnp.asarray(extra), jnp.asarray(problem.slots),
        jnp.asarray(problem.valid), jnp.asarray(problem.nm_cost),
        jnp.asarray(problem.pair_idx), jnp.asarray(problem.cand_ref),
        jnp.asarray(tris), jnp.ones(T, bool), jnp.asarray(src),
        jnp.asarray(ref32), raw.prices, raw.choice,
    )
    pd = to_device(problem, "cpu")
    got = torch_tear_metrics(
        pd.costs, torch.as_tensor(extra), pd.slots, pd.valid, pd.nm_cost,
        pd.pair_idx, pd.cand_ref, torch.as_tensor(tris, dtype=torch.int32),
        torch.ones(T, dtype=torch.bool), torch.as_tensor(src, dtype=torch.int32),
        torch.as_tensor(ref32), torch.as_tensor(np.array(raw.prices)),
        torch.as_tensor(np.array(raw.choice)),
    )
    for g, wnt, name in zip(got, want, ("checked", "flipped", "vmove")):
        assert_bit_equal(g, np.asarray(wnt), name)
    assert got[0].any() and got[1].any() and (got[2] != 0).any()
