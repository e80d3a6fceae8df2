"""Port parity of the tear-metrics and sparse Sinkhorn kernels' plain versions
on the CPU against the JAX package, on inputs made by numpy from a seed:

- K2 (``tear_metrics_plain`` through ``same_tpu_torch.solver.tearing.
  _tear_metrics``) against ``same_tpu.solver.tearing._tear_metrics``,
  ``checked``, ``flipped`` and ``vmove`` equal element for element, on rows
  with tied regrets (the first argmin decides), rows whose only valid
  columns share the held pair (the alternative is -nm), unmatched vertices
  and two columns a pair (max_matches = 2); each row's refs are its own, so
  no triangle has two vertices on one ref (ROADMAP C9). The row-regret step,
  ``row_regret_plain``, bit-equal to the fused loop's formula
  (same_tpu/solver/tearing_device.py:233-243) in jnp;
- K6 (``tear_metrics_batch_plain``) against ``jax.vmap(_tear_metrics)`` on a
  stack of 3 windows of different T, padded with tri_mask False and src 0;
- K4 (``sinkhorn_sparse_plain``) against ``same_tpu.ops.sinkhorn.
  sinkhorn_sparse`` at 0, 1 and 7 iterations, eps 0.05, on a problem with a
  ref that no candidate names and rows with no valid candidate. The port
  sums in a fixed order, XLA in its own: rtol 1e-4, atol 1e-5, as
  tests/test_torch_sinkhorn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from same_tpu.ops.sinkhorn import sinkhorn_sparse as sinkhorn_jax
from same_tpu.solver.tearing import _tear_metrics as tear_metrics_jax
from same_tpu_torch.kernels.sinkhorn_sparse import sinkhorn_sparse_plain
from same_tpu_torch.kernels.tear_metrics import row_regret_plain, tear_metrics_batch_plain
from same_tpu_torch.solver.tearing import _tear_metrics as tear_metrics_port

# The order of _tear_metrics' arguments.
K2_ARGS = ("costs", "extra", "slots", "valid", "nm", "pair_idx", "cand_ref", "tris",
           "tri_mask", "src", "ref_xy", "prices", "choice")
REGRET_ARGS = ("costs", "extra", "slots", "valid", "nm", "pair_idx", "cand_ref", "prices",
               "choice")


def k2_instance(kind, seed, n=64, C=8, T=160):
    """One window's K2 inputs as numpy arrays, with ``kind``'s corner."""
    rng = np.random.default_rng(seed)
    L = 2 if kind == "two_matches" else 1
    pairs = C // L
    S = 48
    # Small integer values: equal (cost + extra + price) sums, so tied regrets.
    costs = rng.integers(0, 4, (n, C)).astype(np.float32)
    extra = np.where(rng.random((n, C)) < 0.2, 1.0, 0.0).astype(np.float32)
    prices = rng.integers(0, 3, S + 1).astype(np.float32)
    if kind != "tied":
        costs += rng.random((n, C)).astype(np.float32)
        prices += rng.random(S + 1).astype(np.float32)
    prices[S] = 0.0
    valid = rng.random((n, C)) < 0.8
    slots = np.where(valid, rng.integers(0, S, (n, C)), S).astype(np.int32)
    # Column c of row i is pair c // L of the row; each row's refs its own.
    pair_idx = (np.arange(n)[:, None] * pairs + np.arange(C)[None, :] // L).astype(np.int32)
    cand_ref = pair_idx.copy()
    m = n * pairs
    nm = rng.uniform(4.0, 8.0, n).astype(np.float32)
    choice = np.where(valid, np.arange(C)[None, :], C).min(axis=1).astype(np.int32)
    if kind == "same_pair":
        # The first 16 rows: every column one pair, so no alternative outside it.
        pair_idx[:16] = pair_idx[:16, :1]
        cand_ref[:16] = cand_ref[:16, :1]
        valid[:16, 0] = True
        choice[:16] = 0
    if kind == "unmatched":
        choice[rng.random(n) < 0.4] = C
    tris = np.stack([rng.choice(n, 3, replace=False) for _ in range(T)]).astype(np.int32)
    src = rng.choice(np.array([-1, 0, 1], np.int32), T, p=[0.45, 0.1, 0.45])
    d = dict(costs=costs, extra=extra, slots=slots, valid=valid, nm=nm, pair_idx=pair_idx,
             cand_ref=cand_ref, tris=tris, tri_mask=rng.random(T) < 0.95, src=src,
             ref_xy=rng.uniform(-100, 100, (m, 2)).astype(np.float32), prices=prices,
             choice=choice)
    return d


def regret_jax(d):
    """The fused loop's regret (same_tpu/solver/tearing_device.py:233-243)
    and matched ref, in jnp."""
    costs, extra, slots, valid, nm, pair_idx, cand_ref, prices, choice = (
        jnp.asarray(d[k]) for k in REGRET_ARGS)
    n, C = costs.shape
    rows = jnp.arange(n)
    col = jnp.clip(choice, 0, C - 1)
    is_match = choice < C
    match_pair = jnp.where(is_match, pair_idx[rows, col], -1)
    p_slot = prices[slots]
    vals = jnp.where(valid, -(costs + extra + p_slot), -jnp.inf)
    held = jnp.where(is_match, vals[rows, col], -nm)
    alt_mask = valid & (pair_idx != match_pair[:, None])
    alt_best = jnp.maximum(jnp.max(jnp.where(alt_mask, vals, -jnp.inf), axis=1), -nm)
    return np.asarray(held - alt_best), np.asarray(jnp.where(is_match, cand_ref[rows, col], -1))


def torch_args(d, keys):
    return [torch.as_tensor(np.ascontiguousarray(d[k])) for k in keys]


@pytest.mark.parametrize("kind", ["tied", "same_pair", "unmatched", "two_matches"])
def test_tear_metrics_matches_jax(kind):
    d = k2_instance(kind, seed=["tied", "same_pair", "unmatched", "two_matches"].index(kind))
    want = tear_metrics_jax(*(jnp.asarray(d[k]) for k in K2_ARGS))
    got = tear_metrics_port(*torch_args(d, K2_ARGS))
    for name, g, w in zip(("checked", "flipped", "vmove"), got, want):
        assert g.dtype == (torch.int8 if name == "vmove" else torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    checked, flipped, vmove = (g.numpy() for g in got)
    assert checked.any() and flipped.any() and not checked[~d["tri_mask"]].any()

    regret, match_ref = row_regret_plain(*torch_args(d, REGRET_ARGS))
    want_regret, want_ref = regret_jax(d)
    np.testing.assert_array_equal(regret.numpy().view(np.int32), want_regret.view(np.int32))
    np.testing.assert_array_equal(match_ref.numpy(), want_ref)
    # The instance has its corner: tied minima over a triangle's vertices,
    # alternatives that are only the no-match value, unmatched vertices.
    tri_reg = regret.numpy()[d["tris"]]
    ties = (tri_reg == tri_reg.min(axis=1, keepdims=True)).sum(axis=1) > 1
    matched = d["choice"] < d["costs"].shape[1]
    if kind == "tied":
        assert ties.sum() >= 10 and (vmove[ties] == np.argmax(
            tri_reg[ties] == tri_reg[ties].min(axis=1, keepdims=True), axis=1)).all()
    if kind == "same_pair":
        nm = d["nm"][:16]
        held = -(d["costs"][:16, 0] + d["extra"][:16, 0] + d["prices"][d["slots"][:16, 0]])
        np.testing.assert_array_equal(regret.numpy()[:16], held + nm)
    if kind == "unmatched":
        assert 10 <= (~matched).sum() and (match_ref.numpy()[~matched] == -1).all()
    if kind == "two_matches":
        assert (d["pair_idx"][:, 0] == d["pair_idx"][:, 1]).all()


def test_tear_metrics_batch_matches_vmapped_jax():
    windows = [k2_instance(kind, seed=10 + b, T=T)
               for b, (kind, T) in enumerate((("tied", 120), ("unmatched", 160),
                                              ("two_matches", 90)))]
    T_pad = 176
    stack = {}
    for k in K2_ARGS:
        arrs = [w[k] for w in windows]
        if k in ("tris", "tri_mask", "src", "ref_xy"):
            # Zeros: tri_mask False, src 0; ref_xy to the largest m.
            size = max(a.shape[0] for a in arrs) if k == "ref_xy" else T_pad
            arrs = [np.pad(a, [(0, size - a.shape[0])] + [(0, 0)] * (a.ndim - 1))
                    for a in arrs]
        stack[k] = np.stack(arrs)
    want = jax.vmap(tear_metrics_jax)(*(jnp.asarray(stack[k]) for k in K2_ARGS))
    got = tear_metrics_batch_plain(*torch_args(stack, K2_ARGS))
    for name, g, w in zip(("checked", "flipped", "vmove"), got, want):
        assert tuple(g.shape) == (3, T_pad)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for b, w in enumerate(windows):
        T = w["tris"].shape[0]
        assert not got[0][b, T:].any()
        assert got[0][b, :T].any()


def sinkhorn_instance(seed=3, n=72, K=6, n_ref=50):
    """[n, K] candidates over n_ref refs; ref 17 has no candidate, the last 6
    rows no valid one."""
    rng = np.random.default_rng(seed)
    cand_ref = rng.integers(0, n_ref - 1, (n, K)).astype(np.int32)
    cand_ref[cand_ref >= 17] += 1
    cand_mask = rng.random((n, K)) < 0.75
    cand_mask[-6:] = False
    cand_cost = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    nm_cost = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return cand_cost, cand_ref, cand_mask, nm_cost, n_ref


@pytest.mark.parametrize("n_iters", [0, 1, 7])
def test_sinkhorn_sparse_plain_matches_jax(n_iters):
    cost, ref, mask, nm, n_ref = sinkhorn_instance()
    assert not (ref[mask] == 17).any() and (mask[:-6].any(axis=1)).all()
    plan_j, g_j = sinkhorn_jax(jnp.asarray(cost), jnp.asarray(ref), jnp.asarray(mask),
                               jnp.asarray(nm), n_ref=n_ref, eps=0.05, n_iters=n_iters)
    plan_t, g_t = sinkhorn_sparse_plain(
        *(torch.as_tensor(a) for a in (cost, ref, mask, nm)), n_ref, eps=0.05,
        n_iters=n_iters)
    plan_t, g_t = plan_t.numpy(), g_t.numpy()
    assert plan_t.shape == (72, 7) and g_t.shape == (n_ref,)
    np.testing.assert_allclose(g_t, np.asarray(g_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(plan_t, np.asarray(plan_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(plan_t.sum(1), 1.0, atol=1e-4)
    assert g_t[17] == 0.0 and (g_t <= 0).all()
    assert (g_t < 0).any() == (n_iters > 0)
    np.testing.assert_array_equal(plan_t[-6:, -1], 1.0)
    assert (plan_t[:, :-1][~mask] == 0).all()
