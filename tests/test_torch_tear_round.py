"""Port parity: the rest of a tear round, K7 ``tear_scalars`` and K8
``register_cuts``, by their plain versions on the CPU.

A jnp transcription of ``same_tpu/solver/tearing_device.py:146-160`` (the
stop rule's six values) and ``:209-254`` (cut registration and surcharge),
held here and run window by window on JAX's CPU backend, against the port's
plain versions on [b, ...] stacks of the same numpy inputs:

- registration: ``cut_mem``, ``cut_cnt``, ``extra`` and the cuts added are
  bit-equal, on windows with dp = 0.1 surcharges (not exact in f32) on
  duplicate (vertex, column) targets, a column block clamped at C - 1, full
  dedup memories, and the per-round and total caps;
- the six values: the counts and the congestion overflow are equal; the
  three float sums agree to rel 1e-6, because the port adds in the kernel's
  fixed order and XLA in its own; a window's values are bit-equal alone and
  in a zero-padded batch;
- the fused loop of both packages at tight cut caps and a small memory:
  identical per-round data and cut registries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from same_tpu.models.assignment import build_assignment_problem
from same_tpu_torch.kernels.tear_round import (
    fixed_order_sum,
    register_cuts,
    register_cuts_plain,
    synthetic_round_state,
    tear_scalars,
    tear_scalars_plain,
)
from test_tearing import _swap_instance

import torch_parity  # noqa: F401  (one torch thread per xdist worker)


def jax_scalars(costs, nm, choice, cand_ref, m_ref, flipped, checked, tw, tri_mask, src):
    """tearing_device.py:146-160 on one window: the six raw values."""
    n, C = costs.shape
    rows = jnp.arange(n)
    col = jnp.clip(choice, 0, C - 1)
    is_match = choice < C
    match_ref = jnp.where(is_match, cand_ref[rows, col], -1)
    base_cost = jnp.sum(jnp.where(is_match, costs[rows, col], nm).astype(jnp.float32))
    u_ref = jnp.zeros(m_ref, jnp.float32).at[
        jnp.clip(match_ref, 0, m_ref - 1)
    ].add(jnp.where(is_match, 1.0, 0.0))
    over = jnp.sum(jnp.maximum(u_ref - 1.0, 0.0))
    flip_w = jnp.sum(jnp.where(flipped, tw, 0.0))
    checkable_w = jnp.sum(jnp.where(tri_mask & (src != 0), tw, 0.0))
    return np.array([base_cost, over, flip_w, checkable_w, checked.sum(), flipped.sum()],
                    np.float32)


def jax_register(tris, surcharge, choice, pair_idx, flipped, vmove, register, cuts_added,
                 cut_mem, cut_cnt, extra, L, K, max_cuts_per_round, max_cuts_total):
    """tearing_device.py:209-254 on one window; returns the new
    (cut_mem, cut_cnt, extra, added)."""
    n, C = extra.shape
    T = tris.shape[0]
    rows = jnp.arange(n)
    tri_ids = jnp.arange(T)
    col = jnp.clip(choice, 0, C - 1)
    is_match = choice < C
    match_pair = jnp.where(is_match, pair_idx[rows, col], -1)
    tri_pairs = match_pair[tris]
    all_matched = jnp.all(tri_pairs >= 0, axis=1)
    is_dup = jnp.any(jnp.all(cut_mem == tri_pairs[:, None, :], axis=2), axis=1)
    can_store = cut_cnt < K
    new_cut = flipped & all_matched & ~is_dup & can_store & register
    rank = jnp.cumsum(new_cut.astype(jnp.int32)) - 1
    new_cut = new_cut & (rank < max_cuts_per_round) & (cuts_added + rank < max_cuts_total)
    added = new_cut.sum()
    store_k = jnp.where(new_cut, cut_cnt, K)
    cut_mem = cut_mem.at[tri_ids, jnp.clip(store_k, 0, K - 1)].set(
        jnp.where(new_cut[:, None], tri_pairs, cut_mem[tri_ids, jnp.clip(store_k, 0, K - 1)])
    )
    cut_cnt = cut_cnt + new_cut.astype(jnp.int32)
    v_t = tris[tri_ids, vmove]
    col_t = jnp.clip(choice[jnp.clip(v_t, 0, n - 1)], 0, C - 1)
    blk_t = (col_t // L) * L
    upd = jnp.where(new_cut, surcharge, 0.0)
    v_safe = jnp.where(new_cut, v_t, n - 1)
    for s in range(L):
        extra = extra.at[v_safe, jnp.clip(blk_t + s, 0, C - 1)].add(jnp.where(new_cut, upd, 0.0))
    return np.asarray(cut_mem), np.asarray(cut_cnt), np.asarray(extra), int(added)


def stack(ws, key):
    return torch.as_tensor(np.stack([w[key] for w in ws]))


CASES = {
    # Duplicate targets with dp = 0.1, C = 7 and L = 3: the third block's
    # columns 7 and 8 clamp onto column 6; no cap binds.
    "duplicates_clamp_full_memory": dict(
        L=3, K=2, max_cuts_per_round=1000, max_cuts_total=1 << 30,
        register=[True, True, False], cuts_added=[0, 5, 0]),
    # The per-round cap binds in window 0, the total cap in window 1.
    "both_caps": dict(
        L=3, K=2, max_cuts_per_round=4, max_cuts_total=20,
        register=[True, True, True], cuts_added=[0, 18, 3]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_register_cuts_plain_matches_jax(case):
    cfg = CASES[case]
    rng = np.random.default_rng(5)
    ws = [synthetic_round_state(rng) for _ in range(3)]
    L, K = cfg["L"], cfg["K"]
    caps = dict(max_cuts_per_round=cfg["max_cuts_per_round"],
                max_cuts_total=cfg["max_cuts_total"])
    state = {k: stack(ws, k) for k in ("cut_mem", "cut_cnt", "extra")}
    want = [(w["cut_mem"], w["cut_cnt"], w["extra"]) for w in ws]
    for _round in range(2):  # the second round finds its cuts in memory
        added = register_cuts_plain(
            stack(ws, "tris"), stack(ws, "surcharge"), stack(ws, "choice"),
            stack(ws, "pair_idx"), stack(ws, "flipped"), stack(ws, "vmove"),
            np.asarray(cfg["register"]), np.asarray(cfg["cuts_added"]),
            state["cut_mem"], state["cut_cnt"], state["extra"], L=L, K=K, **caps)
        for b, w in enumerate(ws):
            mem, cnt, extra, n_added = jax_register(
                jnp.asarray(w["tris"]), jnp.asarray(w["surcharge"]),
                jnp.asarray(w["choice"]), jnp.asarray(w["pair_idx"]),
                jnp.asarray(w["flipped"]), jnp.asarray(w["vmove"]).astype(jnp.int32),
                bool(cfg["register"][b]), int(cfg["cuts_added"][b]),
                jnp.asarray(want[b][0]), jnp.asarray(want[b][1]),
                jnp.asarray(want[b][2]), L, K, **caps)
            want[b] = (mem, cnt, extra)
            assert int(added[b]) == n_added, (case, _round, b)
            np.testing.assert_array_equal(state["cut_mem"][b].numpy(), mem)
            np.testing.assert_array_equal(state["cut_cnt"][b].numpy(), cnt)
            np.testing.assert_array_equal(state["extra"][b].numpy().view(np.int32),
                                          extra.view(np.int32))
        if _round == 0:
            first = added.clone()
    assert int(first[0]) > 0
    if case == "both_caps":
        assert first.tolist() == [4, 2, 4]
    else:
        assert int(first[2]) == 0  # a window that does not register


def test_surcharge_order_is_jax_order():
    """The instance has (vertex, column) targets whose f32 sum depends on the
    order of the cuts: the plain version's extra differs from the cuts
    applied in reverse, and equals the sequential order, s outer."""
    rng = np.random.default_rng(5)
    w = synthetic_round_state(rng, T=200, hot=6)  # about ten cuts a vertex
    w["extra"][:] = 0.0  # as in the first tear round
    L, K = 3, 2
    args = [torch.as_tensor(w[k])[None] for k in
            ("tris", "surcharge", "choice", "pair_idx", "flipped", "vmove")]
    mem, cnt, extra = (torch.as_tensor(w[k])[None].clone() for k in ("cut_mem", "cut_cnt", "extra"))
    added = register_cuts_plain(*args, np.ones(1, bool), np.zeros(1), mem, cnt, extra,
                                L=L, K=K, max_cuts_per_round=1000, max_cuts_total=1 << 30)
    new = np.flatnonzero(cnt[0].numpy() != w["cut_cnt"])
    assert len(new) == int(added[0]) > 0
    n, C = w["extra"].shape
    v = w["tris"][new, w["vmove"][new]]
    blk = (np.clip(w["choice"][v], 0, C - 1) // L) * L
    fwd, rev = w["extra"].copy(), w["extra"].copy()
    for s in range(L):
        for j in range(len(new)):
            fwd[v[j], min(blk[j] + s, C - 1)] += w["surcharge"][new[j]]
        for j in reversed(range(len(new))):
            rev[v[j], min(blk[j] + s, C - 1)] += w["surcharge"][new[j]]
    np.testing.assert_array_equal(extra[0].numpy().view(np.int32), fwd.view(np.int32))
    assert not np.array_equal(fwd, rev)
    assert (blk + L - 1 > C - 1).any()  # a block clamped at C - 1


def test_register_cuts_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(6)
    w = synthetic_round_state(rng)
    args = [torch.as_tensor(w[k])[None] for k in
            ("tris", "surcharge", "choice", "pair_idx", "flipped", "vmove")]
    outs = []
    for fn in (register_cuts, register_cuts_plain):
        state = [torch.as_tensor(w[k])[None].clone() for k in ("cut_mem", "cut_cnt", "extra")]
        added = fn(*args, np.ones(1, bool), np.zeros(1), *state, L=3, K=2,
                   max_cuts_per_round=1000, max_cuts_total=1 << 30)
        outs.append([added] + state)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def scalar_inputs(rng, T_list=(37, 60, 12), T_pad=128, n=40, C=7):
    ws = [synthetic_round_state(rng, n=n, C=C, T=T) for T in T_list]
    m_ref = np.array([30, 30, 25], np.int32)
    for w, m in zip(ws, m_ref):
        w["cand_ref"] = np.minimum(w["cand_ref"], m - 1)
        w["src"] = rng.choice(np.array([-1, 0, 1], np.int32), len(w["tw"]))
        w["tri_mask"] = np.ones(len(w["tw"]), bool)
    padded = []
    for w in ws:
        p = dict(w)
        for key, fill in (("flipped", False), ("checked", False), ("tw", 0.0),
                          ("tri_mask", False), ("src", 0)):
            a = np.full(T_pad, fill, w[key].dtype)
            a[: len(w[key])] = w[key]
            p[key] = a
        padded.append(p)
    return ws, padded, m_ref


def run_scalars(fn, ws, m_ref, windows=None):
    keys = ("costs", "nm", "choice", "cand_ref")
    tri = ("flipped", "checked", "tw", "tri_mask", "src")
    ref_xy = torch.zeros((len(ws), int(m_ref.max()), 2))  # only its width is read
    return fn(*(stack(ws, k) for k in keys), ref_xy, torch.as_tensor(m_ref),
              *(stack(ws, k) for k in tri), windows=windows)


def test_tear_scalars_plain_matches_jax():
    rng = np.random.default_rng(7)
    ws, padded, m_ref = scalar_inputs(rng)
    got = run_scalars(tear_scalars_plain, padded, m_ref).numpy()
    for b, w in enumerate(ws):
        want = jax_scalars(*(jnp.asarray(w[k]) for k in ("costs", "nm", "choice", "cand_ref")),
                           int(m_ref[b]), *(jnp.asarray(w[k]) for k in (
                               "flipped", "checked", "tw", "tri_mask", "src")))
        np.testing.assert_array_equal(got[b, [1, 4, 5]], want[[1, 4, 5]])
        np.testing.assert_allclose(got[b, [0, 2, 3]], want[[0, 2, 3]], rtol=1e-6)
        assert want[1] > 0 and want[5] > 0  # congestion and flips present
        # Alone, unpadded: the same bits as in the padded batch.
        alone = run_scalars(tear_scalars_plain, [w], m_ref[b:b + 1]).numpy()[0]
        np.testing.assert_array_equal(alone.view(np.int32), got[b].view(np.int32))
    wrapped = run_scalars(tear_scalars, padded, m_ref).numpy()
    np.testing.assert_array_equal(wrapped.view(np.int32), got.view(np.int32))
    # A subset of the windows, as the batched loop passes its running ones.
    for fn in (tear_scalars_plain, tear_scalars):
        part = run_scalars(fn, padded, m_ref, windows=np.array([2, 0])).numpy()
        np.testing.assert_array_equal(part.view(np.int32), got[[2, 0]].view(np.int32))


@pytest.mark.parametrize("N", [1, 255, 256, 3000])
def test_fixed_order_sum(N):
    """The kernel's order: partial i % 256 in index order, then a halving
    tree; within 1e-6 of a float64 sum."""
    x = np.random.default_rng(N).uniform(0, 1000, (2, N)).astype(np.float32)
    got = fixed_order_sum(torch.as_tensor(x)).numpy()
    parts = np.zeros((2, 256), np.float32)
    for i in range(N):
        parts[:, i % 256] = parts[:, i % 256] + x[:, i]
    s = 128
    while s:
        parts = parts[:, :s] + parts[:, s:2 * s]
        s //= 2
    np.testing.assert_array_equal(got, parts[:, 0])
    np.testing.assert_allclose(got, x.astype(np.float64).sum(1), rtol=1e-6)


def test_fused_loop_tight_caps_matches_jax():
    """Both fused loops at two cuts a round, a total of five and a memory of
    two triples: identical per-round data and cut registries."""
    from same_tpu.solver.tearing_device import run_tearing_device as jax_run
    from same_tpu_torch.solver.tearing_device import run_tearing_device as torch_run

    rng = np.random.default_rng(0)
    pairs, costs, n, limits, nm, tris, w, src, ref_xy = _swap_instance(rng, n_swaps=3)
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)
    kw = dict(delaunay_penalty=0.1, allowed_flip_fraction=0.0, penalty_coeff=100.0,
              eps_final=1e-3, max_cuts=5, max_cuts_per_round=2, K=2)
    ref32 = np.asarray(ref_xy, np.float32)
    want = jax_run(problem, tris, w, src, ref32, **kw)
    got = torch_run(problem, tris, w, src, ref32, device="cpu", **kw)
    assert got["rounds_used"] == want["rounds_used"] >= 2
    assert got["cuts_added"] == want["cuts_added"] == 5
    for key in ("choices", "flipped", "checked", "auction_rounds"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["cut_tris"] == want["cut_tris"]
    for a, b in zip(got["cut_pairs"], want["cut_pairs"]):
        np.testing.assert_array_equal(a, b)
