"""Port parity in hard mode, and K8's grouped surcharge order on the CPU.

- The two hard-mode instances of tests/test_tearing.py go through
  ``solve_with_tearing(hard=True)`` of the JAX package and of
  same_tpu_torch (on the CPU, by the kernels' plain versions), on both
  loops: ``device_loop=False`` (the host separation loop) and ``"force"``
  (the fused loop, where K8 applies the hard penalty of 1e7). Objective,
  matching, flips, tear rounds, cuts and auction rounds are identical; both
  answers have no flip and use each ref at most once after the final
  feasibility pass.
- A numpy model of K8's schedule (csrc/tear_round.cu): contiguous runs of
  triangles a thread and one exclusive scan for the ranks, the kernel's
  bitonic network over the keys (vertex << 32 | rank), and each vertex's
  segment applied by its first entry, the column passes outer and the cuts
  in triangle order inner. It is held bit-equal to ``register_cuts_plain``
  (JAX's order) with the caps free and binding.
"""

import numpy as np
import pytest
import torch

import same_tpu.solver.tearing as jax_tearing
import same_tpu_torch.solver.tearing as torch_tearing
from same_tpu.models.assignment import build_assignment_problem
from same_tpu_torch.kernels.tear_round import register_cuts_plain, synthetic_round_state
from test_tearing import _swap_instance

import torch_parity  # noqa: F401  (one torch thread per xdist worker)

# tests/test_tearing.py: test_hard_constraints and
# test_hard_constraints_guaranteed_zero_flips.
HARD_CASES = {
    "hard_constraints": (dict(), 40),
    "locked_in_flips": (dict(n_swaps=4, n_side=7, ct_weight=5000.0), 6),
}


@pytest.mark.parametrize("device_loop", [False, "force"], ids=["host_loop", "fused_loop"])
@pytest.mark.parametrize("case", list(HARD_CASES))
def test_hard_mode_parity(case, device_loop):
    kw, rounds = HARD_CASES[case]
    rng = np.random.default_rng(0)  # the rng fixture of tests/conftest.py
    pairs, costs, n, limits, nm, tris, w, src, ref_xy = _swap_instance(rng, **kw)
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)
    results = {}
    for name, module, dev in (
        ("jax", jax_tearing, {}), ("torch", torch_tearing, {"device": "cpu"}),
    ):
        results[name] = module.solve_with_tearing(
            problem, costs, tris, w, src, ref_xy, delaunay_penalty=5.0,
            penalty_coeff=100.0, allowed_flip_fraction=0.0, hard=True, eps_final=1e-3,
            max_tear_rounds=rounds, device_loop=device_loop, repair_budget=120.0, **dev,
        )
    rj, rt = results["jax"], results["torch"]
    assert rj.cuts_added > 0  # the loop registered hard cuts
    assert rt.objective == rj.objective
    np.testing.assert_array_equal(rt.match_ref, rj.match_ref)
    np.testing.assert_array_equal(rt.flipped, rj.flipped)
    assert rt.tear_rounds == rj.tear_rounds
    assert rt.cuts_added == rj.cuts_added
    assert rt.info["auction_rounds_total"] == rj.info["auction_rounds_total"]
    for res in (rj, rt):
        assert res.flipped.sum() == 0
        matched = res.match_ref[res.match_ref >= 0]
        assert (np.bincount(matched, minlength=n) <= 1).all()


def bitonic_sort(keys, warp=4):
    """The kernel's network on a power-of-two array (numpy, in place):
    partners ``warp`` or more apart compare-swap by the lower index, closer
    ones each keep the min or max of the pair, as the warp shuffles do."""
    p = len(keys)
    k = 2
    while k <= p:
        j = k >> 1
        while j >= warp:
            for i in range(p):
                ixj = i ^ j
                if ixj > i and (keys[i] > keys[ixj]) == ((i & k) == 0):
                    keys[i], keys[ixj] = keys[ixj], keys[i]
            j >>= 1
        while j > 0:
            x = keys.copy()
            for i in range(p):
                y = x[i ^ j]
                keep_min = ((i & k) == 0) == ((i & j) == 0)
                keys[i] = min(x[i], y) if keep_min else max(x[i], y)
            j >>= 1
        k <<= 1
    return keys


def grouped_register(w, register, done, L, K, max_cuts_per_round, max_cuts_total, threads=16):
    """One window through K8's schedule (numpy); ``w`` is updated in place
    and the cuts kept are returned."""
    tris, choice, pair_idx = w["tris"], w["choice"], w["pair_idx"]
    n, C = w["extra"].shape
    T = len(tris)
    if not register:
        return 0
    limit = max(0, min(max_cuts_per_round, max_cuts_total - done))
    match = np.where(choice < C, pair_idx[np.arange(n), np.clip(choice, 0, C - 1)], -1)
    pairs = match[np.clip(tris, 0, n - 1)]
    dup = (w["cut_mem"] == pairs[:, None, :]).all(axis=2).any(axis=1)
    is_new = w["flipped"] & (pairs >= 0).all(axis=1) & ~dup & (w["cut_cnt"] < K)
    # Contiguous runs and one exclusive scan of the per-run counts.
    per = -(-T // threads)
    counts = [int(is_new[j * per:(j + 1) * per].sum()) for j in range(threads)]
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    keys, vals = [], []
    for j in range(threads):
        rank = int(before[j])
        for t in np.flatnonzero(is_new[j * per:(j + 1) * per]) + j * per:
            if rank < limit:
                w["cut_mem"][t, w["cut_cnt"][t]] = pairs[t]
                w["cut_cnt"][t] += 1
                v = int(tris[t, np.clip(w["vmove"][t], 0, 2)])
                keys.append((v << 32) | rank)
                vals.append(w["surcharge"][t])
            rank += 1
    n_added = len(keys)
    if n_added == 0:
        return 0
    p = 1 << (n_added - 1).bit_length()
    order = bitonic_sort(np.array(keys + [2**64 - 1] * (p - n_added), np.uint64))[:n_added]
    extra = w["extra"]
    for i in range(n_added):
        v = int(order[i] >> 32)
        if i > 0 and int(order[i - 1] >> 32) == v:
            continue  # not the first entry of its segment
        seg = [q for q in range(i, n_added) if int(order[q] >> 32) == v]
        blk = (int(np.clip(choice[min(max(v, 0), n - 1)], 0, C - 1)) // L) * L
        col, x = -1, np.float32(0)
        for s in range(L):
            c = min(max(blk + s, 0), C - 1)
            if c != col:
                if col >= 0:
                    extra[v, col] = x
                x, col = extra[v, c], c
            for q in seg:
                x = np.float32(x + vals[int(order[q] & 0xFFFFFFFF)])
        extra[v, col] = x
    return n_added


SCHEDULE_CASES = {
    "caps_free": dict(max_cuts_per_round=1000, max_cuts_total=1 << 30,
                      register=[True, True, False], cuts_added=[0, 5, 0]),
    "caps_binding": dict(max_cuts_per_round=4, max_cuts_total=20,
                         register=[True, True, True], cuts_added=[0, 18, 3]),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_grouped_schedule_is_jax_order(case):
    cfg = SCHEDULE_CASES[case]
    caps = dict(max_cuts_per_round=cfg["max_cuts_per_round"],
                max_cuts_total=cfg["max_cuts_total"])
    rng = np.random.default_rng(5)
    # dp = 0.1, C = 7, L = 3 (a block clamped at C - 1); the first window
    # draws its triangles from six vertices, so its segments are long.
    ws = [synthetic_round_state(rng, hot=6)]
    ws += [synthetic_round_state(rng) for _ in range(2)]
    keys = ("tris", "surcharge", "choice", "pair_idx", "flipped", "vmove")
    state = [torch.as_tensor(np.stack([w[k] for w in ws])).clone()
             for k in ("cut_mem", "cut_cnt", "extra")]
    for _round in range(2):  # the second round finds its cuts in memory
        added = register_cuts_plain(
            *(torch.as_tensor(np.stack([w[k] for w in ws])) for k in keys),
            np.asarray(cfg["register"]), np.asarray(cfg["cuts_added"]), *state,
            L=3, K=2, **caps)
        for b, w in enumerate(ws):
            got = grouped_register(w, cfg["register"][b], cfg["cuts_added"][b], 3, 2, **caps)
            assert got == int(added[b])
            np.testing.assert_array_equal(w["cut_mem"], state[0][b].numpy())
            np.testing.assert_array_equal(w["cut_cnt"], state[1][b].numpy())
            np.testing.assert_array_equal(w["extra"].view(np.int32), state[2][b].numpy().view(np.int32))
        if _round == 0:
            assert int(added[0]) > 0
            if case == "caps_binding":
                assert added.tolist() == [4, 2, 4]
            else:
                assert int(added[0]) > 20
