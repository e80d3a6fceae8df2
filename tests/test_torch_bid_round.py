"""Port parity: the designs of K9 ``bid_compute`` and of the bidding round's
column loop (K1 ``auction_bid`` and ``auction_loop``), modelled in numpy and
held to the plain versions and to the JAX package on the CPU.

- K9: a numpy model of ``csrc/bid_compute.cu``'s lane groups (a row split
  over G lanes of K contiguous columns, each lane's own top-2 chain, then a
  merge of the lanes' (best, second, col) in column order, then the
  no-match column) at C = 8 (G = 2), 24 (G = 6) and 13 (G = 4, runs of 4,
  4, 4 and 1), on rows with ties planted across lane groups, all columns
  invalid, no-match ties and +-0.0 values, bit for bit against
  ``bid_compute_plain`` and the Pallas kernel of
  ``examples/bench_pallas.py:98-120`` in ``interpret=True``.
- The round: a numpy model of ``csrc/auction_round.cuh``'s chunked column
  loop (8 columns a chunk at C = 8 and 24, 4 at any other C, the last
  chunk's columns past C read at column C - 1 and passed through as -inf)
  with the kernels' 64-bit bid keys, resolve and settle, against
  ``auction_bid_plain`` and a jnp transcription of
  ``same_tpu/solver/auction.py:256-291`` over chained rounds, cold and
  then warm down to a few active bidders, at C = 8, 24 and 13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from same_tpu_torch.kernels.auction_bid import auction_bid, auction_bid_plain
from same_tpu_torch.kernels.bid_compute import NEG, bid_compute, bid_compute_plain
from test_torch_bid_compute import pallas_compute
from torch_parity import assert_bit_equal

F32 = np.float32


def signed_zeros(rng, shape):
    return np.where(rng.random(shape) < 0.5, F32(0.0), F32(-0.0))


# ---------------------------------------------------------------------------
# K9: lane groups
# ---------------------------------------------------------------------------

def k9_groups(C):
    """(lanes a row, columns a lane) of bid_compute.cu for width C."""
    if C == 8:
        return 2, 4
    if C == 24:
        return 6, 4
    return 4, -(-C // 4)


def k9_step(best, second, col, v, k):
    better = v > best
    return (np.where(better, v, best), np.where(better, best, np.fmax(second, v)),
            np.where(better, k, col))


def k9_merge(left, right):
    """The chain over left's columns, then right's (bid_compute.cu::merge)."""
    lb, ls, lc = left
    rb, rs, rc = right
    take = rb > lb
    return (np.where(take, rb, lb), np.where(take, np.fmax(lb, rs), np.fmax(ls, rb)),
            np.where(take, rc, lc))


def k9_model(costs, p_slot, valid, nm):
    """bid_compute.cu on every row: each lane's chain, the shuffle tree over
    the group (lane r takes lane r + off where r is a multiple of 2 off),
    then the no-match column and the increment."""
    n, C = costs.shape
    G, K = k9_groups(C)
    lanes = []
    for r in range(G):
        t = (np.full(n, F32(NEG)), np.full(n, F32(NEG)), np.full(n, r * K))
        for k in range(r * K, min(r * K + K, C)):
            v = np.where(valid[:, k], -(costs[:, k] + p_slot[:, k]), F32(NEG))
            t = k9_step(*t, v, k)
        lanes.append(t)
    off = 1
    while off < G:
        for r in range(0, G, 2 * off):
            if r + off < G:
                lanes[r] = k9_merge(lanes[r], lanes[r + off])
        off *= 2
    best, second, col = k9_step(*lanes[0], -nm, C)
    alt = np.where(second > F32(NEG), second, best - F32(1.0))
    return col.astype(np.int32), ((best - alt) + F32(1.0)).astype(F32)


def k9_inputs(C, n=2048, seed=0):
    """Random rows with each planted kind on n / 16 rows: (a) every column at
    one value (the first column wins, across every lane group), (b) every
    column invalid, (c) the best value twice, in the first and the last
    lane's runs, (d) -nm equal to the best value (the column wins), (e) +0.0
    and -0.0 values."""
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0, 200, (n, C)).astype(F32)
    p_slot = rng.uniform(0, 50, (n, C)).astype(F32)
    valid = rng.random((n, C)) < 0.9
    nm = np.full(n, 10000.0, F32)
    k, rows = n // 16, rng.permutation(n)
    a, b, c, d, e = (rows[i * k:(i + 1) * k] for i in range(5))
    costs[a] = costs[a, :1]
    p_slot[a] = p_slot[a, :1]
    valid[b] = False
    for j in (0, C - 1):
        costs[c, j] = -1.0
        p_slot[c, j] = 0.5
        valid[c, j] = True
    costs[e] = signed_zeros(rng, (k, C))
    p_slot[e] = signed_zeros(rng, (k, C))
    vals = np.where(valid[d], -(costs[d] + p_slot[d]), F32(-np.inf)).max(1)
    nm[d] = np.where(np.isfinite(vals), -vals, nm[d])
    return costs, p_slot, valid, nm, (a, b, c, d, e)


@pytest.mark.parametrize("C", [8, 24, 13])
def test_k9_lane_groups_bit_equal(C):
    costs, p_slot, valid, nm, (a, b, c, d, e) = k9_inputs(C)
    choice, incr = k9_model(costs, p_slot, valid, nm)
    # The planted rows decide as the chain does.
    assert (choice[a] == np.argmax(valid[a], 1))[valid[a].any(1)].all()
    assert (choice[b] == C).all()
    assert (choice[c] == 0).all() and (choice[d] < C).all()
    t = [torch.as_tensor(x) for x in (costs, p_slot, valid, nm)]
    for got in (bid_compute_plain(*t), bid_compute(*t)):
        assert_bit_equal(got[0], choice, f"C={C} choice, plain")
        assert_bit_equal(got[1], incr, f"C={C} incr, plain")
    want = pallas_compute(*(jnp.asarray(x) for x in (costs, p_slot, valid, nm)))
    assert_bit_equal(np.asarray(want[0]), choice, f"C={C} choice, Pallas")
    assert_bit_equal(np.asarray(want[1]), incr, f"C={C} incr, Pallas")


# ---------------------------------------------------------------------------
# The bidding round: the chunked column loop
# ---------------------------------------------------------------------------

def row_top2(costs, slots, valid, nm, prices):
    """auction_round.cuh::row_top2 on every row: chunks of kChunkCols = 8
    columns at C = 8 and 24, of kChunkAny = 4 at any other C, the loads of a
    chunk at column min(k, C - 1), columns past C as -inf."""
    n, C = costs.shape
    chunk = 8 if C in (8, 24) else 4
    best = np.full(n, F32(-np.inf))
    second = best.copy()
    col = np.zeros(n, np.int64)
    for k0 in range(0, C, chunk):
        for j in range(chunk):
            k = min(k0 + j, C - 1)
            ok = valid[:, k] & (k0 + j < C)
            v = np.where(ok, -(costs[:, k] + prices[slots[:, k]]), F32(-np.inf))
            best, second, col = k9_step(best, second, col, v, k0 + j)
    return k9_step(best, second, col, -nm, C)


def ordered_bits(f):
    u = f.astype(F32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)


def from_ordered(o):
    o = o.astype(np.uint32)
    return np.where(o & 0x80000000, o & 0x7FFFFFFF, ~o).astype(np.uint32).view(F32)


def round_model(costs, slots, valid, nm, prices, assigned, owner, eps):
    """One bidding round as K1 and auction_loop run it (auction_round.cuh):
    bid_phase, resolve_phase, settle_body; returns the BidRound fields."""
    n, C = costs.shape
    S = len(prices) - 1
    eps = F32(eps)
    active = (assigned < 0) | (assigned == C)
    best, second, choice = row_top2(costs, slots, valid, nm, prices)
    na = np.where(active & (choice == C) & (assigned < 0), C, assigned).astype(np.int32)
    bids = active & (choice < C)
    v2 = np.where(np.isfinite(second), second, best - F32(1.0))
    incr = (best - v2) + eps
    b = np.flatnonzero(bids)
    tgt = slots[b, choice[b]]
    bid = prices[tgt] + incr[b]
    keys = np.zeros(S + 1, np.uint64)
    np.maximum.at(keys, tgt, (ordered_bits(bid) << np.uint64(32)) | (n - b).astype(np.uint64))
    newp, new_owner = prices.copy(), owner.copy()
    won = np.flatnonzero(keys[:S])
    winner = n - (keys[won] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    newp[won] = from_ordered(keys[won] >> np.uint64(32))
    old = owner[won]
    new_owner[won] = winner
    evict = (old >= 0) & (old < n) & (old != winner)
    na[old[evict]] = -1
    newp[S], new_owner[S] = 0.0, -1
    takes = b[new_owner[tgt] == b]
    na[takes] = choice[takes]
    moved = np.int32(bids.any() | (np.where(active & (choice == C) & (assigned < 0), C,
                                            assigned) != assigned).any())
    return na, new_owner.astype(np.int32), newp.astype(F32), np.array([moved], np.int32)


@jax.jit
def jax_round(costs, slots, valid, nm_cost, prices, assigned, owner, eps):
    """same_tpu/solver/auction.py:256-291 (the bidding round of
    ``_auction_run``), with its ``moved`` (:293-295) less the boundary's."""
    n, C = costs.shape
    S = prices.shape[0] - 1
    NULL = C
    bidder_ids = jnp.arange(n, dtype=jnp.int32)
    active = (assigned < 0) | (assigned == NULL)
    p_slot = prices[slots]
    vals = jnp.where(valid, -(costs + p_slot), -jnp.inf)
    vals_all = jnp.concatenate([vals, -nm_cost[:, None]], axis=1)
    top2, top2i = jax.lax.top_k(vals_all, 2)
    v1, v2 = top2[:, 0], top2[:, 1]
    choice = top2i[:, 0].astype(jnp.int32)
    v2 = jnp.where(jnp.isfinite(v2), v2, v1 - 1.0)
    incr = v1 - v2 + eps

    is_null = choice == NULL
    new_assigned = jnp.where(active & is_null & (assigned < 0), NULL, assigned)

    bids_slot = active & ~is_null
    tgt = jnp.where(bids_slot, slots[bidder_ids, jnp.clip(choice, 0, C - 1)], S)
    bid = jnp.where(bids_slot, prices[tgt] + incr, -jnp.inf)

    newp = prices.at[tgt].max(bid)
    won = bids_slot & (bid >= newp[tgt])
    winner = jnp.full(S + 1, n, dtype=jnp.int32)
    winner = winner.at[jnp.where(won, tgt, S)].min(
        jnp.where(won, bidder_ids, n).astype(jnp.int32)
    )
    final_win = won & (winner[tgt] == bidder_ids)

    slot_changed = winner < n
    evict = slot_changed & (owner >= 0) & (owner != winner)
    evict_targets = jnp.where(evict, owner, n)
    new_assigned = new_assigned.at[evict_targets].set(-1, mode="drop")
    new_assigned = jnp.where(final_win, choice, new_assigned)

    new_owner = jnp.where(slot_changed, winner, owner)
    new_owner = new_owner.at[S].set(-1)
    newp = newp.at[S].set(0.0)
    moved = jnp.any(new_assigned != assigned) | jnp.any(bids_slot)
    return new_assigned, new_owner, newp, moved.astype(jnp.int32).reshape(1)


def round_inputs(C, n=320, S=400, seed=0):
    """A problem whose values tie often: integer costs 0-3, every price +0.0
    or -0.0 at the start (so a row's valid columns tie across chunks), n /
    16 rows each with one cost at every column, with every column invalid
    (slot S, as build_assignment_problem writes), and with a no-match cost
    that ties the row's best column; no-match cost 6 elsewhere."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 4, (n, C)).astype(F32)
    slots = rng.integers(0, S, (n, C)).astype(np.int32)
    valid = rng.random((n, C)) < 0.85
    nm = np.full(n, 6.0, F32)
    prices = signed_zeros(rng, S + 1)
    prices[S] = 0.0
    k, rows = n // 16, rng.permutation(n)
    a, b, d = (rows[i * k:(i + 1) * k] for i in range(3))
    costs[a] = costs[a, :1]
    valid[b] = False
    slots[~valid] = S
    vals = np.where(valid[d], -(costs[d] + prices[slots[d]]), F32(-np.inf)).max(1)
    nm[d] = np.where(np.isfinite(vals), -vals, nm[d])
    return costs, slots, valid, nm, prices


@pytest.mark.parametrize("C", [8, 24, 13])
def test_round_chunked_model_chained(C):
    """Chained rounds from a cold start until at most a few bidders are
    active: the model, the plain round (and the wrapper on CPU tensors) and
    JAX's round hold the same state bit for bit after every round."""
    costs, slots, valid, nm, prices = round_inputs(C)
    n, S1 = costs.shape[0], len(prices)
    assigned = np.full(n, -1, np.int32)
    owner = np.full(S1, -1, np.int32)
    t = [torch.as_tensor(x) for x in (costs, slots, valid, nm)]
    j = [jnp.asarray(x) for x in (costs, slots, valid, nm)]
    fewest, eps = n, 0.25
    for r in range(30):
        want = round_model(costs, slots, valid, nm, prices, assigned, owner, eps)
        state = [torch.as_tensor(x) for x in (prices, assigned, owner)]
        for got in (auction_bid_plain(*t, *state, eps), auction_bid(*t, *state, eps)):
            for name, g, w in zip(("new_assigned", "new_owner", "newp", "moved"), got, want):
                assert_bit_equal(g, w, f"C={C} round {r} {name}")
        jx = jax_round(*j, jnp.asarray(prices), jnp.asarray(assigned), jnp.asarray(owner),
                       jnp.float32(eps))
        for name, g, w in zip(("new_assigned", "new_owner", "newp", "moved"), jx, want):
            assert_bit_equal(np.asarray(g), w, f"C={C} round {r} {name}, JAX")
        assigned, owner, prices = want[0], want[1], want[2]
        active = int(((assigned < 0) | (assigned == C)).sum())
        fewest = min(fewest, active)
    # The chain went from every bidder active to a warm state with few.
    assert fewest < n // 10
