"""K1 ``auction_bid``: one bidding round of the epsilon-scaling auction.

``auction_bid`` launches ``csrc/auction_bid.cu`` for CUDA tensors and runs
``auction_bid_plain``, a line-by-line PyTorch transcription of
``same_tpu/solver/auction.py:256-291``, for CPU tensors. Both return the
round's new assignment, owners and prices, and a one-element int32 ``moved``
flag (any assignment change or any bid) that stays on the device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

NEG_INF = float("-inf")


class BidRound(NamedTuple):
    new_assigned: torch.Tensor  # [n]   i32
    new_owner: torch.Tensor     # [S+1] i32
    newp: torch.Tensor          # [S+1] f32
    moved: torch.Tensor         # [1]   i32, 0 or 1


def top2(vals: torch.Tensor):
    """(v1, v2, first argmax) per row: lax.top_k(vals, 2) with its tie rule.

    ``torch.topk`` does not promise that the lower index wins a tie;
    ``argmax`` returns the first maximum, and masking that one position
    leaves the multiset's second value.
    """
    idx = vals.argmax(dim=1)
    v1 = vals.gather(1, idx[:, None])[:, 0]
    v2 = vals.scatter(1, idx[:, None], NEG_INF).max(dim=1).values
    return v1, v2, idx


def auction_bid_plain(costs, slots, valid, nm, prices, assigned, owner, eps):
    """Plain PyTorch twin of K1 (same_tpu/solver/auction.py:256-291)."""
    n, C = costs.shape
    S = prices.shape[0] - 1
    dev = costs.device
    bidder_ids = torch.arange(n, dtype=torch.int32, device=dev)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    slots_l = slots.long()

    active = (assigned < 0) | (assigned == C)
    p_slot = prices[slots_l]
    vals = torch.where(valid, -(costs + p_slot), NEG_INF)
    vals_all = torch.cat([vals, -nm[:, None]], dim=1)
    v1, v2, choice = top2(vals_all)
    choice = choice.to(torch.int32)
    v2 = torch.where(torch.isfinite(v2), v2, v1 - 1.0)
    incr = v1 - v2 + eps_t

    is_null = choice == C
    new_assigned = torch.where(active & is_null & (assigned < 0), C, assigned)

    bids_slot = active & ~is_null
    col = choice.clamp(0, C - 1).long()
    tgt = torch.where(bids_slot, slots_l.gather(1, col[:, None])[:, 0], S)
    bid = torch.where(bids_slot, prices[tgt] + incr, NEG_INF)

    newp = prices.scatter_reduce(0, tgt, bid, reduce="amax", include_self=True)
    won = bids_slot & (bid >= newp[tgt])
    # Tie-break winners by smallest bidder index via a scatter-min.
    winner = torch.full((S + 1,), n, dtype=torch.int32, device=dev)
    winner = winner.scatter_reduce(
        0, torch.where(won, tgt, S), torch.where(won, bidder_ids, n),
        reduce="amin", include_self=True,
    )
    final_win = won & (winner[tgt] == bidder_ids)

    slot_changed = winner < n
    evict = slot_changed & (owner >= 0) & (owner != winner)
    # `.at[evict_targets].set(-1, mode="drop")`: row n is the dropped sentinel.
    buf = torch.cat([new_assigned, new_assigned.new_zeros(1)])
    buf[torch.where(evict, owner, n).long()] = -1
    new_assigned = torch.where(final_win, choice, buf[:n])

    new_owner = torch.where(slot_changed, winner, owner)
    new_owner[S] = -1
    newp[S] = 0.0

    moved = (new_assigned != assigned).any() | bids_slot.any()
    return BidRound(new_assigned, new_owner, newp, moved.to(torch.int32).reshape(1))


_KEYS: dict = {}


def _key_workspace(device, size: int) -> torch.Tensor:
    """Zeroed [S+1] u64 bid keys; every launch leaves them zeroed again.

    One buffer per (device, size): solves that share it must run on one
    stream, as the port's single-window path does.
    """
    k = (str(device), size)
    buf = _KEYS.get(k)
    if buf is None:
        buf = torch.zeros(size, dtype=torch.int64, device=device)
        _KEYS[k] = buf
    return buf


def _lib():
    lib = _build.load("auction_bid")
    if lib.same_auction_bid.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_auction_bid.restype = i
        lib.same_auction_bid.argtypes = [
            p, p, p, p, p, p, p, i, i, i, ctypes.c_float, p, p, p, p, p, p, p,
        ]
    return lib


def auction_bid(costs, slots, valid, nm, prices, assigned, owner, eps) -> BidRound:
    """One bidding round: K1 on CUDA tensors, the plain twin on CPU tensors."""
    if costs.device.type == "cpu":
        return auction_bid_plain(costs, slots, valid, nm, prices, assigned, owner, eps)
    if costs.device.type != "cuda":
        raise ValueError(f"auction_bid: unsupported device {costs.device}")
    n, C = costs.shape
    S = prices.shape[0] - 1
    _build.check_tensors("auction_bid", costs.device, (
        ("costs", costs, torch.float32, (n, C)),
        ("slots", slots, torch.int32, (n, C)),
        ("valid", valid, torch.bool, (n, C)),
        ("nm", nm, torch.float32, (n,)),
        ("prices", prices, torch.float32, (S + 1,)),
        ("assigned", assigned, torch.int32, (n,)),
        ("owner", owner, torch.int32, (S + 1,)),
    ))
    lib = _lib()
    new_assigned = torch.empty_like(assigned)
    new_owner = torch.empty_like(owner)
    newp = torch.empty_like(prices)
    moved = torch.empty(1, dtype=torch.int32, device=costs.device)
    bid_col = torch.empty(n, dtype=torch.int32, device=costs.device)
    keys = _key_workspace(costs.device, S + 1)
    stream = torch.cuda.current_stream(costs.device).cuda_stream
    rc = lib.same_auction_bid(
        costs.data_ptr(), slots.data_ptr(), valid.data_ptr(), nm.data_ptr(),
        prices.data_ptr(), assigned.data_ptr(), owner.data_ptr(), n, C, S,
        float(eps), new_assigned.data_ptr(), new_owner.data_ptr(),
        newp.data_ptr(), moved.data_ptr(), bid_col.data_ptr(),
        keys.data_ptr(), stream,
    )
    _build.check(lib, rc, "auction_bid")
    auction_bid.launches += 1
    return BidRound(new_assigned, new_owner, newp, moved)


auction_bid.launches = 0
