"""``auction_loop``: one whole auction solve, as one persistent kernel.

``auction_loop`` launches ``csrc/auction_loop.cu`` once per solve for CUDA
tensors: one thread-block cluster (``cluster_shape()``: 16 blocks of 1,024
threads on neighbouring SMs, synchronised by the cluster's hardware barrier)
runs every epsilon phase, polish repeat, boundary step and the final
placement on the card, and the host reads one small stats tensor at the
end. For CPU tensors it runs ``auction_loop_plain``, the port of
``same_tpu/solver/auction.py::_auction_run`` as a Python loop over bidding
rounds (the bidding round is K1's plain version, the boundary step with its
4 reverse drains, the placement passes and the objective are plain torch;
one host read per round feeds :func:`_control_step`). Both return an
:class:`AuctionResult`.

``auction_loop_batch`` (kernel K5) solves a batch of same-shape windows
stacked on a leading axis, the JAX package's vmapped ``_auction_run``: one
ordinary launch of one cluster a window (no cooperative launch: clusters
share no barrier, and those the card cannot hold at once wait their turn),
bit-equal window by window to ``auction_loop`` on the same inputs. Its plain
version, ``auction_loop_batch_plain``, loops ``auction_loop_plain`` over the
windows.

The kernel never writes its inputs: ``prices0``, ``assigned0`` and
``owner0`` are copied into the fresh output tensors first, and those are
what it updates in place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .auction_bid import auction_bid_plain, top2

NEG_INF = float("-inf")


class AuctionResult(NamedTuple):
    choice: torch.Tensor   # [n] i32: winning column in [0, C) or C for no-match
    prices: torch.Tensor   # [S+1] f32: final slot prices (last entry is dummy)
    rounds: int            # total bidding rounds executed
    owner: torch.Tensor    # [S+1] i32: per-slot holder (carryable warm state)
    phase: int             # epsilon phase at exit (P = finished)
    polish: int            # polish repetitions of the final phase


def _values(costs, slots_l, valid, nm_cost, prices):
    """[n, C+1] bidder values at current prices (last column = no-match)."""
    p_slot = prices[slots_l]
    vals = torch.where(valid, -(costs + p_slot), NEG_INF)
    return torch.cat([vals, -nm_cost[:, None]], dim=1)


def _boundary_step(costs, slots_l, valid, nm_cost, prices, assigned, owner,
                   eps, slot_rows, slot_cols):
    """Release eps-CS violators, zero unowned prices, drain reverse rounds.

    same_tpu/solver/auction.py:129-247. Returns (assigned, owner, prices,
    moved) with ``moved`` a device bool (any reverse-auction win).
    """
    n, C = costs.shape
    S = prices.shape[0] - 1
    dev = costs.device
    vals_all = _values(costs, slots_l, valid, nm_cost, prices)
    best0 = vals_all.max(dim=1).values
    held_col = assigned.clamp(0, C).long()
    held_val = vals_all.gather(1, held_col[:, None])[:, 0]
    holds_slot = (assigned >= 0) & (assigned < C)
    release = holds_slot & (held_val < best0 - eps)
    held_slot = slots_l.gather(1, held_col.clamp(0, C - 1)[:, None])[:, 0]
    released_slots = torch.where(release, held_slot, S)
    assigned = torch.where(release, -1, assigned)
    owner = owner.clone()
    owner[released_slots] = -1
    owner[S] = -1
    # Unsold objects carry price zero (LP complementary slackness).
    prices = torch.where(owner < 0, 0.0, prices)
    prices[S] = 0.0

    any_win = torch.zeros((), dtype=torch.bool, device=dev)
    if slot_rows is None:
        return assigned, owner, prices, any_win

    slot_ids = torch.arange(S, dtype=torch.int32, device=dev)
    i_sp = slot_rows.clamp(0, n - 1).long()
    sc_l = slot_cols.long()
    ref_mask = slot_rows >= 0
    neg_cost_sp = -costs[i_sp, sc_l]
    no_win = torch.zeros(1, dtype=torch.bool, device=dev)

    def reverse_once(assigned, owner, prices, any_win):
        # Per-slot best person at exclusive profit (second-best when the
        # slot is the person's current best).
        vals_all = _values(costs, slots_l, valid, nm_cost, prices)
        best, second_raw, best_col = top2(vals_all)
        second = torch.where(torch.isfinite(second_raw), second_raw, best)
        is_best_col = best_col[i_sp] == slot_cols
        pi_excl = torch.where(is_best_col, second[i_sp], best[i_sp])
        surplus = torch.where(ref_mask, neg_cost_sp - pi_excl, NEG_INF)
        arg_p = surplus.argmax(dim=1)[:, None]
        ms = surplus.gather(1, arg_p)[:, 0]                # [S] best surplus
        person = slot_rows.gather(1, arg_p)[:, 0]          # [S] (-1 if none)
        pcol = slot_cols.gather(1, arg_p)[:, 0]
        unowned = owner[:S] < 0
        # 2*eps margin keeps the person strictly outside its eps-CS band.
        p_new = torch.clamp_min(ms - 2.0 * eps, 0.0)
        eligible = unowned & (person >= 0) & (ms > 0.0)
        person_c = person.clamp(0, n - 1).long()

        # Person-side conflict resolution: highest surplus wins, smallest
        # slot id breaks ties. Row n of each buffer is the dropped sentinel.
        claim_tgt = torch.where(eligible, person, n).long()
        best_ms = torch.full((n + 1,), NEG_INF, dtype=ms.dtype, device=dev)
        best_ms = best_ms.scatter_reduce(
            0, claim_tgt, torch.where(eligible, ms, NEG_INF), reduce="amax"
        )[:n]
        cand = eligible & (best_ms[person_c] == ms)
        slot_min = torch.full((n + 1,), S, dtype=torch.int32, device=dev)
        slot_min = slot_min.scatter_reduce(
            0, torch.where(cand, person, n).long(), slot_ids, reduce="amin"
        )[:n]
        win = cand & (slot_min[person_c] == slot_ids)

        # Winner slots take their person; the person's old slot is freed.
        new_col = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        new_col[torch.where(win, person, n).long()] = pcol
        new_col = new_col[:n]
        got = new_col >= 0
        still_holds = (assigned >= 0) & (assigned < C)
        held = slots_l.gather(1, assigned.clamp(0, C - 1).long()[:, None])[:, 0]
        old_slot = torch.where(got & still_holds, held, S)
        owner = owner.clone()
        owner[old_slot] = -1
        owner[torch.where(win, slot_ids, S).long()] = torch.where(win, person, -1)
        assigned = torch.where(got, new_col, assigned)
        # Claimed slots at their attract level; freed and unclaimed unowned
        # slots at zero.
        p_real = torch.where(win, p_new, prices[:S])
        prices = torch.cat([p_real, prices[S:]])
        prices = torch.where(torch.cat([~win, no_win]) & (owner < 0), 0.0, prices)
        prices[S] = 0.0
        owner[S] = -1
        return assigned, owner, prices, any_win | win.any()

    # Fixed 4-drain unroll, kept verbatim from the JAX loop (it shapes which
    # chains resolve at which boundary).
    for _ in range(4):
        assigned, owner, prices, any_win = reverse_once(assigned, owner, prices, any_win)
    return assigned, owner, prices, any_win


def _place_once(costs, slots_l, valid, nm_cost, assigned, owner, prices):
    """Place unassigned bidders on their best free slot (auction.py:405-434)."""
    n, C = costs.shape
    S = prices.shape[0] - 1
    bidder_ids = torch.arange(n, dtype=torch.int32, device=costs.device)
    unplaced = assigned < 0
    free_slot = owner < 0
    p_slot = prices[slots_l]
    vals = torch.where(valid & free_slot[slots_l], -(costs + p_slot), NEG_INF)
    best = vals.max(dim=1).values
    best_col = vals.argmax(dim=1).to(torch.int32)
    take_nm = (-nm_cost >= best) | ~torch.isfinite(best)
    choice = torch.where(take_nm, C, best_col)
    bids = unplaced & ~take_nm
    tgt = torch.where(bids, slots_l.gather(1, best_col.long()[:, None])[:, 0], S)
    winner = torch.full((S + 1,), n, dtype=torch.int32, device=costs.device)
    winner = winner.scatter_reduce(
        0, tgt, torch.where(bids, bidder_ids, n), reduce="amin"
    )
    win = bids & (winner[tgt] == bidder_ids)
    assigned = torch.where(unplaced & (win | take_nm), choice, assigned)
    owner = owner.clone()
    owner[torch.where(win, tgt, S)] = torch.where(win, bidder_ids, -1)
    owner[S] = -1
    return assigned, owner, prices


class Control(NamedTuple):
    """Loop state of the phase / polish / stall rule, as host scalars."""

    phase: int = 0
    boundary: bool = True
    changed_in_phase: bool = False
    polish: int = 0
    it: int = 0
    best_obj: np.float32 = np.float32(np.inf)
    since_obj: int = 0
    phase_start: int = 0
    last_stall_best: np.float32 = np.float32(np.inf)


def _control_step(
    ctl: Control, moved: bool, cur_obj: np.float32, P: int, max_polish: int,
    obj_patience: int, obj_tol: np.float32,
) -> Control:
    """One round of the loop control (same_tpu/solver/auction.py:296-376).

    ``moved`` is the round's movement flag and ``cur_obj`` its placement
    value (+inf when the stall stop is off). f32 and int semantics follow
    numpy; the control phase of ``csrc/auction_loop.cu`` mirrors this rule.
    """
    it = ctl.it
    changed_in_phase = ctl.changed_in_phase or moved
    obj_improved = bool(cur_obj < ctl.best_obj - obj_tol)
    best_obj = min(ctl.best_obj, cur_obj)
    since_obj = 0 if obj_improved else ctl.since_obj + 1
    stall = obj_patience > 0 and (
        since_obj >= max(obj_patience, (it - ctl.phase_start) // 3)
    )

    # Phase-transition logic (fixed point OR stall), auction.py:342-376.
    fixed = not moved
    is_last = ctl.phase >= P - 1
    fixed_or_stall = fixed or stall
    drain_failed = bool(best_obj >= ctl.last_stall_best - obj_tol)
    stall_finish = stall and is_last and (drain_failed or ctl.polish >= max_polish)
    stall_repeat = stall and is_last and not stall_finish
    repeat_last = (
        fixed and is_last and changed_in_phase and ctl.polish < max_polish
        and not stall
    )
    finish = (
        fixed and is_last and (not changed_in_phase or ctl.polish >= max_polish)
    ) or stall_finish
    advance = fixed_or_stall and not is_last
    restart = advance or stall_repeat
    return Control(
        phase=P if finish else (ctl.phase + 1 if advance else ctl.phase),
        boundary=fixed_or_stall,
        changed_in_phase=changed_in_phase and not fixed_or_stall,
        polish=ctl.polish + 1 if (repeat_last or stall_repeat) else ctl.polish,
        it=it + 1,
        best_obj=best_obj,
        since_obj=0 if restart else since_obj,
        phase_start=it + 1 if restart else ctl.phase_start,
        last_stall_best=best_obj if stall_repeat else ctl.last_stall_best,
    )


def auction_loop_plain(
    costs, slots, valid, nm_cost, prices0, eps_schedule, max_rounds,
    max_polish=64, assigned0=None, owner0=None,
    slot_rows=None, slot_cols=None,
    obj_patience=None, obj_tol=None, obj_band=None,
) -> AuctionResult:
    """Fused auction: all epsilon phases + polish, one bidding round per step.

    Plain version of the ``auction_loop`` kernel: a Python loop over bidding
    rounds with the same state, phase, polish and stall rules as
    ``same_tpu/solver/auction.py::_auction_run``. ``eps_schedule`` is a host
    array. ``obj_band`` is accepted and, as in the JAX loop, never read
    (ROADMAP C1).
    """
    n, C = costs.shape
    S = prices0.shape[0] - 1
    dev = costs.device
    sched = np.asarray(eps_schedule, dtype=np.float32)
    P = int(sched.shape[0])
    obj_patience = int(obj_patience or 0)
    obj_tol = np.float32(0.0 if obj_tol is None else obj_tol)
    max_total = int(max_rounds)
    slots_l = slots.long()
    col_ids = torch.arange(n, device=dev)

    assigned = (
        torch.full((n,), -1, dtype=torch.int32, device=dev)
        if assigned0 is None else assigned0
    )
    owner = (
        torch.full((S + 1,), -1, dtype=torch.int32, device=dev)
        if owner0 is None else owner0
    )
    prices = prices0
    ctl = Control()

    while ctl.phase < P and ctl.it < max_total:
        eps = float(sched[min(ctl.phase, P - 1)])
        boundary_moved = None
        if ctl.boundary:
            assigned, owner, prices, boundary_moved = _boundary_step(
                costs, slots_l, valid, nm_cost, prices, assigned, owner, eps,
                slot_rows, slot_cols,
            )

        new_assigned, new_owner, newp, moved_d = auction_bid_plain(
            costs, slots, valid, nm_cost, prices, assigned, owner, eps
        )
        if boundary_moved is not None:
            moved_d = moved_d | boundary_moved.to(torch.int32)

        # One host read per round: the moved flag (+ the placement value of
        # the current state, unplaced bidders at their reservation cost).
        if obj_patience > 0:
            col_cur = new_assigned.clamp(0, C - 1).long()
            on_slot = (new_assigned >= 0) & (new_assigned < C)
            cur_obj_d = torch.where(
                on_slot, costs[col_ids, col_cur], nm_cost
            ).sum()
            flags = torch.stack([moved_d[0].to(torch.float32), cur_obj_d]).cpu().numpy()
            moved = bool(flags[0] != 0)
            cur_obj = np.float32(flags[1])
        else:
            moved = bool(moved_d.item())
            cur_obj = np.float32(np.inf)
        ctl = _control_step(ctl, moved, cur_obj, P, max_polish, obj_patience, obj_tol)
        assigned, owner, prices = new_assigned, new_owner, newp

    # Final placement for bidders still unassigned at the round cap (4
    # passes, verbatim), then the rest go to no-match.
    for _ in range(4):
        assigned, owner, prices = _place_once(
            costs, slots_l, valid, nm_cost, assigned, owner, prices
        )
    assigned = torch.where(assigned < 0, C, assigned)
    return AuctionResult(
        choice=assigned, prices=prices, rounds=ctl.it, owner=owner,
        phase=ctl.phase, polish=ctl.polish,
    )


def _lib():
    lib = _build.load("auction_loop")
    if lib.same_auction_loop.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_auction_loop_workspace.restype = ctypes.c_longlong
        lib.same_auction_loop_workspace.argtypes = [i, i, ctypes.POINTER(i)]
        lib.same_auction_loop_clusters.restype = i
        lib.same_auction_loop_clusters.argtypes = [ctypes.POINTER(i)] * 3
        lib.same_auction_loop_batch.restype = i
        lib.same_auction_loop_batch.argtypes = [
            p, p, p, p, p, p, i,  # costs .. slot_cols, Ps
            p, i, p, p, p, p,  # eps_sched, P, prices0, assigned0, owner0, warm
            i, i, i, i,  # B, n, C, S
            p, i, p, p,  # max_rounds, max_polish, obj_patience, obj_tol
            p, i,  # windows, their number
            p, p, p, p,  # choice, prices, owner, stats
            p, ctypes.c_longlong, p, ctypes.POINTER(i),  # workspace, stride, stream, launches
        ]
        lib.same_auction_loop.restype = i
        lib.same_auction_loop.argtypes = [
            p, p, p, p, p, p, i,  # costs .. slot_cols, Ps
            p, i, p, p, p,  # eps_sched, P, prices0, assigned0, owner0
            i, i, i, i, i, i, ctypes.c_float,  # n, C, S, rounds, polish, patience, tol
            p, p, p, p, p, p,  # choice, prices, owner, stats, trace, phase_cycles
            p, ctypes.c_longlong, p,  # workspace, its bytes, stream
        ]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def auction_loop(
    costs, slots, valid, nm_cost, prices0, eps_schedule, max_rounds,
    max_polish=64, assigned0=None, owner0=None,
    slot_rows=None, slot_cols=None,
    obj_patience=None, obj_tol=None, obj_band=None, trace=None, phase_cycles=None,
) -> AuctionResult:
    """One auction solve: the persistent kernel on CUDA tensors, the plain
    loop on CPU tensors. Arguments as :func:`auction_loop_plain`; every slot
    id must lie in [0, S] (``build_assignment_problem`` writes S into invalid
    columns): the kernel gathers the price of every column, valid or not, as
    the plain loop does.

    ``trace`` and ``phase_cycles`` are for diagnosis on the card only:
    ``trace``, a float32 tensor of ``[max_rounds, 2]``, receives each
    round's (moved, cur_obj), the inputs of the control step;
    ``phase_cycles``, an int64 tensor of ``[5]``, the clock cycles the
    cluster's first thread spent in the boundary steps, bids, resolves,
    settles and control phases, each up to the exit from its barrier.
    """
    if costs.device.type == "cpu":
        return auction_loop_plain(
            costs, slots, valid, nm_cost, prices0, eps_schedule, max_rounds,
            max_polish=max_polish, assigned0=assigned0, owner0=owner0,
            slot_rows=slot_rows, slot_cols=slot_cols,
            obj_patience=obj_patience, obj_tol=obj_tol, obj_band=obj_band,
        )
    if costs.device.type != "cuda":
        raise ValueError(f"auction_loop: unsupported device {costs.device}")
    dev = costs.device
    n, C = costs.shape
    S = prices0.shape[0] - 1
    sched = torch.as_tensor(np.asarray(eps_schedule, dtype=np.float32)).to(dev)
    Ps = 0 if slot_rows is None else int(slot_rows.shape[1])
    spec = [
        ("costs", costs, torch.float32, (n, C)),
        ("slots", slots, torch.int32, (n, C)),
        ("valid", valid, torch.bool, (n, C)),
        ("nm_cost", nm_cost, torch.float32, (n,)),
        ("prices0", prices0, torch.float32, (S + 1,)),
    ]
    for name, t, dtype, shape in (
        ("assigned0", assigned0, torch.int32, (n,)),
        ("owner0", owner0, torch.int32, (S + 1,)),
        ("slot_rows", slot_rows, torch.int32, (S, Ps)),
        ("slot_cols", slot_cols, torch.int32, (S, Ps)),
    ):
        if t is not None:
            spec.append((name, t, dtype, shape))
    if trace is not None:
        spec.append(("trace", trace, torch.float32, (int(max_rounds), 2)))
    if phase_cycles is not None:
        spec.append(("phase_cycles", phase_cycles, torch.int64, (5,)))
    _build.check_tensors("auction_loop", dev, spec)
    if (slot_rows is None) != (slot_cols is None):
        raise ValueError("auction_loop: slot_rows and slot_cols go together")

    lib = _lib()
    err = ctypes.c_int(0)
    ws_bytes = lib.same_auction_loop_workspace(n, S, ctypes.byref(err))
    _build.check(lib, err.value, "auction_loop (cluster query)")
    choice = torch.empty(n, dtype=torch.int32, device=dev)
    prices = torch.empty(S + 1, dtype=torch.float32, device=dev)
    owner = torch.empty(S + 1, dtype=torch.int32, device=dev)
    stats = torch.empty(10, dtype=torch.int64, device=dev)
    workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    rc = lib.same_auction_loop(
        costs.data_ptr(), slots.data_ptr(), valid.data_ptr(), nm_cost.data_ptr(),
        _ptr(slot_rows), _ptr(slot_cols), Ps,
        sched.data_ptr(), int(sched.shape[0]), prices0.data_ptr(),
        _ptr(assigned0), _ptr(owner0),
        n, C, S, int(max_rounds), int(max_polish), int(obj_patience or 0),
        float(np.float32(0.0 if obj_tol is None else obj_tol)),
        choice.data_ptr(), prices.data_ptr(), owner.data_ptr(), stats.data_ptr(),
        _ptr(trace), _ptr(phase_cycles), workspace.data_ptr(), ws_bytes,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "auction_loop")
    st = stats.cpu().tolist()  # the one host read of the solve
    _build.count_launch(auction_loop, last_stats={
        "rounds": st[0], "boundary_rounds": st[3],
        "active_bidder_rounds": st[4], "cluster_blocks": st[5], "unplaced_at_exit": st[6],
        "resolved_slot_rounds": st[7], "released_rows_read": st[8],
    })
    return AuctionResult(
        choice=choice, prices=prices, rounds=st[0], owner=owner,
        phase=st[1], polish=st[2],
    )


auction_loop.launches = 0
auction_loop.last_stats = {}


class AuctionBatchResult(NamedTuple):
    """Per-window results of a batched solve; rows of windows that were not
    solved are not written (their rounds, phase and polish read 0)."""

    choice: torch.Tensor   # [B, n] i32
    prices: torch.Tensor   # [B, S+1] f32
    owner: torch.Tensor    # [B, S+1] i32
    rounds: np.ndarray     # [B] i64
    phase: np.ndarray      # [B] i64
    polish: np.ndarray     # [B] i64


def _per_window(value, B, dtype):
    """A scalar or a length-B sequence as a [B] numpy array."""
    return np.broadcast_to(np.asarray(value, dtype=dtype), (B,)).copy()


def auction_loop_batch_plain(
    costs, slots, valid, nm_cost, prices0, eps_schedules, max_rounds,
    max_polish=64, assigned0=None, owner0=None, slot_rows=None, slot_cols=None,
    obj_patience=0, obj_tol=0.0, windows=None,
) -> AuctionBatchResult:
    """Plain version of K5: :func:`auction_loop_plain` on each listed window.

    Arguments as :func:`auction_loop_batch`.
    """
    B, n, _C = costs.shape
    S1 = prices0.shape[1]
    sched = np.asarray(eps_schedules, dtype=np.float32)
    budget = _per_window(max_rounds, B, np.int64)
    patience = _per_window(obj_patience, B, np.int64)
    tol = _per_window(obj_tol, B, np.float32)
    choice = torch.empty((B, n), dtype=torch.int32, device=costs.device)
    prices = torch.empty((B, S1), dtype=torch.float32, device=costs.device)
    owner = torch.empty((B, S1), dtype=torch.int32, device=costs.device)
    stats = np.zeros((3, B), np.int64)
    for b in range(B) if windows is None else windows:
        res = auction_loop_plain(
            costs[b], slots[b], valid[b], nm_cost[b], prices0[b], sched[b],
            int(budget[b]), max_polish=max_polish,
            assigned0=None if assigned0 is None else assigned0[b],
            owner0=None if owner0 is None else owner0[b],
            slot_rows=None if slot_rows is None else slot_rows[b],
            slot_cols=None if slot_cols is None else slot_cols[b],
            obj_patience=int(patience[b]), obj_tol=tol[b],
        )
        choice[b], prices[b], owner[b] = res.choice, res.prices, res.owner
        stats[:, b] = (res.rounds, res.phase, res.polish)
    return AuctionBatchResult(choice, prices, owner, *stats)


def cluster_shape(device):
    """(blocks, threads a block, clusters the card holds at once) of the
    solve's cluster on the CUDA ``device``; raises when the card cannot hold
    one."""
    with torch.cuda.device(device):
        lib = _lib()
        blocks, threads, err = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        held = lib.same_auction_loop_clusters(
            ctypes.byref(blocks), ctypes.byref(threads), ctypes.byref(err))
        _build.check(lib, err.value, "auction_loop (cluster query)")
    return blocks.value, threads.value, held


def auction_loop_batch(
    costs, slots, valid, nm_cost, prices0, eps_schedules, max_rounds,
    max_polish=64, assigned0=None, owner0=None, slot_rows=None, slot_cols=None,
    obj_patience=0, obj_tol=0.0, windows=None,
) -> AuctionBatchResult:
    """K5: one auction solve per listed window of a [B, ...] stack.

    ``costs``, ``slots``, ``valid`` are [B, n, C]; ``nm_cost`` [B, n];
    ``prices0`` [B, S+1]; ``slot_rows`` / ``slot_cols`` [B, S, Ps];
    ``assigned0`` / ``owner0`` [B, n] / [B, S+1] (every window warm) or None
    (every window cold). ``eps_schedules`` is a host [B, P] array;
    ``max_rounds``, ``obj_patience`` and ``obj_tol`` are scalars or one value
    per window. ``windows`` lists the batch indices to solve (None: all).
    CUDA tensors launch the kernel once (one cluster a listed window), CPU
    tensors take :func:`auction_loop_batch_plain`.
    """
    kw = dict(max_polish=max_polish, assigned0=assigned0, owner0=owner0,
              slot_rows=slot_rows, slot_cols=slot_cols,
              obj_patience=obj_patience, obj_tol=obj_tol, windows=windows)
    args = (costs, slots, valid, nm_cost, prices0, eps_schedules, max_rounds)
    if costs.device.type == "cpu":
        return auction_loop_batch_plain(*args, **kw)
    if costs.device.type != "cuda":
        raise ValueError(f"auction_loop_batch: unsupported device {costs.device}")
    dev = costs.device
    B, n, C = costs.shape
    S = prices0.shape[1] - 1
    sched = np.ascontiguousarray(eps_schedules, dtype=np.float32)
    if sched.ndim != 2 or sched.shape[0] != B:
        raise ValueError(f"auction_loop_batch: eps_schedules must be [{B}, P], got {sched.shape}")
    P = sched.shape[1]
    Ps = 0 if slot_rows is None else int(slot_rows.shape[2])
    spec = [
        ("costs", costs, torch.float32, (B, n, C)),
        ("slots", slots, torch.int32, (B, n, C)),
        ("valid", valid, torch.bool, (B, n, C)),
        ("nm_cost", nm_cost, torch.float32, (B, n)),
        ("prices0", prices0, torch.float32, (B, S + 1)),
    ]
    for name, t, dtype, shape in (
        ("assigned0", assigned0, torch.int32, (B, n)),
        ("owner0", owner0, torch.int32, (B, S + 1)),
        ("slot_rows", slot_rows, torch.int32, (B, S, Ps)),
        ("slot_cols", slot_cols, torch.int32, (B, S, Ps)),
    ):
        if t is not None:
            spec.append((name, t, dtype, shape))
    _build.check_tensors("auction_loop_batch", dev, spec)
    if (slot_rows is None) != (slot_cols is None):
        raise ValueError("auction_loop_batch: slot_rows and slot_cols go together")
    if (assigned0 is None) != (owner0 is None):
        raise ValueError("auction_loop_batch: assigned0 and owner0 go together")
    listed = np.arange(B) if windows is None else np.asarray(windows, np.int64)
    if listed.size and (listed.min() < 0 or listed.max() >= B):
        raise ValueError(f"auction_loop_batch: windows {listed} outside [0, {B})")

    # The per-window scalars, the schedules and the window list go up in one
    # int32 copy: [max_rounds | obj_patience | obj_tol bits | warm | sched | windows].
    warm = np.full(B, 0 if assigned0 is None else 1, np.int32)
    meta = np.concatenate([
        _per_window(max_rounds, B, np.int32),
        _per_window(obj_patience, B, np.int32),
        _per_window(obj_tol, B, np.float32).view(np.int32),
        warm, sched.reshape(-1).view(np.int32), listed.astype(np.int32),
    ])
    meta_d = torch.as_tensor(meta).to(dev)
    base = meta_d.data_ptr()
    at = [base + 4 * k * B for k in range(5)]
    windows_ptr = base + 4 * (4 * B + B * P)

    with torch.cuda.device(dev):
        lib = _lib()
        err = ctypes.c_int(0)
        ws_bytes = lib.same_auction_loop_workspace(n, S, ctypes.byref(err))
        _build.check(lib, err.value, "auction_loop_batch (cluster query)")
        choice = torch.empty((B, n), dtype=torch.int32, device=dev)
        prices = torch.empty((B, S + 1), dtype=torch.float32, device=dev)
        owner = torch.empty((B, S + 1), dtype=torch.int32, device=dev)
        stats = torch.zeros((B, 10), dtype=torch.int64, device=dev)
        workspace = torch.empty(B * ws_bytes, dtype=torch.uint8, device=dev)
        launches = ctypes.c_int(0)
        rc = lib.same_auction_loop_batch(
            costs.data_ptr(), slots.data_ptr(), valid.data_ptr(), nm_cost.data_ptr(),
            _ptr(slot_rows), _ptr(slot_cols), Ps,
            at[4], P, prices0.data_ptr(), _ptr(assigned0), _ptr(owner0), at[3],
            B, n, C, S, at[0], int(max_polish), at[1], at[2],
            windows_ptr, int(listed.size),
            choice.data_ptr(), prices.data_ptr(), owner.data_ptr(), stats.data_ptr(),
            workspace.data_ptr(), ws_bytes, torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(launches),
        )
        _build.check(lib, rc, "auction_loop_batch")
    st = stats.cpu().numpy()  # the one host read of the batch
    _build.count_launch(auction_loop_batch, n=launches.value, last_stats={
        "launches": launches.value, "windows": int(listed.size),
        "rounds": st[:, 0].tolist(), "boundary_rounds": st[:, 3].tolist(),
        "active_bidder_rounds": st[:, 4].tolist(),
        "cluster_blocks": int(st[listed, 5].max(initial=0)),
        "unplaced_at_exit": st[:, 6].tolist(), "resolved_slot_rounds": st[:, 7].tolist(),
        "released_rows_read": st[:, 8].tolist(),
    })
    return AuctionBatchResult(choice, prices, owner, st[:, 0].copy(), st[:, 1].copy(),
                              st[:, 2].copy())


auction_loop_batch.launches = 0
auction_loop_batch.last_stats = {}
