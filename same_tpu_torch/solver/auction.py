"""Jacobi auction solver with epsilon scaling, in PyTorch.

Port of ``same_tpu/solver/auction.py``; see that module for the design of
the asymmetric (reservation-option) auction: no per-phase reset, boundary
sweeps with a reverse-auction drain, reservation re-evaluation, and the
polish repeats of the final phase.

``_auction_run`` keeps the JAX loop's state and every numeric rule, but runs
as a Python loop over bidding rounds. The bidding round itself is kernel K1
(``kernels/auction_bid.py``); the boundary step with its 4 reverse drains,
the 4 final placement passes and the objective bookkeeping are plain torch
on the problem's device. Per round the host reads one small tensor (the
round's ``moved`` flag and, when the stall stop is on, the placement value)
and runs the phase / stall control on host scalars with f32 semantics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.auction_bid import auction_bid, top2
from ..models.assignment import AssignmentProblem, TorchProblem, to_device

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


def _auction_run(
    costs, slots, valid, nm_cost, prices0, eps_schedule, max_rounds,
    max_polish=64, assigned0=None, owner0=None,
    slot_rows=None, slot_cols=None,
    obj_patience=None, obj_tol=None, obj_band=None,
) -> AuctionResult:
    """Fused auction: all epsilon phases + polish, one bidding round per step.

    Same state, phase, polish and stall rules as
    ``same_tpu/solver/auction.py::_auction_run``; ``eps_schedule`` is a host
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
    phase, boundary, changed_in_phase, polish, it = 0, True, False, 0, 0
    best_obj = np.float32(np.inf)
    since_obj, phase_start = 0, 0
    last_stall_best = np.float32(np.inf)

    while phase < P and it < max_total:
        eps = float(sched[min(phase, P - 1)])
        boundary_moved = None
        if boundary:
            assigned, owner, prices, boundary_moved = _boundary_step(
                costs, slots_l, valid, nm_cost, prices, assigned, owner, eps,
                slot_rows, slot_cols,
            )

        new_assigned, new_owner, newp, moved_d = auction_bid(
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
        changed_in_phase = changed_in_phase or moved

        obj_improved = bool(cur_obj < best_obj - obj_tol)
        best_obj = min(best_obj, cur_obj)
        since_obj = 0 if obj_improved else since_obj + 1
        stall = obj_patience > 0 and (
            since_obj >= max(obj_patience, (it - phase_start) // 3)
        )

        # Phase-transition logic (fixed point OR stall), auction.py:342-376.
        fixed = not moved
        is_last = phase >= P - 1
        fixed_or_stall = fixed or stall
        drain_failed = bool(best_obj >= last_stall_best - obj_tol)
        stall_finish = stall and is_last and (drain_failed or polish >= max_polish)
        stall_repeat = stall and is_last and not stall_finish
        repeat_last = (
            fixed and is_last and changed_in_phase and polish < max_polish
            and not stall
        )
        finish = (
            fixed and is_last and (not changed_in_phase or polish >= max_polish)
        ) or stall_finish
        advance = fixed_or_stall and not is_last

        phase = P if finish else (phase + 1 if advance else phase)
        if repeat_last or stall_repeat:
            polish += 1
        boundary = fixed_or_stall
        if fixed_or_stall:
            changed_in_phase = False
        if advance or stall_repeat:
            phase_start = it + 1
            since_obj = 0
        if stall_repeat:
            last_stall_best = best_obj
        assigned, owner, prices = new_assigned, new_owner, newp
        it += 1

    exit_phase, exit_polish = phase, polish
    # Final placement for bidders still unassigned at the round cap (4
    # passes, verbatim), then the rest go to no-match.
    for _ in range(4):
        assigned, owner, prices = _place_once(
            costs, slots_l, valid, nm_cost, assigned, owner, prices
        )
    assigned = torch.where(assigned < 0, C, assigned)
    return AuctionResult(
        choice=assigned, prices=prices, rounds=it, owner=owner,
        phase=exit_phase, polish=exit_polish,
    )


def natural_stop_args(n: int, eps_final: float, patience: int = 128):
    """Host-scalar args for the auction's objective-plateau stop.

    The improvement tolerance and the near-best band scale with n * eps;
    ``patience <= 0`` disables the stop (budget-only termination).
    """
    p = 0 if patience is None else int(patience)
    return (
        p,
        np.float32(float(eps_final) * max(n / 16.0, 1.0)),
        np.float32(float(eps_final) * max(n / 8.0, 1.0)),
    )


SCHEDULE_LEN = 16


def make_eps_schedule(
    cost_scale: float, eps_final: float, scaling: float
) -> np.ndarray:
    """Geometric epsilon schedule from ~cost_scale/2 down to eps_final.

    Padded to a fixed length (trailing eps_final repeats, which are cheap
    no-op phases at the fixed point).
    """
    eps_final = max(float(eps_final), 1e-6)
    eps0 = max(cost_scale / 2.0, eps_final)
    n_phases = max(1, int(math.ceil(math.log(eps0 / eps_final) / math.log(scaling))) + 1)
    eps = eps0 / (scaling ** np.arange(n_phases))
    eps = np.maximum(eps, eps_final)
    if len(eps) < SCHEDULE_LEN:
        eps = np.concatenate([eps, np.full(SCHEDULE_LEN - len(eps), eps_final)])
    eps[-1] = eps_final
    return eps.astype(np.float32)


def default_eps_schedule(
    problem: AssignmentProblem, eps_final: float, eps_scaling: float = 4.0
) -> np.ndarray:
    """Epsilon schedule sized to the problem's cost scale."""
    finite = np.asarray(problem.costs)[np.asarray(problem.valid)]
    scale_candidates = [float(np.max(problem.nm_cost, initial=0.0))]
    if finite.size:
        scale_candidates.append(float(finite.max() - finite.min()))
    return make_eps_schedule(max(scale_candidates + [1.0]), eps_final, eps_scaling)


def warm_eps_schedule(
    eps_final: float, perturbation_scale: float, cost_scale: float,
    scaling: float = 8.0,
) -> np.ndarray:
    """Epsilon schedule for a warm re-solve after a bounded cost perturbation.

    Restarts at eps ~ perturbation/2 (capped at cost_scale/2) so displaced
    holders cross a cut surcharge in a handful of bids.
    """
    eps_final = max(float(eps_final), 1e-7)
    eps0 = min(
        max(float(perturbation_scale), eps_final * 64.0),
        max(float(cost_scale) / 2.0, eps_final),
    )
    n_phases = max(
        2, int(math.ceil(math.log(max(eps0 / eps_final, 1.0001)) / math.log(scaling))) + 1
    )
    eps = eps0 / (scaling ** np.arange(n_phases))
    eps = np.maximum(eps, eps_final)
    eps[-1] = eps_final
    return eps.astype(np.float32)


def solve_assignment(
    problem,
    eps_final: float = 1e-2,
    eps_scaling: float = 4.0,
    max_rounds: int = 500000,
    prices0=None,
    extra_costs=None,
    eps_schedule: np.ndarray | None = None,
    return_raw: bool = False,
    obj_patience: int = 0,
    device=None,
):
    """Solve a window assignment problem; returns (match_ref, match_pair, info).

    ``problem`` is a numpy :class:`AssignmentProblem` (uploaded to
    ``device``, default CPU) or a :class:`TorchProblem` already on its
    device. ``prices0`` and ``extra_costs`` may be arrays or tensors.
    ``obj_patience`` enables the objective-stall termination (0 keeps the
    exact fixed-point semantics). ``return_raw`` returns the device-resident
    :class:`AuctionResult`.
    """
    if not isinstance(problem, TorchProblem):
        problem = to_device(problem, device if device is not None else "cpu")
    host = problem.host
    dev = problem.costs.device
    costs = problem.costs
    if extra_costs is not None:
        costs = costs + torch.as_tensor(extra_costs, dtype=costs.dtype, device=dev)

    if eps_schedule is None and prices0 is not None:
        # Warm-started solve: skip the coarse price-building phases.
        eps_schedule = np.asarray(
            [eps_final * 64, eps_final * 8, eps_final], np.float32
        )
    if eps_schedule is None:
        eps_schedule = default_eps_schedule(host, eps_final, eps_scaling)
    else:
        eps_schedule = np.asarray(eps_schedule, dtype=np.float32)
        if len(eps_schedule) < SCHEDULE_LEN:
            eps_schedule = np.concatenate(
                [
                    eps_schedule,
                    np.full(
                        SCHEDULE_LEN - len(eps_schedule),
                        eps_schedule[-1],
                        dtype=np.float32,
                    ),
                ]
            )

    S = host.n_slots
    if prices0 is None:
        prices = torch.zeros(S + 1, dtype=costs.dtype, device=dev)
    else:
        prices = torch.as_tensor(prices0, dtype=costs.dtype).to(dev)

    obj_args = natural_stop_args(
        host.costs.shape[0], float(eps_schedule[-1]), obj_patience
    )
    result = _auction_run(
        costs, problem.slots, problem.valid, problem.nm_cost, prices,
        eps_schedule, max_rounds=max_rounds,
        slot_rows=problem.slot_rows, slot_cols=problem.slot_cols,
        obj_patience=obj_args[0], obj_tol=obj_args[1], obj_band=obj_args[2],
    )
    if return_raw:
        return result

    n = host.n_aligned
    C = host.costs.shape[1]
    choice = result.choice.cpu().numpy()[:n]
    col = np.clip(choice, 0, C - 1)
    rows = np.arange(n)
    is_match = choice < C
    match_ref = np.where(is_match, host.cand_ref[rows, col], -1).astype(np.int64)
    match_pair = np.where(is_match, host.pair_idx[rows, col], -1).astype(np.int64)
    info = {
        "prices": result.prices.cpu().numpy(),
        "prices_dev": result.prices,  # device-resident copy for warm restarts
        "rounds": int(result.rounds),
        "phase": int(result.phase),
        "polish": int(result.polish),
        "eps_schedule": eps_schedule,
    }
    return match_ref, match_pair, info
