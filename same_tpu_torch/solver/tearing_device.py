"""Device-resident space-tearing loop, in PyTorch.

Port of ``same_tpu/solver/tearing_device.py``. Each tear round re-solves the
auction (kernel K1 inside), runs the flip test and the regret-directed choice
of the vertex to move (kernel K2), scores the incumbent, registers cuts in a
per-triangle dedup memory and surcharges the cheapest-to-move pair. All
tensors stay on the device between rounds; the host reads a handful of
scalars per round and takes the stop decisions on them with f32 semantics,
and pulls every incumbent in one transfer at the end.

Semantics match the JAX loop, including its one bounded deviation from the
host loop: per-triangle cut dedup memory holds at most ``K`` distinct
triples. The per-solve round budget formula, the cold restart every 4th
round and the cold/warm schedules are kept verbatim.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.tear_metrics import tear_metrics
from ..models.assignment import AssignmentProblem, default_device, to_device
from .auction import (
    _auction_run,
    default_eps_schedule,
    natural_stop_args,
    warm_eps_schedule,
)

_HARD_PENALTY = 1e7


class LoopInputs(NamedTuple):
    """The window's device tensors and the loop's f32 / int knobs."""

    costs: torch.Tensor
    slots: torch.Tensor
    valid: torch.Tensor
    nm: torch.Tensor
    pair_idx: torch.Tensor
    cand_ref: torch.Tensor
    slot_rows: torch.Tensor
    slot_cols: torch.Tensor
    tris: torch.Tensor          # [T, 3] i32
    tri_mask: torch.Tensor      # [T] bool
    src: torch.Tensor           # [T] i32
    ref_xy: torch.Tensor        # [m, 2] f32
    tri_weights: torch.Tensor   # [T] f32
    full_schedule: np.ndarray
    warm_schedule: np.ndarray
    delaunay_penalty: np.float32
    allowed_flip_fraction: np.float32
    penalty_coeff: np.float32
    hard: bool
    patience: int
    plateau_tol: np.float32
    obj_patience: int
    obj_tol: np.float32
    obj_band: np.float32
    gap_stop: np.float32


@dataclass
class TearState:
    """Loop state: device tensors plus the host scalars of the stop logic."""

    extra: torch.Tensor         # [n, C] f32 cut surcharges
    prices: torch.Tensor        # [S+1] f32
    assigned_c: torch.Tensor    # [n] i32 carried assignments
    owner_c: torch.Tensor       # [S+1] i32 carried slot owners
    r: int
    cuts_added: int
    stop: bool
    cut_mem: torch.Tensor       # [T, K, 3] i32 (-2 = empty)
    cut_cnt: torch.Tensor       # [T] i32
    all_choices: torch.Tensor   # [R, n] i32
    all_flipped: torch.Tensor   # [R, T] bool
    all_checked: torch.Tensor   # [R, T] bool
    all_rounds: np.ndarray      # [R] i32 auction rounds per tear round
    best_score: np.float32      # best incumbent score so far
    since_improve: int          # rounds since improvement
    best_r: int                 # round index of best incumbent


def _tearing_loop(
    inp: LoopInputs, state: TearState, r_end: int, *, L: int, K: int,
    max_tear_rounds: int, max_rounds: int, max_cuts_per_round: int,
    max_cuts_total: int, carry: bool = True, warm_max_rounds: int = 0,
) -> TearState:
    """One guarded tear round (same_tpu/solver/tearing_device.py:67-272)."""
    R = max_tear_rounds
    if state.stop or not state.r < min(r_end, R):
        return state
    costs = inp.costs
    n, C = costs.shape
    dev = costs.device
    r = state.r
    extra = state.extra

    # Warm-carry assignments and ownership across tear rounds; every 4th
    # round restarts from a cold assignment (prices kept). Round 0 uses the
    # full coarse-to-fine schedule, later rounds the surcharge-sized one.
    if carry:
        cold = (r % 4) == 0
        sched = inp.full_schedule if r == 0 else inp.warm_schedule
        assigned_in = (
            torch.full_like(state.assigned_c, -1) if cold else state.assigned_c
        )
        owner_in = torch.full_like(state.owner_c, -1) if cold else state.owner_c
        prices_in = state.prices
        warm_b = warm_max_rounds if warm_max_rounds else max_rounds
        rounds_budget = (
            (max_rounds if r == 0 else max_rounds // 2) if cold else warm_b
        )
    else:
        sched = inp.full_schedule
        assigned_in = torch.full_like(state.assigned_c, -1)
        owner_in = torch.full_like(state.owner_c, -1)
        prices_in = torch.zeros_like(state.prices)
        rounds_budget = max_rounds
    res = _auction_run(
        costs + extra, inp.slots, inp.valid, inp.nm, prices_in, sched,
        max_rounds=rounds_budget, assigned0=assigned_in, owner0=owner_in,
        slot_rows=inp.slot_rows, slot_cols=inp.slot_cols,
        obj_patience=inp.obj_patience, obj_tol=inp.obj_tol,
        obj_band=inp.obj_band,
    )
    choice = res.choice
    col = choice.clamp(0, C - 1).long()
    is_match = choice < C
    match_pair = torch.where(is_match, inp.pair_idx.gather(1, col[:, None])[:, 0], -1)
    match_ref = torch.where(is_match, inp.cand_ref.gather(1, col[:, None])[:, 0], -1)

    # Flip test + regret-directed vertex choice at this round's surcharges
    # and the re-solve's prices: kernel K2.
    checked, flipped, vmove = tear_metrics(
        costs, extra, inp.slots, inp.valid, inp.nm, inp.pair_idx,
        inp.cand_ref, inp.tris, inp.tri_mask, inp.src, inp.ref_xy,
        res.prices, choice,
    )
    state.all_choices[r] = choice
    state.all_flipped[r] = flipped
    state.all_checked[r] = checked
    state.all_rounds[r] = res.rounds

    # Incumbent score (flips-pay search objective): the f32 sums on the
    # device, then one read of the six scalars.
    m_ref = inp.ref_xy.shape[0]
    rows = torch.arange(n, device=dev)
    base_sum = torch.where(is_match, costs[rows, col], inp.nm).sum()
    u_ref = torch.zeros(m_ref, dtype=torch.float32, device=dev).index_add(
        0, match_ref.clamp(0, m_ref - 1).long(), is_match.to(torch.float32)
    )
    over = torch.clamp_min(u_ref - 1.0, 0.0).sum()
    flip_w = torch.where(flipped, inp.tri_weights, 0.0).sum()
    checkable_w = torch.where(
        inp.tri_mask & (inp.src != 0), inp.tri_weights, 0.0
    ).sum()
    scal = torch.stack([
        base_sum, over, flip_w, checkable_w,
        checked.sum().to(torch.float32), flipped.sum().to(torch.float32),
    ]).cpu().numpy()
    base_sum, over, flip_w, checkable_w = (np.float32(v) for v in scal[:4])
    n_checked, n_flipped = int(scal[4]), int(scal[5])

    dp = inp.delaunay_penalty
    aff = inp.allowed_flip_fraction
    with np.errstate(invalid="ignore", over="ignore"):
        frac_ok = np.float32(n_flipped) <= aff * np.float32(n_checked)
        base_cost = base_sum + inp.penalty_coeff * over
        allowance = dp * max(aff, np.float32(0.0)) * checkable_w
        hinge = max(np.float32(0.0), dp * flip_w - allowance)
        score = base_cost + hinge
        # Relative-margin improvement test; at round 0 the JAX expression
        # inf - tol * inf is NaN, so the first incumbent never "improves".
        improved = bool(
            score < state.best_score - inp.plateau_tol * abs(state.best_score)
            - np.float32(1e-6)
        )
        best_score = min(state.best_score, score)
        gap_certified = bool(
            inp.gap_stop > 0.0
            and r == 0
            and not inp.hard
            and hinge <= inp.gap_stop * (base_cost + hinge)
        )
    since_improve = 0 if improved else state.since_improve + 1
    best_r = r if improved else state.best_r

    stop_now = (
        n_checked == 0
        or n_flipped == 0
        or bool(frac_ok)
        or gap_certified
        or state.cuts_added >= max_cuts_total
        or (inp.patience >= 0 and since_improve >= inp.patience)
        or (dp == 0.0 and not inp.hard)
    )

    added = 0
    if not stop_now:
        # --- Cut registration (vectorized over triangles) ---------------
        tris_l = inp.tris.long()
        tri_pairs = match_pair[tris_l]                         # [T, 3]
        all_matched = (tri_pairs >= 0).all(dim=1)
        is_dup = (state.cut_mem == tri_pairs[:, None, :]).all(dim=2).any(dim=1)
        can_store = state.cut_cnt < K
        new_cut = flipped & all_matched & ~is_dup & can_store
        # Per-round + global caps, honored in triangle-index order.
        rank = torch.cumsum(new_cut.to(torch.int64), 0) - 1
        new_cut = new_cut & (rank < max_cuts_per_round) & (
            state.cuts_added + rank < max_cuts_total
        )
        idx = new_cut.nonzero()[:, 0]
        added = int(idx.numel())
        if added:
            state.cut_mem[idx, state.cut_cnt[idx].long()] = tri_pairs[idx]
            state.cut_cnt += new_cut.to(torch.int32)

            # Regret-directed surcharge on the cheapest-to-move pair, over
            # the pair's L-column block. Duplicate (vertex, column) targets
            # accumulate in an unspecified order on a card; the surcharges
            # are dp * tri_weight (dp * integer cell counts), exact in f32.
            v_t = inp.tris.gather(1, vmove.long()[:, None])[:, 0][idx].long()
            col_t = choice[v_t.clamp(0, n - 1)].clamp(0, C - 1).long()
            blk_t = (col_t // L) * L
            if inp.hard:
                upd = torch.full((added,), _HARD_PENALTY, dtype=torch.float32, device=dev)
            else:
                upd = (dp * inp.tri_weights)[idx]
            for s in range(L):
                extra.index_put_(
                    (v_t, (blk_t + s).clamp(0, C - 1)), upd, accumulate=True
                )

    state.extra = extra
    state.prices = res.prices
    state.assigned_c = res.choice
    state.owner_c = res.owner
    state.r = r + 1
    state.cuts_added += added
    state.stop = stop_now or added == 0
    state.best_score = best_score
    state.since_improve = since_improve
    state.best_r = best_r
    return state


def _init_state(n, C, T, K, R, prices0) -> TearState:
    dev = prices0.device
    return TearState(
        extra=torch.zeros((n, C), dtype=prices0.dtype, device=dev),
        prices=prices0,
        assigned_c=torch.full((n,), -1, dtype=torch.int32, device=dev),
        owner_c=torch.full((prices0.shape[0],), -1, dtype=torch.int32, device=dev),
        r=0,
        cuts_added=0,
        stop=False,
        cut_mem=torch.full((T, K, 3), -2, dtype=torch.int32, device=dev),
        cut_cnt=torch.zeros(T, dtype=torch.int32, device=dev),
        all_choices=torch.full((R, n), C, dtype=torch.int32, device=dev),
        all_flipped=torch.zeros((R, T), dtype=torch.bool, device=dev),
        all_checked=torch.zeros((R, T), dtype=torch.bool, device=dev),
        all_rounds=np.zeros(R, np.int32),
        best_score=np.float32(np.inf),
        since_improve=0,
        best_r=0,
    )


def _registry_from_memory(tris, cut_mem, cut_cnt):
    """Decode the per-triangle cut-dedup memory into registry lists."""
    cut_tris, cut_verts, cut_pairs = [], [], []
    for t in np.flatnonzero(cut_cnt > 0):
        for k in range(int(cut_cnt[t])):
            cut_tris.append(int(t))
            cut_verts.append(np.asarray(tris[t]).copy())
            cut_pairs.append(cut_mem[t, k].astype(np.int64))
    return cut_tris, cut_verts, cut_pairs


def run_tearing_device(
    problem: AssignmentProblem,
    tris: np.ndarray,
    tri_weights: np.ndarray,
    source_signs: np.ndarray,
    ref_coords: np.ndarray,
    delaunay_penalty: float,
    allowed_flip_fraction: float,
    penalty_coeff: float = 100.0,
    max_cuts=None,
    max_cuts_per_round: int = 1000,
    max_tear_rounds: int = 25,
    eps_final: float = 1e-2,
    eps_scaling: float = 4.0,
    hard: bool = False,
    max_rounds: int = 60000,
    K: int = 6,
    prices0=None,
    deadline=None,
    carry: bool = True,
    plateau_patience=6,
    plateau_tol: float = 0.0,
    obj_patience: int = 128,
    mip_gap=None,
    on_round=None,
    device=None,
):
    """Run the fused tearing loop on ``device``; returns host-side round data.

    Returns a dict with per-round incumbents (choices [R_used, n_pad]),
    flipped/checked masks, auction round counts, and the reconstructed cut
    registry (tri indices, vertex triples, pair triples). ``deadline``
    (absolute time.time()) is checked between rounds; ``on_round(r,
    since_improve, state)`` runs after every round that does not stop.
    """
    import time as _time

    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    T = len(tris)
    if T == 0:
        raise ValueError("run_tearing_device requires at least one triangle")
    n_pad, C = problem.costs.shape
    L = int(problem.n_slot_copies)
    device = torch.device(device) if device is not None else default_device()

    # Re-solve schedule sized to the cut surcharge (see warm_eps_schedule).
    finite = np.asarray(problem.costs)[np.asarray(problem.valid)]
    cost_scale = max(
        float(np.max(problem.nm_cost, initial=0.0)),
        float(finite.max() - finite.min()) if finite.size else 1.0,
    )
    surcharge = float(delaunay_penalty) * float(np.max(tri_weights, initial=1.0))
    warm_sched = warm_eps_schedule(eps_final, surcharge, cost_scale)
    # A warm price start skips the coarse price-building phases on round 0.
    full_sched = (
        warm_sched.copy()
        if prices0 is not None
        else default_eps_schedule(problem, eps_final, eps_scaling)
    )
    # Equal-length schedules, padded with eps_final (tearing_device.py:364-373).
    pad_len = max(len(warm_sched), len(full_sched))
    warm_sched, full_sched = (
        np.concatenate([s, np.full(pad_len - len(s), eps_final, np.float32)])
        if len(s) < pad_len else s
        for s in (warm_sched, full_sched)
    )

    pd = to_device(problem, device)
    obj_p, obj_tol, obj_band = natural_stop_args(n_pad, float(eps_final), obj_patience)
    inp = LoopInputs(
        costs=pd.costs, slots=pd.slots, valid=pd.valid, nm=pd.nm_cost,
        pair_idx=pd.pair_idx, cand_ref=pd.cand_ref, slot_rows=pd.slot_rows,
        slot_cols=pd.slot_cols,
        tris=torch.as_tensor(np.ascontiguousarray(tris, np.int32)).to(device),
        tri_mask=torch.ones(T, dtype=torch.bool, device=device),
        src=torch.as_tensor(np.ascontiguousarray(source_signs, np.int32)).to(device),
        ref_xy=torch.as_tensor(np.ascontiguousarray(ref_coords, np.float32)).to(device),
        tri_weights=torch.as_tensor(np.ascontiguousarray(tri_weights, np.float32)).to(device),
        full_schedule=full_sched,
        warm_schedule=warm_sched,
        delaunay_penalty=np.float32(delaunay_penalty),
        allowed_flip_fraction=np.float32(
            allowed_flip_fraction if allowed_flip_fraction is not None else -1.0
        ),
        penalty_coeff=np.float32(penalty_coeff),
        hard=bool(hard),
        patience=-1 if plateau_patience is None else int(plateau_patience),
        plateau_tol=np.float32(plateau_tol),
        obj_patience=obj_p,
        obj_tol=obj_tol,
        obj_band=obj_band,
        gap_stop=np.float32(mip_gap if mip_gap is not None else -1.0),
    )
    # Per-solve auction-round budget, verbatim from the JAX loop (a model of
    # TPU per-round cost; it changes results, so the port keeps it).
    per_round_s = 1e-4 + n_pad * C * 1.2e-8
    max_rounds = max(
        1024, min(max_rounds, n_pad, int(15.0 / per_round_s))
    )
    kwargs = dict(
        L=L,
        K=K,
        max_tear_rounds=max_tear_rounds,
        max_rounds=max_rounds,
        warm_max_rounds=max(1024, max_rounds // 8),
        max_cuts_per_round=int(max_cuts_per_round),
        max_cuts_total=int(max_cuts) if max_cuts is not None else 1 << 30,
        carry=carry,
    )
    if prices0 is not None:
        prices_init = torch.as_tensor(
            np.asarray(prices0, problem.costs.dtype)
        ).to(device)
    else:
        prices_init = torch.zeros(problem.n_slots + 1, dtype=torch.float32, device=device)
    state = _init_state(n_pad, C, T, K, max_tear_rounds, prices_init)
    r_host = 0
    time_limit_reached = False
    device_time = 0.0
    while r_host < max_tear_rounds:
        t_round = _time.time()
        state = _tearing_loop(inp, state, r_host + 1, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        r_host = state.r
        device_time += _time.time() - t_round
        if state.stop or r_host >= max_tear_rounds:
            break
        if deadline is not None and _time.time() > deadline:
            time_limit_reached = True
            break
        if on_round is not None:
            # Mid-loop hook (speculative repair overlap, tearing.py).
            on_round(r_host, state.since_improve, state)

    # Single bulk transfer of everything else the host needs.
    r = r_host
    cut_mem = state.cut_mem.cpu().numpy()
    cut_cnt = state.cut_cnt.cpu().numpy()
    cut_tris, cut_verts, cut_pairs = _registry_from_memory(tris, cut_mem, cut_cnt)
    return {
        "rounds_used": r,
        "cuts_added": int(state.cuts_added),
        "time_limit_reached": time_limit_reached,
        "choices": state.all_choices[:r].cpu().numpy(),
        "flipped": state.all_flipped[:r].cpu().numpy(),
        "checked": state.all_checked[:r].cpu().numpy(),
        "auction_rounds": state.all_rounds[:r].copy(),
        "cut_tris": cut_tris,
        "cut_verts": cut_verts,
        "cut_pairs": cut_pairs,
        "device_time": device_time,
    }


def snapshot_best_incumbent(state: TearState):
    """Pull the best-so-far incumbent + cut registry as host arrays.

    Used by the speculative-repair hook (tearing.py) on the main thread.
    Returns (best_r, choice, flipped, checked, cut_mem, cut_cnt, cuts_added).
    """
    br = int(state.best_r)
    return (
        br,
        state.all_choices[br].cpu().numpy(),
        state.all_flipped[br].cpu().numpy(),
        state.all_checked[br].cpu().numpy(),
        state.cut_mem.cpu().numpy(),
        state.cut_cnt.cpu().numpy(),
        int(state.cuts_added),
    )
