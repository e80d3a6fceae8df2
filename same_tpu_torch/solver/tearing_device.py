"""Device-resident space-tearing loop, in PyTorch.

Port of ``same_tpu/solver/tearing_device.py``. Each tear round re-solves the
auction (one ``auction_loop`` launch), runs the flip test and the
regret-directed choice of the vertex to move (kernel K2), takes the six
values of the stop rule (kernel K7 ``tear_scalars``), and registers cuts in
a per-triangle dedup memory with the surcharge on the cheapest-to-move pair
(kernel K8 ``register_cuts``). All tensors stay on the device between
rounds; the host reads the six values and the cuts added once each a round,
takes the stop decisions on them with f32 semantics, and pulls every
incumbent in one transfer at the end.

Semantics match the JAX loop, including its one bounded deviation from the
host loop: per-triangle cut dedup memory holds at most ``K`` distinct
triples. The per-solve round budget formula, the cold restart every 4th
round and the cold/warm schedules are kept verbatim.

``run_tearing_device_batch`` runs the same loop for a batch of same-bucket
windows stacked on a leading axis (the JAX package's vmapped loop): each
round is one K5 ``auction_loop_batch`` launch for the windows still running,
one K6 ``tear_metrics_batch`` launch, one K7 and one K8 launch over the
stacked tensors. A window that has stopped is frozen. Given the batch's
round budget and schedule length, every window's rounds are bit-equal to
the solo loop's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np
import torch

from ..kernels.auction_loop import auction_loop, auction_loop_batch
from ..kernels.tear_metrics import tear_metrics, tear_metrics_batch
from ..kernels.tear_round import register_cuts, tear_scalars
from ..models.assignment import (
    AssignmentProblem,
    default_device,
    resolve_device,
    to_device,
)
from ..trace import span
from .auction import (
    default_eps_schedule,
    natural_stop_args,
    warm_eps_schedule,
)

_HARD_PENALTY = 1e7


class Knobs(NamedTuple):
    """One window's f32 / int knobs of the stop rule and the auction."""

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


def _knobs(delaunay_penalty, allowed_flip_fraction, penalty_coeff, hard,
           plateau_patience, plateau_tol, n_pad, eps_final, obj_patience,
           mip_gap) -> Knobs:
    obj_p, obj_tol, obj_band = natural_stop_args(n_pad, float(eps_final), obj_patience)
    return Knobs(
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


def round_budget(n_pad: int, C: int, n_local: int = 1, max_rounds: int = 60000) -> int:
    """Per-solve auction-round budget, verbatim from the JAX loop
    (tearing_device.py:410-420; :679-690 with ``n_local`` windows a device).

    A model of the TPU's per-round cost (~0.1 ms dispatch + ~12 ps an element
    of the [n_pad, C] tensors, 15 s an execution); it changes results, so the
    port keeps it.
    """
    per_round_s = 1e-4 + n_local * n_pad * C * 1.2e-8
    return max(1024, min(max_rounds, n_pad, int(15.0 / per_round_s)))


def window_schedules(problem, tri_weights, delaunay_penalty, eps_final,
                     eps_scaling, warm_start):
    """(full, warm) epsilon schedules of one window, unpadded: the warm one
    sized to the cut surcharge (see warm_eps_schedule), the full one
    coarse-to-fine, or the warm one when the prices start warm (the coarse
    price-building phases are then skipped on round 0)."""
    finite = np.asarray(problem.costs)[np.asarray(problem.valid)]
    cost_scale = max(
        float(np.max(problem.nm_cost, initial=0.0)),
        float(finite.max() - finite.min()) if finite.size else 1.0,
    )
    surcharge = float(delaunay_penalty) * float(np.max(tri_weights, initial=1.0))
    warm = warm_eps_schedule(eps_final, surcharge, cost_scale)
    full = warm.copy() if warm_start else default_eps_schedule(problem, eps_final, eps_scaling)
    return full, warm


class LoopInputs(NamedTuple):
    """The window's device tensors, epsilon schedules and knobs."""

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
    surcharge: torch.Tensor     # [T] f32 a cut on each triangle adds
    m_ref: torch.Tensor         # [1] i32, m
    full_schedule: np.ndarray
    warm_schedule: np.ndarray
    knobs: Knobs


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


def _resolve_args(r, max_rounds, warm_max_rounds):
    """(cold, first, round budget) of tear round ``r`` with carried state
    (tearing_device.py:80-102): every 4th round restarts from a cold
    assignment (prices kept); round 0 (``first``) takes the full
    coarse-to-fine schedule and the whole budget, later cold restarts half of
    it, warm re-solves the warm schedule and budget."""
    cold = (r % 4) == 0
    warm_b = warm_max_rounds if warm_max_rounds else max_rounds
    budget = (max_rounds if r == 0 else max_rounds // 2) if cold else warm_b
    return cold, r == 0, budget


def _score_and_stop(scal, r, kn: Knobs, best_score, since_improve, best_r,
                    cuts_added, max_cuts_total):
    """Incumbent score, plateau bookkeeping and stop test of one window's
    round (same_tpu/solver/tearing_device.py:138-207) on the host scalars of
    :func:`~same_tpu_torch.kernels.tear_round.tear_scalars`, with f32
    semantics. Returns (best_score, since_improve, best_r, stop_now)."""
    base_sum, over, flip_w, checkable_w = (np.float32(v) for v in scal[:4])
    n_checked, n_flipped = int(scal[4]), int(scal[5])
    dp = kn.delaunay_penalty
    aff = kn.allowed_flip_fraction
    with np.errstate(invalid="ignore", over="ignore"):
        frac_ok = np.float32(n_flipped) <= aff * np.float32(n_checked)
        base_cost = base_sum + kn.penalty_coeff * over
        allowance = dp * max(aff, np.float32(0.0)) * checkable_w
        hinge = max(np.float32(0.0), dp * flip_w - allowance)
        score = base_cost + hinge
        # Relative-margin improvement test; at round 0 the JAX expression
        # inf - tol * inf is NaN, so the first incumbent never "improves".
        improved = bool(
            score < best_score - kn.plateau_tol * abs(best_score)
            - np.float32(1e-6)
        )
        best_score = min(best_score, score)
        gap_certified = bool(
            kn.gap_stop > 0.0
            and r == 0
            and not kn.hard
            and hinge <= kn.gap_stop * (base_cost + hinge)
        )
    since_improve = 0 if improved else since_improve + 1
    best_r = r if improved else best_r
    stop_now = (
        n_checked == 0
        or n_flipped == 0
        or bool(frac_ok)
        or gap_certified
        or cuts_added >= max_cuts_total
        or (kn.patience >= 0 and since_improve >= kn.patience)
        or (dp == 0.0 and not kn.hard)
    )
    return best_score, since_improve, best_r, stop_now


def _cut_surcharge(tri_weights, kn: Knobs):
    """[T] f32 surcharge a cut on each triangle adds: dp x its weight, or the
    hard penalty."""
    if kn.hard:
        return torch.full_like(tri_weights, _HARD_PENALTY)
    return kn.delaunay_penalty * tri_weights


def _tearing_loop(
    inp: LoopInputs, state: TearState, r_end: int, *, L: int, K: int,
    max_tear_rounds: int, max_rounds: int, max_cuts_per_round: int,
    max_cuts_total: int, carry: bool = True, warm_max_rounds: int = 0,
    times=None,
) -> TearState:
    """One guarded tear round (same_tpu/solver/tearing_device.py:67-272).
    The host's waits on the card (the auction's read of its counters, the
    reads of K7's values and of K8's cuts added) are the spans
    ``device_wait`` in ``times``."""
    R = max_tear_rounds
    if state.stop or not state.r < min(r_end, R):
        return state
    costs = inp.costs
    r = state.r
    extra = state.extra
    kn = inp.knobs

    if carry:
        cold, first, rounds_budget = _resolve_args(r, max_rounds, warm_max_rounds)
        sched = inp.full_schedule if first else inp.warm_schedule
        assigned_in = (
            torch.full_like(state.assigned_c, -1) if cold else state.assigned_c
        )
        owner_in = torch.full_like(state.owner_c, -1) if cold else state.owner_c
        prices_in = state.prices
    else:
        # Fresh solve of the surcharged problem each round.
        sched = inp.full_schedule
        assigned_in = torch.full_like(state.assigned_c, -1)
        owner_in = torch.full_like(state.owner_c, -1)
        prices_in = torch.zeros_like(state.prices)
        rounds_budget = max_rounds
    with span(times, "device_wait"):
        res = auction_loop(
            costs + extra, inp.slots, inp.valid, inp.nm, prices_in, sched,
            max_rounds=rounds_budget, assigned0=assigned_in, owner0=owner_in,
            slot_rows=inp.slot_rows, slot_cols=inp.slot_cols,
            obj_patience=kn.obj_patience, obj_tol=kn.obj_tol,
            obj_band=kn.obj_band,
        )
    choice = res.choice

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

    # Incumbent score (flips-pay search objective): the six values on the
    # device (K7), then one read of them. The [1, ...] views share storage.
    with span(times, "device_wait"):
        scal = tear_scalars(
            costs[None], inp.nm[None], choice[None], inp.cand_ref[None], inp.ref_xy[None],
            inp.m_ref, flipped[None], checked[None], inp.tri_weights[None],
            inp.tri_mask[None], inp.src[None],
        )[0].cpu().numpy()
    best_score, since_improve, best_r, stop_now = _score_and_stop(
        scal, r, kn, state.best_score, state.since_improve, state.best_r,
        state.cuts_added, max_cuts_total,
    )

    added = 0
    if not stop_now:
        # Cut registration and surcharge (K8) write the registry and
        # ``extra`` in place; one read of the cuts added.
        with span(times, "device_wait"):
            added = int(register_cuts(
                inp.tris[None], inp.surcharge[None], choice[None], inp.pair_idx[None],
                flipped[None], vmove[None], np.ones(1, bool), np.array([state.cuts_added]),
                state.cut_mem[None], state.cut_cnt[None], extra[None], L=L, K=K,
                max_cuts_per_round=max_cuts_per_round, max_cuts_total=max_cuts_total,
            )[0])

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
    schedule_len=None,
    times=None,
):
    """Run the fused tearing loop on ``device``; returns host-side round data.

    Returns a dict with per-round incumbents (choices [R_used, n_pad]),
    flipped/checked masks, auction round counts, and the reconstructed cut
    registry (tri indices, vertex triples, pair triples). ``deadline``
    (absolute time.time()) is checked between rounds; ``on_round(r,
    since_improve, state)`` runs after every round that does not stop.
    ``schedule_len`` pads both epsilon schedules to at least that length.
    Given a batch's ``max_rounds`` and ``schedule_len`` (both in every dict
    :func:`run_tearing_device_batch` returns), the loop runs the window
    exactly as the batched loop does.

    The spans ``separation_setup`` (uploads and the loop's state),
    ``tear_round`` (each round; ``device_time`` is their sum, the synced
    loop's wall), ``device_wait`` (inside a round, every wait on the card)
    and ``separation_readback`` (the bulk transfer and the cut registry) go
    into ``times``.
    """
    import time as _time

    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    T = len(tris)
    if T == 0:
        raise ValueError("run_tearing_device requires at least one triangle")
    n_pad, C = problem.costs.shape
    L = int(problem.n_slot_copies)
    device = resolve_device(device)

    with span(times, "separation_setup"):
        full_sched, warm_sched = window_schedules(
            problem, tri_weights, delaunay_penalty, eps_final, eps_scaling,
            prices0 is not None,
        )
        # Equal-length schedules, padded with eps_final (tearing_device.py:364-373).
        pad_len = max(len(warm_sched), len(full_sched), schedule_len or 0)
        warm_sched, full_sched = (
            np.concatenate([s, np.full(pad_len - len(s), eps_final, np.float32)])
            if len(s) < pad_len else s
            for s in (warm_sched, full_sched)
        )

        pd = to_device(problem, device)
        knobs = _knobs(delaunay_penalty, allowed_flip_fraction, penalty_coeff, hard,
                       plateau_patience, plateau_tol, n_pad, eps_final, obj_patience, mip_gap)
        tw_d = torch.as_tensor(np.ascontiguousarray(tri_weights, np.float32)).to(device)
        ref_d = torch.as_tensor(np.ascontiguousarray(ref_coords, np.float32)).to(device)
        inp = LoopInputs(
            costs=pd.costs, slots=pd.slots, valid=pd.valid, nm=pd.nm_cost,
            pair_idx=pd.pair_idx, cand_ref=pd.cand_ref, slot_rows=pd.slot_rows,
            slot_cols=pd.slot_cols,
            tris=torch.as_tensor(np.ascontiguousarray(tris, np.int32)).to(device),
            tri_mask=torch.ones(T, dtype=torch.bool, device=device),
            src=torch.as_tensor(np.ascontiguousarray(source_signs, np.int32)).to(device),
            ref_xy=ref_d,
            tri_weights=tw_d,
            surcharge=_cut_surcharge(tw_d, knobs),
            m_ref=torch.tensor([ref_d.shape[0]], dtype=torch.int32, device=device),
            full_schedule=full_sched,
            warm_schedule=warm_sched,
            knobs=knobs,
        )
        max_rounds = round_budget(n_pad, C, 1, max_rounds)
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
        with span(times, "tear_round") as round_span:
            state = _tearing_loop(inp, state, r_host + 1, times=times, **kwargs)
            if device.type == "cuda":
                with span(times, "device_wait"):
                    torch.cuda.synchronize(device)
        r_host = state.r
        device_time += round_span.seconds
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
    with span(times, "separation_readback"):
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


# ----------------------------------------------------------------------------
# The batched loop
# ----------------------------------------------------------------------------

def _round_up(x: int, step: int) -> int:
    return ((max(x, 1) + step - 1) // step) * step


class _Shard:
    """The windows of one device: stacked inputs and the batched loop state.

    Device tensors carry a leading axis over the shard's windows; the host
    scalars of the stop rule are [b] numpy arrays (``best_score`` f32), so
    each window's rule runs with the solo loop's f32 semantics.
    """

    def __init__(self, device, arrays, knobs, m, full_sched, warm_sched,
                 prices, R, K):
        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

        (costs, slots, valid, nm, pair_idx, cand_ref, slot_rows, slot_cols,
         tris, tri_mask, src, ref_xy, tw) = arrays
        b, n, C = costs.shape
        T_pad = tris.shape[1]
        self.device = device
        self.costs = up(costs, torch.float32)
        self.slots = up(slots, torch.int32)
        self.valid = up(valid, torch.bool)
        self.nm = up(nm, torch.float32)
        self.pair_idx = up(pair_idx, torch.int32)
        self.cand_ref = up(cand_ref, torch.int32)
        self.slot_rows = up(slot_rows, torch.int32)
        self.slot_cols = up(slot_cols, torch.int32)
        self.tris = up(tris, torch.int32)
        self.tri_mask = up(tri_mask, torch.bool)
        self.src = up(src, torch.int32)
        self.ref_xy = up(ref_xy, torch.float32)
        self.tw = up(tw, torch.float32)
        self.knobs = knobs
        self.m_ref = up(np.asarray(m), torch.int32)
        self.full_sched, self.warm_sched = full_sched, warm_sched
        self.surcharge = torch.stack(
            [_cut_surcharge(self.tw[i], k) for i, k in enumerate(knobs)])
        # The loop state (_init_state with a leading axis).
        self.extra = torch.zeros((b, n, C), dtype=torch.float32, device=device)
        self.prices = up(prices, torch.float32)
        self.assigned_c = torch.full((b, n), -1, dtype=torch.int32, device=device)
        self.owner_c = torch.full((b, prices.shape[1]), -1, dtype=torch.int32, device=device)
        self.cut_mem = torch.full((b, T_pad, K, 3), -2, dtype=torch.int32, device=device)
        self.cut_cnt = torch.zeros((b, T_pad), dtype=torch.int32, device=device)
        self.all_choices = torch.full((b, R, n), C, dtype=torch.int32, device=device)
        self.all_flipped = torch.zeros((b, R, T_pad), dtype=torch.bool, device=device)
        self.all_checked = torch.zeros((b, R, T_pad), dtype=torch.bool, device=device)
        self.all_rounds = np.zeros((b, R), np.int32)
        self.r = np.zeros(b, np.int64)
        self.cuts_added = np.zeros(b, np.int64)
        self.stop = np.zeros(b, bool)
        self.best_score = np.full(b, np.inf, np.float32)
        self.since_improve = np.zeros(b, np.int64)
        self.best_r = np.zeros(b, np.int64)


def _batch_round(sh: _Shard, r_end: int, *, L: int, K: int, max_tear_rounds: int,
                 max_rounds: int, warm_max_rounds: int, max_cuts_per_round: int,
                 max_cuts_total: int) -> None:
    """One guarded tear round of every running window of the shard.

    The rule of :func:`_tearing_loop` (carried state), over the stacked
    tensors: one K5 launch for the running windows, one K6 launch, one K7
    launch for the six values of the running windows and one host read of
    them, the stop rule per window on the host, then one K8 launch for the
    cut registration and surcharge of the windows that register and one read
    of the cuts added. A window that has stopped keeps its state.
    """
    act = ~sh.stop & (sh.r < min(r_end, max_tear_rounds))
    if not act.any():
        return
    ai = np.flatnonzero(act)
    # The windows advance in lockstep, so the running ones share the round.
    r = int(sh.r[ai[0]])
    if not (sh.r[ai] == r).all():
        raise AssertionError(f"batched tear loop out of step: rounds {sh.r[ai]}")
    dev = sh.device
    B = sh.costs.shape[0]
    cold, first, budget = _resolve_args(r, max_rounds, warm_max_rounds)
    res = auction_loop_batch(
        sh.costs + sh.extra, sh.slots, sh.valid, sh.nm, sh.prices,
        sh.full_sched if first else sh.warm_sched, budget,
        assigned0=None if cold else sh.assigned_c,
        owner0=None if cold else sh.owner_c,
        slot_rows=sh.slot_rows, slot_cols=sh.slot_cols,
        obj_patience=[k.obj_patience for k in sh.knobs],
        obj_tol=[k.obj_tol for k in sh.knobs], windows=ai,
    )
    # Frozen windows keep their carried state; K5 did not write their rows.
    act_d = torch.as_tensor(act).to(dev)
    choice = torch.where(act_d[:, None], res.choice, sh.assigned_c)
    prices = torch.where(act_d[:, None], res.prices, sh.prices)
    owner = torch.where(act_d[:, None], res.owner, sh.owner_c)

    checked, flipped, vmove = tear_metrics_batch(
        sh.costs, sh.extra, sh.slots, sh.valid, sh.nm, sh.pair_idx, sh.cand_ref,
        sh.tris, sh.tri_mask, sh.src, sh.ref_xy, prices, choice,
    )
    ai_d = torch.as_tensor(ai).to(dev)
    sh.all_choices[ai_d, r] = choice[ai_d]
    sh.all_flipped[ai_d, r] = flipped[ai_d]
    sh.all_checked[ai_d, r] = checked[ai_d]
    sh.all_rounds[ai, r] = res.rounds[ai]

    # K7 sums each running window in one fixed order, the solo loop's (the
    # padded triangles add zeros), so a window's stop decisions are the solo
    # loop's. Row j of scal is window ai[j].
    scal = tear_scalars(
        sh.costs, sh.nm, choice, sh.cand_ref, sh.ref_xy, sh.m_ref, flipped,
        checked, sh.tw, sh.tri_mask, sh.src, windows=ai,
    ).cpu().numpy()
    register = np.zeros(B, bool)
    for j, b in enumerate(ai):
        sh.best_score[b], sh.since_improve[b], sh.best_r[b], stop_now = _score_and_stop(
            scal[j], r, sh.knobs[b], sh.best_score[b], int(sh.since_improve[b]),
            int(sh.best_r[b]), int(sh.cuts_added[b]), max_cuts_total,
        )
        register[b] = not stop_now

    added = np.zeros(B, np.int64)
    if register.any():
        added = register_cuts(
            sh.tris, sh.surcharge, choice, sh.pair_idx, flipped, vmove, register,
            sh.cuts_added, sh.cut_mem, sh.cut_cnt, sh.extra, L=L, K=K,
            max_cuts_per_round=max_cuts_per_round, max_cuts_total=max_cuts_total,
        ).cpu().numpy().astype(np.int64)

    sh.prices, sh.assigned_c, sh.owner_c = prices, choice, owner
    sh.r[ai] += 1
    sh.cuts_added[ai] += added[ai]
    sh.stop[ai] = ~register[ai] | (added[ai] == 0)


def mesh_devices(mesh) -> List[torch.device]:
    """The devices of a mesh (any sequence of torch devices or their names);
    None is the port's default device, the first CUDA card (raises without
    one)."""
    if mesh is None:
        return [default_device()]
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("the mesh holds no device")
    return devices


def run_tearing_device_batch(
    problems,
    tris_list,
    tri_weights_list,
    source_signs_list,
    ref_coords_list,
    *,
    delaunay_penalties,
    allowed_flip_fractions,
    hards,
    eps_finals,
    penalty_coeffs=None,
    eps_scaling: float = 4.0,
    max_cuts=None,
    max_cuts_per_round: int = 1000,
    max_tear_rounds: int = 25,
    max_rounds: int = 60000,
    K: int = 6,
    mesh=None,
    prices0_list=None,
    deadline=None,
    plateau_patiences=None,
    plateau_tols=None,
    obj_patience: int = 128,
    mip_gaps=None,
):
    """Batched fused tearing loop over a window batch, sharded over ``mesh``.

    Port of ``same_tpu/solver/tearing_device.py::run_tearing_device_batch``:
    every window runs the FULL solve (auction re-solves, flip tests, cut
    registration) in lockstep. All problems must share (n_pad, C, S, L); the
    caller groups windows by shape bucket. Triangle arrays are padded to a
    multiple of 128 with ``tri_mask`` False and ``source_signs`` 0, which the
    orientation test treats as unchecked; ref coordinates to the longest.

    ``mesh`` is a sequence of torch devices (None: the first CUDA card). With
    a mesh the batch is padded to a multiple of its size with copies of the
    last window (dropped on return) and cut into contiguous shards, one a
    device, run in lockstep one after the other; the card has run only the
    one-device mesh. Each auction solve gets the round budget of the
    ``n_local`` windows a device holds (:func:`round_budget`), so the batch is
    not bit-equal to solo runs of its windows, as in the JAX package. It is
    bit-equal to solo runs given the batch's ``max_rounds`` and
    ``schedule_len``, which every returned dict carries.

    Returns a per-window list of dicts in the ``run_tearing_device`` format;
    ``device_time`` is the batch's, split evenly over the windows.
    """
    import time as _time

    from ..parallel.shard import stack_problems

    B = len(problems)
    if B == 0:
        return []
    n_pad, C = problems[0].costs.shape
    S = problems[0].n_slots
    L = int(problems[0].n_slot_copies)
    for p in problems:
        if p.costs.shape != (n_pad, C) or p.n_slots != S or p.n_slot_copies != L:
            raise ValueError("run_tearing_device_batch: mixed shape buckets")
    devices = mesh_devices(mesh)

    tris_list = [np.asarray(t).reshape(-1, 3) for t in tris_list]
    T_list = [len(t) for t in tris_list]
    T_pad = _round_up(max(T_list), 128)
    R_ref = max(len(r) for r in ref_coords_list)

    def pad_tri(a, fill, dtype):
        a = np.asarray(a, dtype=dtype)
        out = np.full((T_pad,) + a.shape[1:], fill, dtype=dtype)
        out[: len(a)] = a
        return out

    tris_b = np.stack([pad_tri(t, 0, np.int64) for t in tris_list])
    tri_mask_b = np.stack([np.arange(T_pad) < T for T in T_list])
    src_b = np.stack([pad_tri(s, 0, np.int32) for s in source_signs_list])
    tw_b = np.stack([pad_tri(w, 0.0, np.float32) for w in tri_weights_list])
    ref_b = np.zeros((B, R_ref, 2), np.float32)
    for b, rc in enumerate(ref_coords_list):
        ref_b[b, : len(rc)] = np.asarray(rc, np.float32)
    costs_b, slots_b, valid_b, nm_b, slot_rows_b, slot_cols_b = stack_problems(problems)
    pair_idx_b = np.stack([p.pair_idx for p in problems])
    cand_ref_b = np.stack([p.cand_ref for p in problems])

    # Per-window epsilon schedules, padded with their last entry to the
    # batch's longest (tearing_device.py:600-628).
    warm_start = [prices0_list is not None and prices0_list[b] is not None
                  for b in range(B)]
    scheds = [
        window_schedules(p, tri_weights_list[b], delaunay_penalties[b],
                         float(eps_finals[b]), eps_scaling, warm_start[b])
        for b, p in enumerate(problems)
    ]
    LEN = max(len(s) for pair in scheds for s in pair)

    def pad_sched(s):
        return np.concatenate([s, np.full(LEN - len(s), s[-1], np.float32)]) if len(s) < LEN else s

    full_b = np.stack([pad_sched(full) for full, _warm in scheds])
    warm_b = np.stack([pad_sched(warm) for _full, warm in scheds])
    knobs = [
        _knobs(
            delaunay_penalties[b], allowed_flip_fractions[b],
            100.0 if penalty_coeffs is None else penalty_coeffs[b], hards[b],
            6 if plateau_patiences is None else plateau_patiences[b],
            0.0 if plateau_tols is None else plateau_tols[b],
            n_pad, float(eps_finals[b]), obj_patience,
            None if mip_gaps is None else mip_gaps[b],
        )
        for b in range(B)
    ]
    prices_b = np.zeros((B, S + 1), np.float32)
    for b in range(B):
        if warm_start[b]:
            prices_b[b] = np.asarray(prices0_list[b], np.float32)

    # Pad the batch to a multiple of the mesh size with copies of the last
    # window; the budget's cost model scales with the windows a device holds.
    n_dev = len(devices)
    pad = (-B) % n_dev if mesh is not None else 0
    n_local = max(1, (B + pad) // n_dev)
    max_rounds = round_budget(n_pad, C, n_local, max_rounds)
    kwargs = dict(
        L=L,
        K=K,
        max_tear_rounds=max_tear_rounds,
        max_rounds=max_rounds,
        warm_max_rounds=max(1024, max_rounds // 8),
        max_cuts_per_round=int(max_cuts_per_round),
        max_cuts_total=int(max_cuts) if max_cuts is not None else 1 << 30,
    )
    keep = np.minimum(np.arange(B + pad), B - 1)
    arrays = (costs_b, slots_b, valid_b, nm_b, pair_idx_b, cand_ref_b, slot_rows_b,
              slot_cols_b, tris_b, tri_mask_b, src_b, ref_b, tw_b)
    shards = []
    for d in range(n_dev):
        idx = keep[d * n_local:(d + 1) * n_local]
        shards.append(_Shard(
            devices[d], [a[idx] for a in arrays], [knobs[i] for i in idx],
            [len(ref_coords_list[i]) for i in idx],
            full_b[idx], warm_b[idx], prices_b[idx], max_tear_rounds, K,
        ))

    r_host = 0
    time_limit_reached = [False] * B
    device_time = 0.0
    while r_host < max_tear_rounds:
        with span(None, "tear_round") as round_span:
            for sh in shards:
                _batch_round(sh, r_host + 1, **kwargs)
            for sh in shards:
                if sh.device.type == "cuda":
                    with span(None, "device_wait"):
                        torch.cuda.synchronize(sh.device)
            r_host += 1
            stops = np.concatenate([sh.stop for sh in shards])
        device_time += round_span.seconds
        if bool(stops[:B].all()) or r_host >= max_tear_rounds:
            break
        if deadline is not None and _time.time() > deadline:
            time_limit_reached = [not bool(s) for s in stops[:B]]
            break

    out = []
    for b in range(B):
        sh, i = shards[b // n_local], b % n_local
        r, T = int(sh.r[i]), T_list[b]
        cut_tris, cut_verts, cut_pairs = _registry_from_memory(
            tris_list[b], sh.cut_mem[i, :T].cpu().numpy(), sh.cut_cnt[i, :T].cpu().numpy(),
        )
        out.append({
            "rounds_used": r,
            "cuts_added": int(sh.cuts_added[i]),
            "time_limit_reached": bool(time_limit_reached[b]),
            "choices": sh.all_choices[i, :r].cpu().numpy(),
            "flipped": sh.all_flipped[i, :r, :T].cpu().numpy(),
            "checked": sh.all_checked[i, :r, :T].cpu().numpy(),
            "auction_rounds": sh.all_rounds[i, :r].copy(),
            "cut_tris": cut_tris,
            "cut_verts": cut_verts,
            "cut_pairs": cut_pairs,
            "device_time": device_time / max(B, 1),
            "max_rounds": max_rounds,
            "schedule_len": LEN,
        })
    return out
