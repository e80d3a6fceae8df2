"""Assignment-problem model: padded tensors for the auction solver.

Host copy of ``same_tpu/models/assignment.py`` (both packages build the
numpy problem with identical code), plus :func:`to_device`, which carries the
numpy problem onto a torch device with the JAX package's dtypes, and
:func:`auction_state_from_numpy` for handing a warm auction state across.

This replaces the reference's Gurobi model object (reference
src/same.py:1112-1197). The MIP structure is:

- binary x per candidate (aligned i, ref j) pair,
- per-aligned: sum_j x_ij + no_match_i = 1 (src/helpers.py:155-158),
- per-ref: sum_i x_ij <= limit_j where limit_j = max_matches, or
  ref_metacell_match_multiplier * max_matches for ref metacells
  (src/helpers.py:118-137),
- soft congestion: pay penalty_coeff per match beyond the first on a ref
  (src/helpers.py:148-152 with the penalty term of src/same.py:1191-1197).

TPU formulation: expand each ref j into ``limit_j`` unit-capacity *slots*;
slot s > 0 carries an extra cost of ``penalty_coeff`` (filling slots in order
reproduces penalty_coeff * max(0, u_j - 1) exactly). Each aligned point then
chooses among K*L padded slot-columns plus an explicit no-match option at
cost ``no_match_penalty * size_i``. The result is a pure assignment problem
over fixed-shape arrays — the form the auction kernel consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AssignmentProblem(NamedTuple):
    """Padded, device-ready window assignment problem.

    Shapes: n (bucketed) bidder rows — the first ``n_aligned`` are real —
    C = K*L slot columns, S (bucketed) ref slots.
    """

    costs: np.ndarray      # [n, C] f32: pair cost + slot congestion surcharge
    slots: np.ndarray      # [n, C] i32: global slot id (or S for invalid)
    valid: np.ndarray      # [n, C] bool
    nm_cost: np.ndarray    # [n]    f32: no-match cost (0 for padding rows)
    cand_ref: np.ndarray   # [n, C] i32: ref row per column (-1 invalid)
    pair_idx: np.ndarray   # [n, C] i32: original pair-list index (-1 invalid)
    slot_ref: np.ndarray   # [S]    i32: owning ref row per slot (-1 padding)
    n_slots: int           # padded slot count (dummy slot id)
    n_ref: int
    n_aligned: int         # real bidder count (rows beyond this are padding)
    n_slot_copies: int     # L: column-block width per candidate ref
    slot_rows: np.ndarray  # [S, P] i32: bidder rows referencing each slot (-1 pad)
    slot_cols: np.ndarray  # [S, P] i32: matching column per reference (0 pad)


def _bucket(x: int, sizes=(64, 128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    """Round up to a shape bucket (power-of-two ladder, then multiples)."""
    for s in sizes:
        if x <= s:
            return s
    step = 4096
    return ((x + step - 1) // step) * step


def build_assignment_problem(
    pairs: np.ndarray,
    pair_costs: np.ndarray,
    n_aligned: int,
    n_ref: int,
    ref_limits: np.ndarray,
    penalty_coeff: float,
    no_match_cost: np.ndarray,
    dtype=np.float32,
    bucket: bool = True,
) -> AssignmentProblem:
    """Build the padded slot-expanded problem from a candidate pair list.

    ``pairs`` is the [(i, j)] array from candidate generation (ordered by
    aligned index then distance); ``pair_costs`` aligns with it 1:1.
    ``ref_limits[j]`` is the hard match capacity of ref j.

    With ``bucket=True`` (default) the bidder count and slot count are padded
    to shape buckets so windows of similar size reuse the same compiled
    auction kernel. Padding bidders have no candidates and a unit no-match
    cost — they settle on no-match in the first round; padding slots are
    never referenced. Callers must slice solver outputs with the *real*
    ``n_aligned`` (the arrays' row count is the padded size, real rows first).
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    pair_costs = np.asarray(pair_costs, dtype=np.float64)
    ref_limits = np.asarray(ref_limits, dtype=np.int64)
    if len(ref_limits) != n_ref:
        raise ValueError("ref_limits must have length n_ref")

    slot_base = np.zeros(n_ref + 1, dtype=np.int64)
    np.cumsum(ref_limits, out=slot_base[1:])
    n_slots_real = int(slot_base[-1])
    slot_ref = np.repeat(np.arange(n_ref, dtype=np.int32), ref_limits)

    # Per-aligned candidate counts -> K (max candidates per point).
    counts = np.bincount(pairs[:, 0], minlength=n_aligned) if len(pairs) else np.zeros(
        n_aligned, dtype=np.int64
    )
    K = int(counts.max()) if len(pairs) else 0
    L = int(ref_limits.max()) if n_ref else 1
    C = max(K * L, 1)

    if bucket:
        n_rows = _bucket(n_aligned)
        n_slots = _bucket(n_slots_real)
        C = max(((C + 7) // 8) * 8, 8)
    else:
        n_rows = n_aligned
        n_slots = n_slots_real
    slot_ref = np.concatenate(
        [slot_ref, np.full(n_slots - n_slots_real, -1, dtype=np.int32)]
    )

    costs = np.zeros((n_rows, C), dtype=dtype)
    slots = np.full((n_rows, C), n_slots, dtype=np.int32)
    valid = np.zeros((n_rows, C), dtype=bool)
    cand_ref = np.full((n_rows, C), -1, dtype=np.int32)
    pair_idx = np.full((n_rows, C), -1, dtype=np.int32)

    # Position of each pair within its aligned-point group (pairs are grouped
    # by aligned index in candidate order).
    if len(pairs):
        rows = pairs[:, 0]
        refs = pairs[:, 1]
        if np.any(np.diff(rows) < 0):
            # Candidate generation emits pairs grouped by aligned index; keep
            # that invariant with a stable sort if a caller hands raw pairs.
            order = np.argsort(rows, kind="stable")
            pairs = pairs[order]
            pair_costs = pair_costs[order]
            rows = pairs[:, 0]
            refs = pairs[:, 1]
        group_start = np.searchsorted(rows, np.arange(n_aligned))
        pos_in_group = np.arange(len(pairs)) - group_start[rows]
        base_col = pos_in_group * L
        p_all = np.arange(len(pairs))
        for s in range(L):
            sel = s < ref_limits[refs]
            r, c = rows[sel], base_col[sel] + s
            costs[r, c] = pair_costs[sel] + (penalty_coeff if s > 0 else 0.0)
            slots[r, c] = slot_base[refs[sel]] + s
            valid[r, c] = True
            cand_ref[r, c] = refs[sel]
            pair_idx[r, c] = p_all[sel]

    nm = np.zeros(n_rows, dtype=dtype)
    nm[:n_aligned] = np.asarray(no_match_cost, dtype=dtype)

    # Slot-major transpose: for every slot, the (row, col) entries that
    # reference it. Used by the auction's reverse-pricing boundary step
    # (solver/auction.py) to set an unowned slot's price directly to its
    # best bidder's surplus level instead of zeroing it — zeroing forces an
    # epsilon-increment climb back to equilibrium (measured: 10-20k bidding
    # rounds per tearing re-solve).
    v_rows, v_cols = np.nonzero(valid)
    v_slots = slots[v_rows, v_cols]
    order = np.argsort(v_slots, kind="stable")
    s_sorted = v_slots[order]
    group_start = np.searchsorted(s_sorted, np.arange(n_slots))
    pos = np.arange(len(s_sorted)) - group_start[s_sorted]
    P = int(pos.max()) + 1 if len(pos) else 1
    P = ((P + 7) // 8) * 8
    slot_rows = np.full((n_slots, P), -1, dtype=np.int32)
    slot_cols = np.zeros((n_slots, P), dtype=np.int32)
    slot_rows[s_sorted, pos] = v_rows[order]
    slot_cols[s_sorted, pos] = v_cols[order]

    return AssignmentProblem(
        costs=costs,
        slots=slots,
        valid=valid,
        nm_cost=nm,
        cand_ref=cand_ref,
        pair_idx=pair_idx,
        slot_ref=slot_ref,
        n_slots=n_slots,
        n_ref=n_ref,
        n_aligned=n_aligned,
        n_slot_copies=L,
        slot_rows=slot_rows,
        slot_cols=slot_cols,
    )


def matching_objective(
    match_ref: np.ndarray,
    matched_pair_cost: np.ndarray,
    n_ref: int,
    penalty_coeff: float,
    no_match_cost: np.ndarray,
) -> float:
    """True MIP objective of an integral matching (excluding tearing term).

    Recomputed from the matching itself — congestion is
    penalty_coeff * max(0, u_j - 1) per ref — so slot-fill order inside the
    solver cannot skew the reported objective.
    """
    matched = match_ref >= 0
    base = float(matched_pair_cost[matched].sum())
    u = np.bincount(match_ref[matched], minlength=n_ref)
    congestion = float(penalty_coeff) * float(np.maximum(u - 1, 0).sum())
    unmatched = float(no_match_cost[~matched].sum())
    return base + congestion + unmatched


class TorchProblem(NamedTuple):
    """Device-resident view of an :class:`AssignmentProblem`.

    Same dtypes as the JAX package's device arrays: f32 costs, i32 slots /
    cand_ref / pair_idx / slot_rows / slot_cols, bool valid. ``host`` keeps
    the numpy problem for host-side bookkeeping (cost scale, decoding).
    """

    costs: torch.Tensor      # [n, C] f32
    slots: torch.Tensor      # [n, C] i32
    valid: torch.Tensor      # [n, C] bool
    nm_cost: torch.Tensor    # [n]    f32
    cand_ref: torch.Tensor   # [n, C] i32
    pair_idx: torch.Tensor   # [n, C] i32
    slot_rows: torch.Tensor  # [S, P] i32
    slot_cols: torch.Tensor  # [S, P] i32
    host: AssignmentProblem


def default_device() -> torch.device:
    """The port's device: the first CUDA card. Raises when there is none.

    The entry points never fall back to the CPU on their own; a caller that
    wants the CPU (the kernels' plain versions) passes ``device="cpu"``.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "same_tpu_torch needs a CUDA card (torch.cuda.is_available() is "
            "False); pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; ``None`` means :func:`default_device`."""
    return torch.device(device) if device is not None else default_device()


def to_device(problem: AssignmentProblem, device) -> TorchProblem:
    """Upload the numpy problem's arrays once, keeping the JAX dtypes."""
    if isinstance(problem, TorchProblem):
        problem = problem.host

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    return TorchProblem(
        costs=up(problem.costs, torch.float32),
        slots=up(problem.slots, torch.int32),
        valid=up(problem.valid, torch.bool),
        nm_cost=up(problem.nm_cost, torch.float32),
        cand_ref=up(problem.cand_ref, torch.int32),
        pair_idx=up(problem.pair_idx, torch.int32),
        slot_rows=up(problem.slot_rows, torch.int32),
        slot_cols=up(problem.slot_cols, torch.int32),
        host=problem,
    )


class AuctionState(NamedTuple):
    """Warm auction state: slot prices, slot owners and bidder columns."""

    prices: torch.Tensor     # [S+1] f32
    owner: torch.Tensor      # [S+1] i32
    assigned: torch.Tensor   # [n]   i32 (column, C = no-match, -1 = none)


def auction_state_from_numpy(prices, owner, assigned, device="cpu") -> AuctionState:
    """Tensors of a warm auction state given as arrays (e.g. a JAX result)."""

    def up(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype).to(device)

    return AuctionState(
        prices=up(prices, torch.float32),
        owner=up(owner, torch.int32),
        assigned=up(assigned, torch.int32),
    )
