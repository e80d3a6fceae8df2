"""Jacobi auction solver with epsilon scaling, in PyTorch.

Port of ``same_tpu/solver/auction.py``; see that module for the design of
the asymmetric (reservation-option) auction: no per-phase reset, boundary
sweeps with a reverse-auction drain, reservation re-evaluation, and the
polish repeats of the final phase.

The fused solve (the JAX package's ``_auction_run``) is
``kernels/auction_loop.py::auction_loop``: one persistent kernel launch per
solve on a CUDA card, the plain Python loop (``auction_loop_plain``) on the
CPU. This module keeps the epsilon schedules, the stall-stop arguments and
:func:`solve_assignment`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.auction_loop import auction_loop
from ..models.assignment import (
    AssignmentProblem,
    TorchProblem,
    resolve_device,
    to_device,
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
    ``device``: the first CUDA card by default, ``"cpu"`` on request) or a
    :class:`TorchProblem` already on its device. ``prices0`` and
    ``extra_costs`` may be arrays or tensors.
    ``obj_patience`` enables the objective-stall termination (0 keeps the
    exact fixed-point semantics). ``return_raw`` returns the device-resident
    :class:`AuctionResult`.
    """
    if not isinstance(problem, TorchProblem):
        problem = to_device(problem, resolve_device(device))
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
    result = auction_loop(
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
