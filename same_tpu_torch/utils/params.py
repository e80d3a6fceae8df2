"""Parameter dictionaries for SAME-TPU.

API-parity note: the reference (rohitsinghlab/SAME) exposes two override-able
default dicts, ``init_gurobi_params`` (src/same.py:40-130) and
``init_optim_params`` (src/same.py:133-242). We keep the same key names and
defaults so existing notebooks/scripts run unmodified. Gurobi-only tuning knobs
(mip_focus, cuts, heuristics) are accepted and ignored by the TPU solver;
``mip_gap`` and ``time_limit`` map onto the auction solver's optimality
tolerance and wall-clock budget. Extra ``tpu_*`` keys control the TPU
assignment solver and can be overridden the same way.
"""

from __future__ import annotations

from typing import Any, Dict


def init_solver_params(**overrides) -> Dict[str, Any]:
    """Create default solver parameters for SAME-TPU optimization.

    Mirrors the reference's ``init_gurobi_params`` key set
    (reference src/same.py:106-130) and adds TPU auction-solver knobs.

    Keys
    ----
    time_limit : float — wall-clock budget per window solve (seconds).
    mip_gap : float — relative optimality tolerance; drives the final auction
        epsilon (n * eps_final <= mip_gap * |objective| heuristic).
    mip_focus, cuts, heuristics : accepted for API parity; unused on TPU.
    init_method : None | 'greedy' | 'hungarian' — warm-start for solver prices.
    init_big_m, init_hungarian_max_n : warm-start controls (parity).
    lazy_max_cuts : int or None — global cap on tearing cuts.
    lazy_allowed_flip_fraction : float — flip budget; no cuts are generated
        while the flip fraction is at or below this (reference src/same.py:674-679).
    lazy_max_cuts_per_incumbent : int — per-round cap on new cuts.

    TPU solver keys
    ---------------
    tpu_eps_scaling : float — epsilon divisor between auction phases.
    tpu_eps_final : float — final epsilon (absolute, cost units).
    tpu_max_tear_rounds : int — outer separation-loop cap.
    """
    params: Dict[str, Any] = {
        # Core solve controls (parity with reference)
        "time_limit": 7200,
        "mip_gap": 0.05,
        # Gurobi tuning knobs — accepted, ignored (parity)
        "mip_focus": 2,
        "cuts": 2,
        "heuristics": 0.1,
        # Warm start
        "init_method": None,
        "init_big_m": 1e9,
        "init_hungarian_max_n": 5000,
        # Lazy (tearing) constraint knobs
        "lazy_max_cuts": None,
        "lazy_allowed_flip_fraction": 0.05,
        "lazy_max_cuts_per_incumbent": 1000,
        # TPU auction solver knobs. tpu_eps_final is an absolute floor on the
        # final auction epsilon; the effective epsilon is scaled to the
        # problem via mip_gap (core.prepare_window), so this floor only
        # guards against degenerate zero-cost instances. It must sit below
        # the smallest meaningful cost difference (the 0.001-weighted
        # coordinate tie-break term, reference src/same.py:1183-1189).
        "tpu_eps_scaling": 4.0,
        "tpu_eps_final": 1e-7,
        "tpu_max_tear_rounds": 25,
        # Host-loop plateau patience: stop separating once the flips-pay
        # incumbent score hasn't improved for this many rounds (None
        # disables). Each round is a full auction re-solve; zero-budget
        # instances oscillate long before tpu_max_tear_rounds.
        "tpu_tear_patience": 6,
        # Relative margin a round must beat the best flips-pay score by to
        # count as an improvement (reset the patience counter). Gains inside
        # the margin are churn: far below mip_gap, they cost a full auction
        # re-solve each. Applies to both separation loops.
        "tpu_tear_plateau_tol": 0.0,
        # Wall-clock budget (seconds) for the exact-repair phase — the
        # quality/time dial of this pipeline (the analog of Gurobi's
        # time_limit). None = size-based auto heuristics (tearing.py).
        "tpu_repair_budget": None,
        # "auto": fused device loop on accelerators / large problems, host
        # separation loop otherwise. "force": always fused. False: never.
        "tpu_device_loop": "auto",
        # Windows in flight on the sequential path: one window's device
        # separation overlaps another's host repair (HiGHS releases the
        # GIL); host-heavy stages stay serialized under a shared lock so
        # the wall-clock-budgeted repair never shares the host. 1 disables.
        "tpu_pipeline_windows": 2,
        # optim_params['lazy_constraints']=False routes windows up to this
        # many aligned points to the complete eager O(n*k^3) MILP (reference
        # src/helpers.py:444-573) solved exactly by HiGHS; larger eager
        # windows fall back to the zero-budget tearing emulation
        # (ARCHITECTURE.md). None disables the exact route entirely.
        "tpu_eager_max_n": 600,
        # Concurrent component-MILP solves inside exact repair. None = auto
        # (cpu_count capped at 8; 1 on single-core hosts). Groups are
        # vertex- AND ref-disjoint, so parallel solves apply identically to
        # sequential ones.
        "tpu_repair_workers": None,
        # Auction natural termination: a phase whose placement value
        # stalls for max(this, rounds-in-phase/3) bidding rounds advances
        # the epsilon schedule; a stalled+complete final phase finishes —
        # round budgets become a safety net instead of the effective stop
        # (tests/test_auction.py pins budget-insensitivity). Default 0
        # (exact fixed-point termination): like tpu_tear_plateau_tol, the
        # stall rule measurably shifts medium-window incumbents off the
        # pinned parity trajectories (tongue 83.59 -> 82.65% 1-NN at an
        # equal-or-better objective), so it is an opt-in throughput dial
        # the LUAD-scale benches set to 128.
        "tpu_auction_patience": 0,
        # Round-0 mip_gap certificate: when the unsurcharged assignment
        # optimum's tearing hinge is already inside the mip_gap band, ship
        # it — no separation rounds, no repair. DISABLED by default:
        # measured on the tongue dataset (base objective ~10.9M dwarfs the
        # ~54k tearing stake), the certificate ships the raw incumbent and
        # costs 8 accuracy points, while on the LUAD low-dp sweep it never
        # fires (dp=0 has its own short-circuit; dp>=1 hinges exceed the
        # band) — within-mip_gap is not the right license to skip flip
        # quality the reference's callback always pursues.
        "tpu_gap_certificate": False,
        # Speculative repair overlap for windows with >6144 aligned points:
        # once the separation score stalls, the best incumbent's exact
        # repair starts on the host while the device keeps tearing; if the
        # final best incumbent is unchanged, the serialized repair phase
        # vanishes from the window's critical path. False restores the
        # strictly sequential separation -> repair order (and exact
        # output equality with the mesh-sharded path on such windows).
        "tpu_speculative_repair": True,
    }
    params.update(overrides)
    return params


# Backwards-compatible alias: the reference public API calls this
# ``init_gurobi_params`` (reference src/__init__.py:56-65). There is no Gurobi
# here, but the notebooks use this name.
def init_gurobi_params(**overrides) -> Dict[str, Any]:
    """Alias of :func:`init_solver_params` kept for reference-API parity."""
    return init_solver_params(**overrides)


def init_optim_params(**overrides) -> Dict[str, Any]:
    """Create default optimization parameters for SAME matching.

    Key set and defaults match the reference ``init_optim_params``
    (reference src/same.py:215-242).
    """
    params: Dict[str, Any] = {
        # Sliding window params
        "window_size": 1000,
        "overlap": 250,
        "min_cells_per_window": 10,
        # Matching problem params
        "max_matches": 1,
        "ref_metacell_match_multiplier": None,
        "radius": 250,
        "penalty_coeff": 100,
        "no_match_penalty": 100,
        "delaunay_penalty": 5,
        "dist_ct_coeff": 1,
        "knn": 8,
        # Output labeling
        "cell_id_col": "Cell_Num_Old",
        # Constraint/behavior flags
        "hard_spatial_constraints": False,
        "ignore_same_type_triangles": True,
        "ignore_knn_if_matched": False,
        "lazy_constraints": True,
        # Triangle quality filtering
        "min_angle_deg": 15,
    }
    params.update(overrides)
    return params
