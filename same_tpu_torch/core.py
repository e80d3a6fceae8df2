"""``run_same`` — the core single-window matching pipeline.

Drop-in replacement for the reference entry point (reference
src/same.py:706-1489) with the Gurobi MIP swapped for the TPU auction +
space-tearing solver. The DataFrame contract is preserved end to end:

- inputs: ``ref_df`` / ``aligned_df`` with X, Y, cell_type, probability
  columns named by ``commonCT``, optional ``size``; ``aligned_df`` may be a
  MetaCell object (duck-typed, reference src/same.py:891-899);
- outputs: ``(matches_df, var_out)`` with the reference's column set
  (aligned_idx, ref_idx, prob cols, X, Y, ref_X, ref_Y, size, ref_size,
  Ref_/Aligned_{cell_id_col}, time_limit_reached, triangle_violation,
  filtered_violation, run_time — reference src/same.py:1259-1278,1464-1472)
  and ``var_out`` diagnostics keys (reference src/same.py:1410-1432);
- artifacts: var_out.npy, aligned_df.csv, ref_df.csv, matches_df.csv under
  ``outprefix`` (reference src/same.py:1455-1481).

Internally the window is arrays, not DataFrames: padded candidate tensors,
triangle arrays, and the slot-expanded assignment problem, solved on device.

The pipeline is staged so the multi-chip orchestrator can fan the device
phase out across a mesh (parallel/shard.py):

  prepare_window   host preprocessing -> PreparedWindow (arrays + problem)
  solve_prepared   device solve (auction + tearing separation)
  finalize_window  output assembly, verification, artifacts

``run_same`` composes the three for the single-window, reference-parity path.

PyTorch port of ``same_tpu/core.py``: the host stages are the same code; the
solve runs on the first CUDA card (the ``auction_loop`` and K2 kernels), or
on the CPU with the kernels' plain versions when the caller passes
``device="cpu"``. ``prepare_window`` reaches the device only where the
window selects it: the device kNN (``SAME_TPU_KNN=tpu``, kernel K3) and the
Sinkhorn warm start (``init_method="sinkhorn"``, kernel K4).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from .candidates import find_knn_with_cell_type_priority, find_knn_within_radius
from .eval import (
    precompute_triangle_info,
    print_violation_report,
    verify_spatial_preservation,
)
from .geometry import (
    calculate_signed_area,
    delaunay_simplices,
    filter_triangles_by_radius,
    orientation_signs_np,
)
from .models.assignment import (
    AssignmentProblem,
    build_assignment_problem,
    resolve_device,
)
from .solver.tearing import TearingResult, solve_with_tearing
from .trace import add, span
from .utils.params import init_optim_params, init_solver_params


def _as_triangle_array(delaunay_like):
    """Normalize triangulation-like input to an int [T, 3] array."""
    if delaunay_like is None:
        return None
    if isinstance(delaunay_like, np.ndarray):
        tri = delaunay_like
    elif isinstance(delaunay_like, pd.DataFrame):
        tri = delaunay_like.iloc[:, :3].to_numpy()
    else:
        tri = np.asarray(delaunay_like)
    if tri.size == 0:
        return np.array([], dtype=int).reshape(0, 3)
    if tri.ndim != 2 or tri.shape[1] != 3:
        raise ValueError(f"aligned_delaunay must have shape (n, 3); got {tri.shape}")
    return tri.astype(int, copy=False)


def _remap_triangles_by_vertex_ids(triangles, vertex_ids):
    """Map vertex-ID-space triangles to 0..n-1 rows, dropping missing ones.

    Parity with reference src/same.py:262-290.
    """
    tri = _as_triangle_array(triangles)
    if tri is None or tri.size == 0:
        return tri
    id_to_row = {v: i for i, v in enumerate(vertex_ids)}
    flat = tri.reshape(-1)
    remapped = np.fromiter(
        (id_to_row.get(v, -1) for v in flat), dtype=np.int64, count=flat.size
    ).reshape(tri.shape)
    return remapped[(remapped >= 0).all(axis=1)]


def pair_costs_for(
    aligned_df, ref_df, pairs, commonCT, dist_ct_coeff: float
) -> np.ndarray:
    """Objective costs per candidate pair (reference src/same.py:1183-1189).

    c = dist_ct_coeff * L1(prob columns) + 0.001 * dist_ct_coeff * L1(coords)
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    probs_a = aligned_df[list(commonCT)].to_numpy(dtype=np.float64)
    probs_r = ref_df[list(commonCT)].to_numpy(dtype=np.float64)
    xy_a = aligned_df[["X", "Y"]].to_numpy(dtype=np.float64)
    xy_r = ref_df[["X", "Y"]].to_numpy(dtype=np.float64)
    dist_ct = np.abs(probs_a[pairs[:, 0]] - probs_r[pairs[:, 1]]).sum(axis=1)
    dist_xy = np.abs(xy_a[pairs[:, 0]] - xy_r[pairs[:, 1]]).sum(axis=1)
    return dist_ct_coeff * dist_ct + (0.001 * dist_ct_coeff) * dist_xy


@dataclass
class PreparedWindow:
    """All host-side preprocessing for one window solve.

    Produced by :func:`prepare_window`; consumed by :func:`solve_prepared`
    (device phase) and :func:`finalize_window` (output assembly). The
    multi-chip orchestrator batches the device phase of many PreparedWindows
    across a mesh.
    """

    aligned_df: pd.DataFrame
    ref_df: pd.DataFrame
    commonCT: list
    optim: Dict[str, Any]
    solver: Dict[str, Any]
    valid_pairs: np.ndarray
    pair_costs: np.ndarray
    problem: AssignmentProblem
    tris: np.ndarray
    tri_weights: np.ndarray
    source_signs: np.ndarray
    aligned_coords: np.ndarray
    ref_coords: np.ndarray
    aligned_simplex_map: dict
    triangle_info: dict
    eps_solver: float
    prices0: Optional[np.ndarray] = None
    warm_info: Dict[str, Any] = field(default_factory=dict)
    stage_times: Dict[str, float] = field(default_factory=dict)
    t_start: float = field(default_factory=time.time)
    eps_floor: float = 0.0
    obj_lb: float = 0.0


def prepare_window(
    ref_df,
    aligned_df,
    commonCT,
    aligned_delaunay=None,
    aligned_delaunay_vertex_col: Optional[str] = None,
    optim_params: Optional[Dict[str, Any]] = None,
    solver_params: Optional[Dict[str, Any]] = None,
    ignore_precomputed_triangulation: bool = False,
    verbose: bool = True,
    device=None,
) -> PreparedWindow:
    """Host preprocessing: candidates, triangulation, costs, problem build.

    Mirrors reference src/same.py:891-1215 (everything before
    ``model.optimize``). Returns a :class:`PreparedWindow`. ``device`` is
    used only by the two device computations a window can select, the
    device kNN and the Sinkhorn warm start: ``None`` is the first CUDA card
    (and raises without one), ``"cpu"`` runs their plain versions.
    """
    stage_times: Dict[str, float] = {}
    with span(stage_times, "prepare_window"):
        t_start = time.time()
        with span(stage_times, "inputs"):
            optim_params = dict(optim_params or {})

            # MetaCell duck-typing (reference src/same.py:891-899).
            if hasattr(aligned_df, "metacell_df") and hasattr(aligned_df, "metacell_delaunay"):
                mc = aligned_df
                aligned_df = mc.metacell_df
                if aligned_delaunay is None and not ignore_precomputed_triangulation:
                    aligned_delaunay = mc.metacell_delaunay
                if aligned_delaunay_vertex_col is None and hasattr(mc, "metacell_idx_col"):
                    aligned_delaunay_vertex_col = mc.metacell_idx_col
                if (optim_params.get("cell_id_col") is None) and hasattr(
                    mc, "metacell_idx_col"
                ):
                    optim_params["cell_id_col"] = mc.metacell_idx_col

            optim = init_optim_params(**optim_params)
            solver = init_solver_params(**(solver_params or {}))

            max_matches = optim["max_matches"]
            ref_metacell_match_multiplier = optim["ref_metacell_match_multiplier"]
            radius = optim["radius"]
            penalty_coeff = optim["penalty_coeff"]
            no_match_penalty = optim["no_match_penalty"]
            dist_ct_coeff = optim["dist_ct_coeff"]
            knn = optim["knn"]
            ignore_same_type = optim["ignore_same_type_triangles"]
            min_angle_deg = optim.get("min_angle_deg", 15)

            # Default size column (metacell auto-detection, reference :933-939).
            aligned_df = aligned_df.copy()
            ref_df = ref_df.copy()
            if "size" not in aligned_df.columns:
                aligned_df["size"] = 1
            if "size" not in ref_df.columns:
                ref_df["size"] = 1
            if "__orig_idx" not in aligned_df.columns:
                aligned_df["__orig_idx"] = aligned_df.index.to_numpy()
            if "__orig_idx" not in ref_df.columns:
                ref_df["__orig_idx"] = ref_df.index.to_numpy()

            # Stable vertex IDs for precomputed-triangulation remapping (:962-970).
            if aligned_delaunay_vertex_col is None:
                aligned_df["__tri_vid"] = aligned_df.index.to_numpy()
            else:
                if aligned_delaunay_vertex_col not in aligned_df.columns:
                    raise ValueError(
                        f"aligned_delaunay_vertex_col='{aligned_delaunay_vertex_col}' "
                        "not in aligned_df"
                    )
                aligned_df["__tri_vid"] = aligned_df[aligned_delaunay_vertex_col].to_numpy()

        if verbose:
            print(
                f"Aligned points: {len(aligned_df)} "
                f"(cells: {aligned_df['size'].sum():.0f}); "
                f"ref points: {len(ref_df)} (cells: {ref_df['size'].sum():.0f})"
            )

        # Candidate generation (:972-979).
        with span(stage_times, "candidates"):
            if optim["ignore_knn_if_matched"]:
                aligned_df, ref_df, valid_pairs = find_knn_with_cell_type_priority(
                    aligned_df, ref_df, radius, knn=knn, device=device
                )
            else:
                aligned_df, ref_df, valid_pairs = find_knn_within_radius(
                    aligned_df, ref_df, radius, knn=knn, device=device
                )
        valid_pairs = np.asarray(valid_pairs, dtype=np.int64).reshape(-1, 2)
        if len(valid_pairs) == 0:
            raise ValueError(
                "No valid_pairs after KNN filtering. Increase radius and/or knn."
            )
        n_aligned = len(aligned_df)
        n_ref = len(ref_df)

        # Triangulation: fresh or precomputed+remapped (:1016-1031).
        with span(stage_times, "triangulate"):
            aligned_coords = aligned_df[["X", "Y"]].to_numpy(dtype=np.float64)
            using_precomputed = False
            if aligned_delaunay is None or ignore_precomputed_triangulation:
                tris = delaunay_simplices(aligned_coords)
            else:
                using_precomputed = True
                tris = _remap_triangles_by_vertex_ids(
                    aligned_delaunay, aligned_df["__tri_vid"].to_numpy()
                )

        with span(stage_times, "filter_triangles"):
            cell_types = (
                aligned_df["cell_type"].to_numpy()
                if "cell_type" in aligned_df.columns
                else None
            )
            unconstrained_nodes: set = set()
            if using_precomputed:
                tris, unconstrained_nodes = filter_triangles_by_radius(
                    aligned_coords,
                    tris,
                    radius,
                    cell_types=cell_types,
                    ignore_same_type_triangles=ignore_same_type,
                    remove_unconstrained_nodes=True,
                    min_angle_deg=min_angle_deg,
                    verbose=verbose,
                )
            else:
                tris = filter_triangles_by_radius(
                    aligned_coords,
                    tris,
                    radius,
                    cell_types=cell_types,
                    ignore_same_type_triangles=ignore_same_type,
                    min_angle_deg=min_angle_deg,
                    verbose=verbose,
                )
            tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)

        # Remove unconstrained nodes (precomputed path only, :1055-1085).
        if unconstrained_nodes:
            if verbose:
                print(
                    f"Removing {len(unconstrained_nodes)} unconstrained nodes "
                    "from optimization"
                )
            keep = np.array(
                [i for i in range(n_aligned) if i not in unconstrained_nodes],
                dtype=np.int64,
            )
            old_to_new = np.full(n_aligned, -1, dtype=np.int64)
            old_to_new[keep] = np.arange(len(keep))
            pair_keep = old_to_new[valid_pairs[:, 0]] >= 0
            valid_pairs = np.column_stack(
                [old_to_new[valid_pairs[pair_keep, 0]], valid_pairs[pair_keep, 1]]
            )
            if tris.size:
                tri_ok = (old_to_new[tris] >= 0).all(axis=1)
                tris = old_to_new[tris[tri_ok]]
            aligned_df = aligned_df.iloc[keep].reset_index(drop=True)
            aligned_coords = aligned_df[["X", "Y"]].to_numpy(dtype=np.float64)
            n_aligned = len(aligned_df)
            if len(valid_pairs) == 0:
                # The reference proceeds with an empty model here and emits zero
                # matches for the window (src/same.py:1056-1085 has no guard) —
                # sparse real-data windows hit this when every node loses its
                # triangles to the radius/angle filters. Signal the callers.
                raise EmptyWindowError(
                    "No valid_pairs after unconstrained-node removal."
                )

        # Simplex map + triangle info (:1095-1108).
        with span(stage_times, "triangle_index"):
            aligned_simplex_map = {i: set() for i in range(n_aligned)}
            for t, tri in enumerate(tris):
                for v in tri:
                    aligned_simplex_map[int(v)].add(t)
            triangle_info = precompute_triangle_info(aligned_df, tris, aligned_simplex_map)

        # Costs, weights, orientations, the reference's coordinates.
        with span(stage_times, "costs"):
            costs = pair_costs_for(aligned_df, ref_df, valid_pairs, commonCT, dist_ct_coeff)
            ref_coords = ref_df[["X", "Y"]].to_numpy(dtype=np.float64)
            sizes_a = aligned_df["size"].to_numpy(dtype=np.float64)
            sizes_r = ref_df["size"].to_numpy(dtype=np.float64)
            tri_weights = (
                sizes_a[tris].sum(axis=1) if tris.size else np.zeros(0, dtype=np.float64)
            )
            source_signs = (
                orientation_signs_np(aligned_coords, tris)
                if tris.size
                else np.zeros(0, dtype=np.int32)
            )

        # Ref capacities (reference src/helpers.py:118-137).
        ref_has_metacells = (sizes_r > 1).any()
        if ref_has_metacells:
            mult = ref_metacell_match_multiplier
            if mult is None:
                mult = int(sizes_r.max())
            ref_limits = np.where(sizes_r > 1, mult * max_matches, max_matches).astype(
                np.int64
            )
            if verbose:
                print(
                    f"Ref has metacells: individuals get {max_matches}, "
                    f"metacells get {mult * max_matches} matches"
                )
        else:
            ref_limits = np.full(n_ref, max_matches, dtype=np.int64)

        no_match_cost = no_match_penalty * sizes_a

        with span(stage_times, "build_problem"):
            problem = build_assignment_problem(
                valid_pairs,
                costs,
                n_aligned,
                n_ref,
                ref_limits,
                penalty_coeff,
                no_match_cost,
            )

        # Auction epsilon sized to the requested optimality gap: n * eps bounds
        # the auction's suboptimality, so the target is n * eps ~ mip_gap * OPT
        # (Gurobi's relative-gap termination, reference mip_gap semantics).
        #
        # Two OPT estimates: a rigorous lower bound (sum over points of
        # min(best pair cost, no-match cost) — ignores conflicts, so often far
        # below OPT when congestion/no-match terms dominate) and a sharp upper
        # bound from a greedy matching. eps is sized from the greedy estimate
        # (with 2x margin); solve_prepared certifies the gap post-solve against
        # the realized objective and retries finer on the rare miss. Floors:
        # tpu_eps_final (absolute) and the float32 price resolution — bid
        # increments below ~2e-6 of the price scale vanish when added to f32
        # prices, turning exact ties into endless eviction wars.
        with span(stage_times, "eps_estimate"):
            best_pair_cost = np.full(n_aligned, np.inf)
            np.minimum.at(best_pair_cost, valid_pairs[:, 0], costs)
            obj_lb = float(np.minimum(best_pair_cost, no_match_cost).sum())
            from .models.assignment import matching_objective
            from .warmstart import compute_warm_start_pairs

            greedy_chosen, _greedy_unmatched = compute_warm_start_pairs(
                valid_pairs=[(int(i), int(j)) for i, j in valid_pairs],
                costs=costs,
                n_aligned=n_aligned,
                n_ref=n_ref,
                aligned_sizes=sizes_a,
                no_match_penalty=no_match_penalty,
                max_matches=max_matches,
                init_method="greedy",
                verbose=False,
            )
            greedy_mr = np.full(n_aligned, -1, dtype=np.int64)
            greedy_cost = np.zeros(n_aligned)
            for i, j, idx in greedy_chosen:
                greedy_mr[i] = j
                greedy_cost[i] = costs[idx]
            obj_est = matching_objective(
                greedy_mr, greedy_cost, n_ref, penalty_coeff, no_match_cost
            )
            gap = float(solver["mip_gap"])
            eps_floor = max(
                float(solver["tpu_eps_final"]),
                max(
                    float(np.max(costs, initial=0.0)),
                    float(np.max(no_match_cost, initial=0.0)),
                )
                * 2e-6,
            )
            # Size epsilon from the rigorous lower bound; the greedy estimate is an
            # upper bound on OPT, so it only serves as a cap — when greedy leaves
            # many cells unmatched (large no_match_penalty datasets) obj_est
            # overshoots OPT by orders of magnitude and an estimate-driven epsilon
            # forces a wasted certification re-solve.
            eps_solver = max(
                eps_floor,
                gap * min(max(obj_lb, 1e-12), obj_est) / max(n_aligned, 1),
            )

        # Warm start (reference src/same.py:1201-1215, src/init_helpers.py:180-237):
        # the MIP start becomes initial slot prices derived from the heuristic
        # matching's margins, which lets the auction skip the coarse-epsilon
        # bidding wars those matches would have fought. With init_method unset,
        # the greedy matching computed above for the eps estimate doubles as an
        # automatic warm start (disable with tpu_auto_warm_start=False).
        prices0 = None
        warm_info: Dict[str, Any] = {}
        init_method = solver.get("init_method")
        with span(stage_times, "warm_start"):
            from .warmstart import warm_start_prices

            if init_method == "hungarian":
                chosen, unmatched = compute_warm_start_pairs(
                    valid_pairs=[(int(i), int(j)) for i, j in valid_pairs],
                    costs=costs,
                    n_aligned=n_aligned,
                    n_ref=n_ref,
                    aligned_sizes=sizes_a,
                    no_match_penalty=no_match_penalty,
                    max_matches=max_matches,
                    init_method="hungarian",
                    init_big_m=solver["init_big_m"],
                    init_hungarian_max_n=solver["init_hungarian_max_n"],
                    verbose=verbose,
                )
                method_used = "hungarian"
            elif init_method == "sinkhorn":
                # Entropic-OT dual prices as the warm start (ops/sinkhorn.py): the
                # regularized transport problem's column potentials approximate the
                # assignment equilibrium prices directly.
                from .ops.sinkhorn import sinkhorn_prices

                chosen, unmatched, method_used = [], set(), "sinkhorn"
                prices0 = np.asarray(sinkhorn_prices(problem, device=device))
            elif init_method == "greedy" or (
                init_method is None and solver.get("tpu_auto_warm_start", True)
            ):
                chosen, unmatched = greedy_chosen, _greedy_unmatched
                method_used = "greedy" if init_method == "greedy" else "greedy-auto"
            elif init_method:
                raise ValueError(
                    f"Unknown init_method={init_method!r}. "
                    "Use 'greedy', 'hungarian', or 'sinkhorn'."
                )
            else:
                chosen, unmatched, method_used = [], set(), None
            if method_used is not None:
                if chosen and prices0 is None:
                    prices0 = warm_start_prices(problem, chosen)
                warm_info = {
                    "method": method_used,
                    "n_seeded": len(chosen),
                    "n_unmatched": len(unmatched),
                }
                if verbose:
                    print(
                        f"Warm start ({method_used}): {len(chosen)} seeded matches, "
                        f"{len(unmatched)} unmatched"
                    )

        return PreparedWindow(
            aligned_df=aligned_df,
            ref_df=ref_df,
            commonCT=list(commonCT),
            optim=optim,
            solver=solver,
            valid_pairs=valid_pairs,
            pair_costs=costs,
            problem=problem,
            tris=tris,
            tri_weights=tri_weights,
            source_signs=source_signs,
            aligned_coords=aligned_coords,
            ref_coords=ref_coords,
            aligned_simplex_map=aligned_simplex_map,
            triangle_info=triangle_info,
            eps_solver=eps_solver,
            prices0=prices0,
            warm_info=warm_info,
            stage_times=stage_times,
            t_start=t_start,
            eps_floor=eps_floor,
            obj_lb=obj_lb,
        )


def _solve_eager_exact(
    pw: PreparedWindow,
    deadline: Optional[float],
    verbose: bool,
) -> Optional[TearingResult]:
    """Exact eager solve for ``lazy_constraints=False`` windows.

    The reference's eager mode builds every candidate-triple orientation
    constraint up front (reference src/helpers.py:444-573) instead of lazy
    callback cuts; it is only tractable on small windows (O(n*k^3) rows),
    which is also the only regime the reference uses it in. Here the same
    complete formulation is one HiGHS solve (milp_oracle with
    ``eager_triangles=True``). Returns None when the window is too large or
    the solve fails — the caller then falls back to the zero-budget tearing
    emulation documented in ARCHITECTURE.md.

    Gate knobs: ``solver_params['tpu_eager_max_n']`` (default 600 aligned
    points) and an enumeration bound of ~3e6 candidate triples.
    """
    optim, solver = pw.optim, pw.solver
    n = pw.problem.n_aligned
    dp = float(optim["delaunay_penalty"])
    if dp <= 0.0 or len(pw.tris) == 0:
        return None  # no spatial term: lazy and eager models coincide
    max_n = solver.get("tpu_eager_max_n", 600)
    if max_n is None or n > int(max_n):
        return None
    pairs = np.asarray(pw.valid_pairs, dtype=np.int64).reshape(-1, 2)
    cnt = np.bincount(pairs[:, 0], minlength=n).astype(np.float64)
    combos = float(cnt[pw.tris].prod(axis=1).sum())
    if combos > 3e6:
        return None

    from .solver.milp_oracle import solve_mip_oracle

    slot_ref = pw.problem.slot_ref
    ref_limits = np.bincount(
        slot_ref[slot_ref >= 0], minlength=pw.problem.n_ref
    )
    nm_cost = np.asarray(pw.problem.nm_cost[:n], dtype=np.float64)
    t0 = time.time()
    try:
        res = solve_mip_oracle(
            pairs,
            np.asarray(pw.pair_costs, dtype=np.float64),
            n,
            pw.problem.n_ref,
            ref_limits,
            float(optim["penalty_coeff"]),
            nm_cost,
            triangles=pw.tris,
            tri_weights=pw.tri_weights,
            source_signs=pw.source_signs,
            ref_coords=pw.ref_coords,
            delaunay_penalty=dp,
            eager_triangles=True,
            mip_gap=float(solver["mip_gap"]),
            time_limit=(
                max(1.0, deadline - time.time()) if deadline else None
            ),
        )
    except (RuntimeError, MemoryError) as e:
        if verbose:
            print(f"eager exact solve unavailable ({e}); using tearing")
        return None

    match_ref = np.asarray(res.match_ref, dtype=np.int64)
    match_pair = np.full(n, -1, dtype=np.int64)
    for p in np.flatnonzero(res.x > 0.5):
        match_pair[pairs[p, 0]] = p
    tris = pw.tris
    src = np.asarray(pw.source_signs)
    tri_match = match_ref[tris]
    all_matched = (tri_match >= 0).all(axis=1)
    ref_xy = np.asarray(pw.ref_coords, dtype=np.float64)
    rt = np.clip(tri_match, 0, len(ref_xy) - 1)
    a, b, c = ref_xy[rt[:, 0]], ref_xy[rt[:, 1]], ref_xy[rt[:, 2]]
    cross = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]
    ) * (c[:, 0] - a[:, 0])
    sgn = np.sign(cross).astype(np.int64)
    checked = all_matched & (src != 0) & (sgn != 0)
    flipped = checked & (sgn != src)
    tearing_cost = float(
        dp * np.sum(np.asarray(pw.tri_weights, np.float64) * res.q)
    )
    solve_time = time.time() - t0
    if verbose:
        print(
            f"eager exact MILP: objective {res.objective:.3f} "
            f"({int(flipped.sum())}/{int(checked.sum())} flips, "
            f"{solve_time:.1f}s)"
        )
    return TearingResult(
        match_ref=match_ref,
        match_pair=match_pair,
        objective=float(res.objective),
        assignment_objective=float(res.objective) - tearing_cost,
        flipped=flipped,
        checked=checked,
        flip_fraction=float(flipped.sum() / max(int(checked.sum()), 1)),
        cuts_added=0,
        tear_rounds=0,
        q_active=np.asarray(res.q) > 1e-6,
        info={
            "eager_exact": True,
            "time_limit_reached": bool(
                deadline is not None and time.time() > deadline
            ),
        },
    )


def solve_prepared(
    pw: PreparedWindow,
    deadline: Optional[float] = None,
    verbose: bool = True,
    device=None,
) -> TearingResult:
    """Device phase: auction + tearing separation for one prepared window.

    ``deadline`` is an absolute ``time.time()`` value; the solve returns its
    best incumbent (flagged via ``result.info['time_limit_reached']``) once
    it passes (reference time_limit semantics, src/same.py:1245,1278).
    ``device`` is where the solve runs: ``None`` is the first CUDA card (and
    raises without one), ``"cpu"`` runs the kernels' plain versions.
    """
    with span(pw.stage_times, "solve"):
        device = resolve_device(device)
        optim, solver = pw.optim, pw.solver
        lazy_constraints = optim["lazy_constraints"]
        allowed_frac = (
            solver["lazy_allowed_flip_fraction"] if lazy_constraints else 0.0
        )
        if deadline is None and solver["time_limit"] is not None:
            deadline = pw.t_start + float(solver["time_limit"])
        if verbose:
            print(
                f"Solving: {len(pw.valid_pairs)} pairs, {len(pw.tris)} triangles, "
                f"{'lazy' if lazy_constraints else 'eager'} tearing, "
                f"dp={optim['delaunay_penalty']}"
            )

        # Selectable eager model (reference src/helpers.py:444-573): for small
        # lazy_constraints=False windows, solve the complete O(n*k^3)
        # formulation exactly instead of emulating eager via zero-budget
        # flips-pay tearing. Hard mode keeps the tearing path (its zero-flip
        # guarantee already subsumes the eager semantics).
        if not lazy_constraints and not optim["hard_spatial_constraints"]:
            eager_result = _solve_eager_exact(pw, deadline, verbose)
            if eager_result is not None:
                return eager_result

        # Small-window rule (same_tpu/core.py:662-681), kept as a choice of
        # loop: sub-512-point windows take the host separation loop, on the same
        # device as the big windows. Opt out with
        # solver_params['small_window_cpu']=False.
        small_window = bool(solver.get("small_window_cpu", True))

        def _solve(eps):
            times: Dict[str, float] = {}
            result = solve_with_tearing(
                pw.problem,
                pw.pair_costs,
                pw.tris,
                pw.tri_weights,
                pw.source_signs,
                pw.ref_coords,
                delaunay_penalty=float(optim["delaunay_penalty"]),
                penalty_coeff=float(optim["penalty_coeff"]),
                allowed_flip_fraction=allowed_frac,
                max_cuts=solver["lazy_max_cuts"],
                max_cuts_per_round=solver["lazy_max_cuts_per_incumbent"],
                max_tear_rounds=solver["tpu_max_tear_rounds"],
                plateau_patience=solver.get("tpu_tear_patience", 6),
                plateau_tol=solver.get("tpu_tear_plateau_tol", 0.0),
                eps_final=eps,
                eps_scaling=float(solver["tpu_eps_scaling"]),
                hard=optim["hard_spatial_constraints"],
                device_loop=solver.get("tpu_device_loop", "auto"),
                prices0=pw.prices0,
                deadline=deadline,
                repair_budget=solver.get("tpu_repair_budget"),
                repair_workers=solver.get("tpu_repair_workers"),
                auction_patience=solver.get("tpu_auction_patience", 128),
                mip_gap=(
                    float(solver["mip_gap"])
                    if solver.get("tpu_gap_certificate", True)
                    else None
                ),
                speculative_repair=solver.get("tpu_speculative_repair", True),
                verbose=verbose,
                device=device,
                small_window_host_loop=small_window,
                times=times,
            )
            add(pw.stage_times, times)
            return result

        result = _solve(pw.eps_solver)
        # Gap certification: the auction guarantees obj <= OPT + n * eps, so
        # lb = obj - n * eps is a valid lower bound and the mip_gap contract
        # holds iff n * eps <= mip_gap * lb. The epsilon was sized from a greedy
        # OPT estimate (prepare_window); on the rare miss, re-solve finer.
        n = pw.problem.n_aligned
        gap = float(solver["mip_gap"])
        eps = pw.eps_solver
        lb = max(result.assignment_objective - n * eps, pw.obj_lb)
        if (
            n * eps > gap * lb
            and eps > pw.eps_floor * 1.01
            and not result.info.get("time_limit_reached", False)
        ):
            eps2 = max(pw.eps_floor, gap * lb / max(n, 1) / 1.5 if lb > 0 else 0.0)
            if eps2 < eps * 0.7:
                if verbose:
                    print(
                        f"Gap not certified (n*eps={n * eps:.4g} > "
                        f"{gap:.2g}*lb={gap * lb:.4g}); re-solving at eps={eps2:.3g}"
                    )
                result2 = _solve(eps2)
                if result2.objective <= result.objective:
                    result = result2
                result.info["eps_retry"] = eps2
        if "device_time" in result.info:
            pw.stage_times["device_time"] = result.info["device_time"]
        return result


def finalize_window(
    pw: PreparedWindow,
    result: TearingResult,
    outprefix: Optional[str] = None,
    verbose: bool = True,
):
    """Output assembly, verification, artifacts (reference :1259-1481)."""
    # In the trace alone: var_out's copy of stage_times is made inside.
    with span(None, "finalize_window"):
        optim = pw.optim
        cell_id_col = optim["cell_id_col"]
        aligned_df, ref_df = pw.aligned_df, pw.ref_df
        valid_pairs, tris = pw.valid_pairs, pw.tris
        n_aligned, n_ref = pw.problem.n_aligned, pw.problem.n_ref
        T = len(tris)
        sizes_a = aligned_df["size"].to_numpy(dtype=np.float64)
        sizes_r = ref_df["size"].to_numpy(dtype=np.float64)

        match_ref = result.match_ref
        match_pair = result.match_pair
        time_limit_reached = bool(result.info.get("time_limit_reached", False))

        # ---- Output assembly (reference :1259-1278) ---------------------------
        with span(pw.stage_times, "assemble"):
            sel_pairs = np.sort(match_pair[match_pair >= 0])
            out_df = pd.DataFrame(
                {
                    "aligned_idx": valid_pairs[sel_pairs, 0],
                    "ref_idx": valid_pairs[sel_pairs, 1],
                }
            )
            for ct in list(pw.commonCT) + ["X", "Y"]:
                out_df[ct] = aligned_df[ct].to_numpy()[out_df["aligned_idx"]]
            for ct in ["X", "Y"]:
                out_df[f"ref_{ct}"] = ref_df[ct].to_numpy()[out_df["ref_idx"]]
            out_df["size"] = sizes_a[out_df["aligned_idx"]]
            out_df["ref_size"] = sizes_r[out_df["ref_idx"]]
            out_df[f"Ref_{cell_id_col}"] = ref_df[cell_id_col].to_numpy()[out_df["ref_idx"]]
            out_df[f"Aligned_{cell_id_col}"] = aligned_df[cell_id_col].to_numpy()[
                out_df["aligned_idx"]
            ]
            out_df["time_limit_reached"] = time_limit_reached

        # ---- Violation verification (:1302-1310) ------------------------------
        with span(pw.stage_times, "verify"):
            with span(pw.stage_times, "violations"):
                violations = verify_spatial_preservation(
                    aligned_df=aligned_df,
                    ref_df=ref_df,
                    matches_df=out_df,
                    triangle_info=pw.triangle_info,
                )
                if verbose:
                    print_violation_report(violations)

            # ---- Triangle area analysis (:1355-1408) ------------------------------
            with span(pw.stage_times, "triangle_areas"):
                areas_before = {}
                areas_after = {}
                flipped_tris = []
                matched_vertices = {}
                aligned_to_ref = {
                    int(i): int(j) for i, j in zip(out_df["aligned_idx"], out_df["ref_idx"])
                }
                aligned_coords, ref_coords = pw.aligned_coords, pw.ref_coords
                for t in range(T):
                    p1, p2, p3 = (int(v) for v in tris[t])
                    areas_before[t] = calculate_signed_area(
                        tuple(aligned_coords[p1]), tuple(aligned_coords[p2]),
                        tuple(aligned_coords[p3]),
                    )
                    matched = [p in aligned_to_ref for p in (p1, p2, p3)]
                    matched_vertices[t] = matched
                    if not all(matched):
                        areas_after[t] = None
                        continue
                    rc = [tuple(ref_coords[aligned_to_ref[p]]) for p in (p1, p2, p3)]
                    area = calculate_signed_area(*rc)
                    areas_after[t] = area
                    if areas_before[t] * area < 0:
                        flipped_tris.append(t)

            # Penalty points: vertices of triangles paying the q_t price (:1326-1352).
            penalty_points = set()
            for t in np.flatnonzero(result.q_active):
                for v in tris[t]:
                    penalty_points.add(int(v))
            violation_points = set(violations["points_with_violations"])
            points_both = violation_points & penalty_points

        # x vector over pairs for var_out parity.
        x_vec = np.zeros(len(valid_pairs), dtype=np.float64)
        x_vec[sel_pairs] = 1.0
        no_match_vec = np.ones(n_aligned, dtype=np.float64)
        no_match_vec[match_ref >= 0] = 0.0
        u = np.bincount(match_ref[match_ref >= 0], minlength=n_ref)
        penalty_vec = np.maximum(u - 1, 0).astype(np.float64)
        q_vec = result.q_active.astype(np.float64) if T else np.zeros(0)

        solve_time = time.time() - pw.t_start

        var_out = {
            "x": x_vec.tolist(),
            "no_match_vars": no_match_vec.tolist(),
            "penalty_vars": penalty_vec.tolist(),
            "area_penalty_vars": q_vec.tolist(),
            "violations": violations,
            "violation_penalty_comparison": {
                "points_both": list(points_both),
                "points_only_violations": list(violation_points - penalty_points),
                "points_only_penalties": list(penalty_points - violation_points),
            },
            "triangle_data": {
                "triangles": tris,
                "triangle_info": pw.triangle_info,
                "aligned_simplex_map": pw.aligned_simplex_map,
                "areas_before": areas_before,
                "areas_after": areas_after,
                "flipped_triangles": flipped_tris,
                "matched_vertices": matched_vertices,
            },
            "lazy_constraints": optim["lazy_constraints"],
            "lazy_cuts_added": result.cuts_added,
            # TPU solver diagnostics (extension keys).
            "tpu": {
                "objective": result.objective,
                "assignment_objective": result.assignment_objective,
                "flip_fraction": result.flip_fraction,
                "tear_rounds": result.tear_rounds,
                "auction_rounds": result.info.get("rounds"),
                "auction_rounds_total": result.info.get("auction_rounds_total"),
                "device_time": result.info.get("device_time"),
                "solve_time": solve_time,
                "warm_start": pw.warm_info,
                "stage_times": dict(pw.stage_times),
                "repair_stats": result.info.get("repair_stats", {}),
                "eager_exact": bool(result.info.get("eager_exact", False)),
            },
        }

        if outprefix:
            os.makedirs(outprefix, exist_ok=True)
            np.save(os.path.join(outprefix, "var_out.npy"), var_out, allow_pickle=True)
            aligned_df.to_csv(os.path.join(outprefix, "aligned_df.csv"), index=False)
            ref_df.to_csv(os.path.join(outprefix, "ref_df.csv"), index=False)
            # Solver-state dump — the analog of the reference's matching_model.lp
            # (reference src/same.py:1218-1224): a structured description of the
            # model the solver actually saw plus how the solve went.
            import json

            state = {
                "model": {
                    "n_aligned": int(n_aligned),
                    "n_ref": int(n_ref),
                    "n_pairs": int(len(valid_pairs)),
                    "n_triangles": int(T),
                    "padded_shape": list(pw.problem.costs.shape),
                    "n_slots": int(pw.problem.n_slots),
                    "slot_copies": int(pw.problem.n_slot_copies),
                    "eps_final": float(pw.eps_solver),
                },
                "params": {
                    k: v
                    for k, v in optim.items()
                    if isinstance(v, (int, float, str, bool, type(None)))
                },
                "solve": {
                    "objective": float(result.objective),
                    "assignment_objective": float(result.assignment_objective),
                    "flip_fraction": float(result.flip_fraction),
                    "tear_rounds": int(result.tear_rounds),
                    "cuts_added": int(result.cuts_added),
                    "time_limit_reached": time_limit_reached,
                    "eager_exact": bool(result.info.get("eager_exact", False)),
                    "warm_start": pw.warm_info,
                    "stage_times": {
                        k: round(float(v), 4) for k, v in pw.stage_times.items()
                    },
                    "repair_stats": result.info.get("repair_stats", {}),
                },
            }
            with open(os.path.join(outprefix, "solver_state.json"), "w") as f:
                json.dump(state, f, indent=1)

        # triangle_violation from actual signed-area flips (:1464-1471).
        flipped_nodes = set()
        for t in flipped_tris:
            for v in tris[t]:
                flipped_nodes.add(int(v))
        out_df["triangle_violation"] = out_df["aligned_idx"].isin(flipped_nodes)
        out_df["filtered_violation"] = out_df["aligned_idx"].isin(points_both)
        out_df["run_time"] = solve_time

        if outprefix:
            out_df.to_csv(os.path.join(outprefix, "matches_df.csv"), index=False)
        if verbose:
            print(
                f"Matches: {len(out_df)}/{n_aligned}; flips: "
                f"{len(flipped_tris)}/{T}; objective: {result.objective:.3f}; "
                f"time: {solve_time:.2f}s"
            )
        return out_df, var_out


class EmptyWindowError(ValueError):
    """A window whose optimization problem is empty (zero candidate pairs).

    Mirrors the reference's behavior of solving an empty model and emitting
    zero matches for such windows rather than failing the whole sweep.
    """


def empty_matches_df(commonCT, cell_id_col: str) -> pd.DataFrame:
    """Zero-row matches frame with the full output column contract."""
    cols = (
        ["aligned_idx", "ref_idx"]
        + list(commonCT)
        + [
            "X", "Y", "ref_X", "ref_Y", "size", "ref_size",
            f"Ref_{cell_id_col}", f"Aligned_{cell_id_col}",
            "time_limit_reached", "triangle_violation",
            "filtered_violation", "run_time",
        ]
    )
    return pd.DataFrame({c: [] for c in cols})


def run_same(
    ref_df,
    aligned_df,
    commonCT,
    outprefix: Optional[str] = None,
    aligned_delaunay=None,
    aligned_delaunay_vertex_col: Optional[str] = None,
    optim_params: Optional[Dict[str, Any]] = None,
    gurobi_params: Optional[Dict[str, Any]] = None,
    solver_params: Optional[Dict[str, Any]] = None,
    ignore_precomputed_triangulation: bool = False,
    verbose: bool = True,
    device=None,
):
    """Find optimal spatial matches between aligned and reference cells.

    See module docstring for the I/O contract. ``gurobi_params`` is accepted
    for API parity and merged with ``solver_params``. ``device`` is where
    the solve runs (see :func:`solve_prepared`): the first CUDA card by
    default, ``"cpu"`` on request.
    """
    if solver_params is None:
        solver_params = gurobi_params or {}
    elif gurobi_params:
        merged = dict(gurobi_params)
        merged.update(solver_params)
        solver_params = merged

    try:
        pw = prepare_window(
            ref_df,
            aligned_df,
            commonCT,
            aligned_delaunay=aligned_delaunay,
            aligned_delaunay_vertex_col=aligned_delaunay_vertex_col,
            optim_params=optim_params,
            solver_params=solver_params,
            ignore_precomputed_triangulation=ignore_precomputed_triangulation,
            verbose=verbose,
            device=device,
        )
    except EmptyWindowError as e:
        if verbose:
            print(f"Empty window ({e}); emitting zero matches.")
        cell_id_col = (optim_params or {}).get("cell_id_col") or (
            getattr(aligned_df, "metacell_idx_col", None) or "Cell_Num_Old"
        )
        return empty_matches_df(commonCT, cell_id_col), {"empty_window": True}
    result = solve_prepared(pw, verbose=verbose, device=device)
    return finalize_window(pw, result, outprefix=outprefix, verbose=verbose)
