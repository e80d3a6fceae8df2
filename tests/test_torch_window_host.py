"""``prepare_window`` and ``finalize_window`` against the loops the port
copies from the JAX package.

The small labeled window of ``torch_parity.py`` goes through the three
stages on the CPU twice: as a plain frame (a fresh Delaunay triangulation)
and as the MetaCell of its MS = 1 collapse (the precomputed triangulation,
remapped and filtered). What the window's host passes
(``same_tpu_torch/host_arrays.py``) produced must equal what
``warmstart.py``, ``eval.py`` and the per-triangle loops give on the same
inputs: the triangle data, the violations, the greedy warm start, the
auction's epsilon and its initial prices.
"""

import numpy as np
import pytest

import same_tpu_torch
from same_tpu_torch import core, eval as port_eval, warmstart
from same_tpu_torch.models.assignment import matching_objective
from torch_parity import (
    LABEL_TYPES, WINDOW_OPTIM, WINDOW_SOLVER, areas_loop, assert_same, labeled_window,
    vertices_loop,
)

# Two tear rounds and no repair leave flipped triangles to compare.
SOLVER = dict(WINDOW_SOLVER, tpu_max_tear_rounds=2, tpu_eps_final=0.5,
              tpu_repair_budget=0.0)


def _window(kind):
    ref, qry = labeled_window()
    if kind == "frame":
        qry = qry.assign(metacell_id=np.arange(len(qry)))
        return ref, qry
    return ref, same_tpu_torch.greedy_triangle_collapse(
        qry, max_metacell_size=1, r_max=2.0, min_angle_deg=5,
        return_object=True, verbose=False,
    )


@pytest.mark.parametrize("kind", ["frame", "metacell"])
def test_window_host_passes_equal_the_copies(kind):
    ref, aligned = _window(kind)
    pw = core.prepare_window(ref, aligned, LABEL_TYPES, optim_params=WINDOW_OPTIM,
                             solver_params=SOLVER, verbose=False, device="cpu")
    result = core.solve_prepared(pw, verbose=False, device="cpu")
    matches, var_out = core.finalize_window(pw, result, verbose=False)
    tris, n = pw.tris, pw.problem.n_aligned
    assert len(tris) > 0 and len(matches) > 0

    # Triangle index.
    simplex_map = {i: set() for i in range(n)}
    for t, tri in enumerate(tris):
        for v in tri:
            simplex_map[int(v)].add(t)
    info = port_eval.precompute_triangle_info(pw.aligned_df, tris, simplex_map)
    data = var_out["triangle_data"]
    assert_same({k: list(v) for k, v in data["aligned_simplex_map"].items()},
                {k: list(v) for k, v in simplex_map.items()})
    assert_same(data["triangle_info"], info)

    # Greedy warm start, the objective estimate, epsilon and prices.
    sizes = pw.aligned_df["size"].to_numpy(dtype=np.float64)
    nmp = pw.optim["no_match_penalty"]
    chosen, unmatched = warmstart.compute_warm_start_pairs(
        valid_pairs=[(int(i), int(j)) for i, j in pw.valid_pairs],
        costs=pw.pair_costs, n_aligned=n, n_ref=pw.problem.n_ref,
        aligned_sizes=sizes, no_match_penalty=nmp,
        max_matches=pw.optim["max_matches"], init_method="greedy", verbose=False,
    )
    warm = var_out["tpu"]["warm_start"]
    assert warm["method"] == "greedy-auto" and warm["greedy_rounds"] >= 1
    assert (warm["n_seeded"], warm["n_unmatched"]) == (len(chosen), len(unmatched))
    greedy_mr = np.full(n, -1, dtype=np.int64)
    greedy_cost = np.zeros(n)
    for i, j, idx in chosen:
        greedy_mr[i] = j
        greedy_cost[i] = pw.pair_costs[idx]
    obj_est = matching_objective(greedy_mr, greedy_cost, pw.problem.n_ref,
                                 pw.optim["penalty_coeff"], nmp * sizes)
    eps = max(pw.eps_floor,
              float(pw.solver["mip_gap"]) * min(max(pw.obj_lb, 1e-12), obj_est) / max(n, 1))
    assert_same(pw.eps_solver, eps)
    assert_same(pw.prices0, warmstart.warm_start_prices(pw.problem, chosen))

    # Violations, areas, and the points and flags built from them.
    violations = port_eval.verify_spatial_preservation(pw.aligned_df, pw.ref_df,
                                                       matches, info)
    assert_same(var_out["violations"], violations)
    before, after, flipped, matched = areas_loop(
        tris, pw.aligned_coords, pw.ref_coords, matches)
    assert_same([data[k] for k in ("areas_before", "areas_after",
                                   "flipped_triangles", "matched_vertices")],
                [before, after, flipped, matched])
    assert len(flipped) > 0
    penalty = vertices_loop(tris, np.flatnonzero(result.q_active))
    both = set(violations["points_with_violations"]) & penalty
    assert_same(var_out["violation_penalty_comparison"]["points_both"], list(both))
    flipped_nodes = vertices_loop(tris, flipped)
    np.testing.assert_array_equal(matches["triangle_violation"].to_numpy(),
                                  matches["aligned_idx"].isin(flipped_nodes).to_numpy())
