"""Warm-start heuristics for the assignment solver.

Parity with the reference's MIP-start helpers (reference
src/init_helpers.py:46-177): 'greedy' cost-sorted one-to-one selection with
match-vs-unmatched comparison, and 'hungarian' dense assignment with a
per-row dummy unmatched column. For the auction solver these become (a) an
initial assignment hint and (b) initial slot prices derived from the
assignment's dual structure; they can also be used standalone.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np


def compute_warm_start_pairs(
    *,
    valid_pairs: Sequence[Tuple[int, int]],
    costs: Sequence[float],
    n_aligned: int,
    n_ref: int,
    aligned_sizes: np.ndarray,
    no_match_penalty: float,
    max_matches: int,
    init_method: str,
    init_big_m: float = 1e9,
    init_hungarian_max_n: int = 5000,
    verbose: bool = True,
) -> Tuple[List[Tuple[int, int, int]], Set[int]]:
    """Compute (chosen (i, j, pair_idx) edges, unmatched aligned indices).

    Semantics match reference compute_mip_start_pairs: 'hungarian' requires
    max_matches == 1 and silently skips when n_aligned + n_ref exceeds
    ``init_hungarian_max_n``.
    """
    method = str(init_method).lower()
    if method not in {"greedy", "hungarian"}:
        raise ValueError(
            f"Unknown init_method={init_method!r}. Use 'greedy' or 'hungarian'."
        )
    if method == "hungarian" and max_matches != 1:
        raise ValueError("init_method='hungarian' requires max_matches == 1.")
    if len(valid_pairs) != len(costs):
        raise ValueError("valid_pairs and costs must have the same length.")

    costs_arr = np.asarray(costs, dtype=float)
    unmatched_cost = float(no_match_penalty) * np.asarray(aligned_sizes, dtype=float)
    chosen: List[Tuple[int, int, int]] = []
    unmatched: Set[int] = set()

    if method == "greedy":
        order = np.argsort(costs_arr, kind="stable")
        best_cost = np.full(n_aligned, np.inf)
        for idx, (i, _j) in enumerate(valid_pairs):
            best_cost[i] = min(best_cost[i], costs_arr[idx])
        prefer_match = best_cost < unmatched_cost
        used_a: Set[int] = set()
        used_r: Set[int] = set()
        for idx in order:
            i, j = valid_pairs[idx]
            if i in used_a or j in used_r or not prefer_match[i]:
                continue
            chosen.append((int(i), int(j), int(idx)))
            used_a.add(i)
            used_r.add(j)
        unmatched = set(range(n_aligned)) - used_a
        return chosen, unmatched

    # hungarian
    if (n_aligned + n_ref) > int(init_hungarian_max_n):
        if verbose:
            print(
                f"Skipping Hungarian init: n_aligned+n_ref={n_aligned + n_ref} "
                f"> init_hungarian_max_n={init_hungarian_max_n}"
            )
        return [], set()
    from scipy.optimize import linear_sum_assignment

    cost_mat = np.full((n_aligned, n_ref + n_aligned), float(init_big_m))
    for idx, (i, j) in enumerate(valid_pairs):
        cost_mat[i, j] = costs_arr[idx]
    for i in range(n_aligned):
        cost_mat[i, n_ref + i] = unmatched_cost[i]
    rows, cols = linear_sum_assignment(cost_mat)
    pair_to_idx = {(i, j): idx for idx, (i, j) in enumerate(valid_pairs)}
    used_r: Set[int] = set()
    for i, col in zip(rows, cols):
        i, col = int(i), int(col)
        if col < n_ref and cost_mat[i, col] < init_big_m * 0.5:
            if col in used_r:
                continue
            used_r.add(col)
            idx = pair_to_idx.get((i, col))
            if idx is not None:
                chosen.append((i, col, int(idx)))
        else:
            unmatched.add(i)
    return chosen, unmatched


def warm_start_prices(
    problem,
    chosen_pairs: Sequence[Tuple[int, int, int]],
    margin: float = 0.0,
) -> Optional[np.ndarray]:
    """Initial slot prices from a warm-start matching.

    Each chosen ref slot is priced at the winner's margin over its no-match
    reservation (clipped at 0), giving the auction a dual-feasible-ish start.
    """
    prices = np.zeros(problem.n_slots + 1, dtype=problem.costs.dtype)
    for i, _j, pair_idx in chosen_pairs:
        cols = np.flatnonzero(problem.pair_idx[i] == pair_idx)
        if not len(cols):
            continue
        c = cols[0]
        slack = float(problem.nm_cost[i] - problem.costs[i, c]) - margin
        if slack > 0:
            prices[problem.slots[i, c]] = max(prices[problem.slots[i, c]], slack)
    return prices
