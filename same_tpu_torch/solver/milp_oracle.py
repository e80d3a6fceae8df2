"""Exact MIP oracle (HiGHS via scipy.optimize.milp) for parity testing.

Reimplements the reference's Gurobi formulation exactly — binary match vars,
congestion penalties, no-match vars, per-triangle tearing vars ``q_t``, and
the lazy orientation-cut loop (reference src/same.py:621-704, 1112-1197;
src/helpers.py:102-161) — on an open solver, so the TPU auction solver can be
validated to objective parity on small instances without Gurobi. Not a
production path: dense small problems only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp
from time import monotonic as _now


@dataclass
class OracleResult:
    x: np.ndarray              # [P] 0/1 pair selections
    match_ref: np.ndarray      # [n] matched ref row or -1
    objective: float
    q: np.ndarray              # [T] tearing penalty vars
    cuts: list = field(default_factory=list)
    status: int = 0


def solve_mip_oracle(
    pairs: np.ndarray,
    pair_costs: np.ndarray,
    n_aligned: int,
    n_ref: int,
    ref_limits: np.ndarray,
    penalty_coeff: float,
    no_match_cost: np.ndarray,
    triangles: Optional[np.ndarray] = None,
    tri_weights: Optional[np.ndarray] = None,
    source_signs: Optional[np.ndarray] = None,
    ref_coords: Optional[np.ndarray] = None,
    delaunay_penalty: float = 0.0,
    lazy_allowed_flip_fraction: float = 0.0,
    lazy_max_cuts: Optional[int] = None,
    lazy_max_cuts_per_incumbent: int = 1000,
    max_outer_iters: int = 50,
    mip_gap: float = 1e-6,
    time_limit: Optional[float] = None,
    node_limit: Optional[int] = None,
    init_cuts: Optional[list] = None,
    eager_triangles: bool = False,
    flip_allowance: float = 0.0,
    registered_cuts: Optional[list] = None,
) -> OracleResult:
    """Solve the window matching MIP exactly, with the lazy-cut outer loop.

    ``init_cuts`` pre-seeds the lazy-cut registry with (tri_idx, pa, pb, pc)
    tuples (pair indices into ``pairs``) so a caller that already knows
    which triples flip — e.g. the component repair starting from a concrete
    incumbent — skips the outer iterations that would rediscover them.

    ``flip_allowance`` (in delaunay_penalty * tri_weight units) models the
    reference callback's allowed-flip budget *inside* the MIP: per-triangle
    credit variables ``f_t`` (0 <= f_t <= q_t, sum dp*w_t*f_t <= allowance)
    cancel the tearing cost of flips up to the budget, EXCEPT flips realized
    through a triple in ``registered_cuts`` — a registered cut always pays
    when its exact triple is selected (Gurobi semantics: once a lazy cut is
    in the model its q_t is charged regardless of the final flip fraction;
    only *unregistered* flips ride the allowance). Used by the component
    repair so its subproblems can spend leftover window-level flip budget
    on cost-reducing flips, exactly like the reference's solver does
    (reference src/same.py:641-669 flip-fraction early-exit).

    ``eager_triangles`` enumerates EVERY candidate-pair triple of every
    triangle whose orientation flips versus ``source_signs`` and adds its
    cut up front (the reference's eager O(n*k^3) formulation, reference
    src/helpers.py:444-573). The spatial model is then complete, so the
    outer separation loop is skipped and one HiGHS solve is exact. Viable
    when sum_t prod(candidate counts) is bounded (small windows and the
    repair's component subproblems); the lazy loop remains the default.

    ``time_limit`` bounds the WHOLE call (all outer iterations share it).
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    P = len(pairs)
    T = len(triangles) if triangles is not None else 0
    tris = np.asarray(triangles, dtype=np.int64).reshape(-1, 3) if T else None

    # Variable layout: [x (P), p (n_ref), nm (n_aligned), q (T), f (F)]
    # where the optional f block (F = T when a flip allowance is modeled,
    # else 0) holds the free-flip credit variables.
    dpw = (
        np.asarray(tri_weights, dtype=np.float64) * float(delaunay_penalty)
        if T
        else np.empty(0)
    )
    F = T if (T and flip_allowance > 0.0 and delaunay_penalty > 0.0) else 0
    nv = P + n_ref + n_aligned + T + F
    c = np.concatenate(
        [
            np.asarray(pair_costs, dtype=np.float64),
            np.full(n_ref, float(penalty_coeff)),
            np.asarray(no_match_cost, dtype=np.float64),
            dpw,
            -dpw if F else np.empty(0),
        ]
    )
    integrality = np.concatenate(
        [np.ones(P), np.zeros(n_ref + n_aligned + T + F)]
    )
    lb = np.zeros(nv)
    ub = np.concatenate(
        [
            np.ones(P),
            np.full(n_ref, 1000.0),
            np.ones(n_aligned),
            np.full(T, np.inf) if T else np.empty(0),
            np.ones(F),
        ]
    )

    rows, cols, vals = [], [], []
    con_lb, con_ub = [], []
    r = 0
    # per-aligned: sum x + nm == 1
    for i in range(n_aligned):
        idxs = np.flatnonzero(pairs[:, 0] == i)
        for p in idxs:
            rows.append(r); cols.append(p); vals.append(1.0)
        rows.append(r); cols.append(P + n_ref + i); vals.append(1.0)
        con_lb.append(1.0); con_ub.append(1.0)
        r += 1
    # per-ref: sum x <= limit ; sum x - p_j <= 1
    for j in range(n_ref):
        idxs = np.flatnonzero(pairs[:, 1] == j)
        if len(idxs) == 0:
            continue
        for p in idxs:
            rows.append(r); cols.append(p); vals.append(1.0)
        con_lb.append(-np.inf); con_ub.append(float(ref_limits[j]))
        r += 1
        for p in idxs:
            rows.append(r); cols.append(p); vals.append(1.0)
        rows.append(r); cols.append(P + j); vals.append(-1.0)
        con_lb.append(-np.inf); con_ub.append(1.0)
        r += 1

    if eager_triangles and T and delaunay_penalty > 0.0:
        # Eager spatial constraints (reference src/helpers.py:444-573): for
        # every triangle and every candidate-assignment triple of its three
        # vertices, if that triple flips the orientation, add
        # x_a + x_b + x_c <= 2 + q_t up front. Vectorized per triangle over
        # the candidate grid; makes the model complete so no separation
        # loop is needed.
        ref_xy = np.asarray(ref_coords, np.float64)
        cand_pairs = [
            np.flatnonzero(pairs[:, 0] == i) for i in range(n_aligned)
        ]
        for t in range(T):
            s = int(source_signs[t])
            if s == 0:
                continue
            a, b, c3 = (int(v) for v in tris[t])
            pa_l, pb_l, pc_l = cand_pairs[a], cand_pairs[b], cand_pairs[c3]
            if not (len(pa_l) and len(pb_l) and len(pc_l)):
                continue
            A_ = ref_xy[pairs[pa_l, 1]]
            B_ = ref_xy[pairs[pb_l, 1]]
            C_ = ref_xy[pairs[pc_l, 1]]
            cross = (
                (B_[None, :, 0] - A_[:, None, 0])[:, :, None]
                * (C_[None, None, :, 1] - A_[:, None, None, 1])
                - (B_[None, :, 1] - A_[:, None, 1])[:, :, None]
                * (C_[None, None, :, 0] - A_[:, None, None, 0])
            )
            rs = np.sign(cross)
            for i, j, k in zip(*np.nonzero((rs != 0) & (rs != s))):
                for p in (pa_l[i], pb_l[j], pc_l[k]):
                    rows.append(r); cols.append(int(p)); vals.append(1.0)
                rows.append(r)
                cols.append(P + n_ref + n_aligned + t)
                vals.append(-1.0)
                con_lb.append(-np.inf); con_ub.append(2.0)
                r += 1

    if F:
        q0, f0 = P + n_ref + n_aligned, P + n_ref + n_aligned + T
        # f_t <= q_t: credit only flips that actually happen.
        for t in range(T):
            rows.append(r); cols.append(f0 + t); vals.append(1.0)
            rows.append(r); cols.append(q0 + t); vals.append(-1.0)
            con_lb.append(-np.inf); con_ub.append(0.0)
            r += 1
        # Budget: sum dp*w_t * f_t <= flip_allowance.
        for t in range(T):
            if dpw[t] != 0.0:
                rows.append(r); cols.append(f0 + t); vals.append(float(dpw[t]))
        con_lb.append(-np.inf); con_ub.append(float(flip_allowance))
        r += 1
        # A registered triple, when selected, pays regardless of budget:
        # x_pa + x_pb + x_pc + f_t <= 3.
        for (t, pa, pb, pc) in registered_cuts or []:
            for p in (pa, pb, pc):
                rows.append(r); cols.append(int(p)); vals.append(1.0)
            rows.append(r); cols.append(f0 + int(t)); vals.append(1.0)
            con_lb.append(-np.inf); con_ub.append(3.0)
            r += 1

    base_rows, base_cols, base_vals = list(rows), list(cols), list(vals)
    base_lb, base_ub = list(con_lb), list(con_ub)
    base_r = r
    t_call0 = _now()

    # (tri_idx, pa, pb, pc); optionally seeded by the caller.
    cuts: list[tuple[int, int, int, int]] = (
        [tuple(int(v) for v in cut) for cut in init_cuts] if init_cuts else []
    )

    def solve_once():
        rr, cc, vv = list(base_rows), list(base_cols), list(base_vals)
        clb, cub = list(base_lb), list(base_ub)
        rloc = base_r
        for (t, pa, pb, pc) in cuts:
            for p in (pa, pb, pc):
                rr.append(rloc); cc.append(p); vv.append(1.0)
            rr.append(rloc); cc.append(P + n_ref + n_aligned + t); vv.append(-1.0)
            clb.append(-np.inf); cub.append(2.0)
            rloc += 1
        A = sparse.csr_matrix((vv, (rr, cc)), shape=(rloc, nv))
        options = {"mip_rel_gap": mip_gap}
        if node_limit is not None:
            # Testing knob only. Measured caveat: these component-scale
            # models are usually ROOT-BOUND in HiGHS (time runs out at node
            # 0), where a node limit never binds — wall-clock is the only
            # cut-off that does, so production repair does not use this.
            options["node_limit"] = int(node_limit)
        if time_limit is not None:
            # The limit covers the whole call: outer iterations share it.
            options["time_limit"] = max(
                0.5, float(time_limit) - (_now() - t_call0)
            )
        res = milp(
            c=c,
            constraints=LinearConstraint(A, np.array(clb), np.array(cub)),
            integrality=integrality,
            bounds=Bounds(lb, ub),
            options=options,
        )
        if res.x is None:
            raise RuntimeError(f"MILP oracle failed: {res.message}")
        return res

    pair_index_by_vertex = {}
    for p, (i, j) in enumerate(pairs):
        pair_index_by_vertex.setdefault(int(i), {})[int(j)] = p

    res = solve_once()
    cuts_added_total = 0
    for _ in range(0 if eager_triangles else max_outer_iters):
        xv = res.x[:P] > 0.5
        match_ref = np.full(n_aligned, -1, dtype=np.int64)
        match_pair = np.full(n_aligned, -1, dtype=np.int64)
        for p in np.flatnonzero(xv):
            match_ref[pairs[p, 0]] = pairs[p, 1]
            match_pair[pairs[p, 0]] = p
        if not T or delaunay_penalty == 0.0:
            break
        if time_limit is not None and _now() - t_call0 > time_limit:
            break
        # Separation: flipped triangles under current matching (reference
        # src/same.py:641-669 semantics).
        violating = []
        checked = 0
        for t in range(T):
            a, b, cc_ = tris[t]
            if match_ref[a] < 0 or match_ref[b] < 0 or match_ref[cc_] < 0:
                continue
            if source_signs[t] == 0:
                continue
            pa_, pb_, pc_ = ref_coords[match_ref[a]], ref_coords[match_ref[b]], ref_coords[match_ref[cc_]]
            cross = (pb_[0] - pa_[0]) * (pc_[1] - pa_[1]) - (pb_[1] - pa_[1]) * (
                pc_[0] - pa_[0]
            )
            rs = np.sign(cross)
            if rs == 0:
                continue
            checked += 1
            if rs != source_signs[t]:
                violating.append(t)
        if checked == 0 or not violating:
            break
        if lazy_allowed_flip_fraction is not None:
            if len(violating) / checked <= lazy_allowed_flip_fraction:
                break
        added = 0
        existing = set(cuts)
        for t in violating:
            if added >= lazy_max_cuts_per_incumbent:
                break
            if lazy_max_cuts is not None and cuts_added_total >= lazy_max_cuts:
                break
            a, b, cc_ = tris[t]
            cut = (
                int(t),
                pair_index_by_vertex[int(a)][int(match_ref[a])],
                pair_index_by_vertex[int(b)][int(match_ref[b])],
                pair_index_by_vertex[int(cc_)][int(match_ref[cc_])],
            )
            if cut in existing:
                continue
            cuts.append(cut)
            existing.add(cut)
            added += 1
            cuts_added_total += 1
        if added == 0:
            break
        res = solve_once()

    xv = res.x[:P] > 0.5
    match_ref = np.full(n_aligned, -1, dtype=np.int64)
    for p in np.flatnonzero(xv):
        match_ref[pairs[p, 0]] = pairs[p, 1]
    q = res.x[P + n_ref + n_aligned : P + n_ref + n_aligned + T] if T else np.empty(0)
    return OracleResult(
        x=res.x[:P],
        match_ref=match_ref,
        objective=float(res.fun),
        q=q,
        cuts=cuts,
        status=int(res.status),
    )
