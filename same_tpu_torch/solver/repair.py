"""Incremental exact-objective local repair for space-tearing solutions.

Branch-and-bound finds coordinated escapes the cut-penalty loop cannot
represent — unmatching one vertex disables every orientation check through
it, and re-matching a vertex elsewhere deactivates its cut triples. This
module closes most of that gap with a greedy 1-move descent (plus a
2-vertex compound move) over the vertices involved in flips and cuts,
evaluating every candidate move by O(degree) delta accounting instead of a
full objective recomputation (the round-1 implementation recomputed
O(n + T + cuts) per candidate, which was pathological on flip-heavy
10k-cell windows).

The maintained state mirrors the exact MIP semantics of
tearing._finish_solve.true_objective:

  objective = sum(pair costs) + penalty_coeff * sum(max(0, u_j - 1))
            + sum(no-match costs) + dp * sum(w_t over triangles with an
              ACTIVE registered cut triple)

A cut triple (t, pair_a, pair_b, pair_c) is active iff all three vertices
still hold exactly those pairs; a triangle pays once no matter how many of
its triples are active.
"""

from __future__ import annotations

import time as _time

import numpy as np

from ..trace import span


class _RepairState:
    """Mutable matching state with O(degree) move deltas."""

    def __init__(
        self, problem, pair_costs, tris, tri_weights, source_signs,
        ref_coords, match_ref, match_pair, cut_arrays, delaunay_penalty,
        penalty_coeff, flip_penalty: float = 0.0,
        flip_allowance: float = 0.0,
    ):
        self.n = problem.n_aligned
        self.pair_costs = np.asarray(pair_costs, np.float64)
        self.nm = np.asarray(problem.nm_cost[: self.n], np.float64)
        self.pc = float(penalty_coeff)
        self.tris = np.asarray(tris, np.int64).reshape(-1, 3)
        self.T = len(self.tris)
        self.w = np.asarray(tri_weights, np.float64)
        self.dpw = float(delaunay_penalty) * self.w
        self.src = np.asarray(source_signs, np.int32)
        self.ref_xy = np.asarray(ref_coords, np.float64)
        self.match_ref = match_ref
        self.match_pair = match_pair
        self.problem = problem
        # Global pair id -> ref row (for mapping registered cut triples
        # into component subproblems).
        self.ref_of_pair = np.full(len(self.pair_costs), -1, np.int64)
        self.ref_of_pair[problem.pair_idx[problem.valid]] = problem.cand_ref[
            problem.valid
        ]

        # Hard per-ref limits from the slot expansion (slot_ref carries -1
        # entries for shape-bucket padding slots).
        slot_ref = problem.slot_ref
        self.limits = np.bincount(
            slot_ref[slot_ref >= 0], minlength=problem.n_ref
        )
        self.u = np.bincount(
            match_ref[match_ref >= 0], minlength=problem.n_ref
        )

        # CSR vertex -> incident triangles.
        flat_v = self.tris.ravel()
        flat_t = np.repeat(np.arange(self.T), 3)
        order = np.argsort(flat_v, kind="stable")
        self._vt_t = flat_t[order]
        self._vt_start = np.searchsorted(
            flat_v[order], np.arange(self.n + 1)
        )

        # Cut registry: ct [K] triangle ids, cv [K, 3] vertices, cp [K, 3]
        # pair ids; CSR vertex -> (cut row, position).
        if cut_arrays is not None and len(cut_arrays[0]):
            self.ct, self.cv, self.cp = (
                np.asarray(cut_arrays[0]),
                np.asarray(cut_arrays[1]),
                np.asarray(cut_arrays[2]),
            )
            K = len(self.ct)
            flat_cv = self.cv.ravel()
            flat_k = np.repeat(np.arange(K), 3)
            flat_pos = np.tile(np.arange(3), K)
            order = np.argsort(flat_cv, kind="stable")
            self._vc_k = flat_k[order]
            self._vc_pos = flat_pos[order]
            self._vc_start = np.searchsorted(
                flat_cv[order], np.arange(self.n + 1)
            )
            self.cmatch = self.match_pair[self.cv] == self.cp       # [K, 3]
            self.cut_nmatch = self.cmatch.sum(axis=1)
            self.tri_act = np.zeros(self.T, np.int64)
            np.add.at(self.tri_act, self.ct[self.cut_nmatch == 3], 1)
        else:
            self.ct = np.zeros(0, np.int64)
            self._vc_start = np.zeros(self.n + 1, np.int64)
            self._vc_k = np.zeros(0, np.int64)
            self._vc_pos = np.zeros(0, np.int64)
            self.cmatch = np.zeros((0, 3), bool)
            self.cut_nmatch = np.zeros(0, np.int64)
            self.tri_act = np.zeros(self.T, np.int64)

        # With flip_penalty > 0, flipped triangles pay dp * w_t even without
        # a registered cut triple — beyond the budget allowance ``W_A``
        # (in dp*w units). This emulates Gurobi's unlimited lazy callback:
        # a final incumbent there either has its flips cut (paying q_t) or
        # sits within the allowed flip fraction; an UNregistered flip is
        # never free above budget, because the callback would cut it on the
        # next incumbent. W_A = 0 reproduces the zero-budget/eager "every
        # flip pays" semantics exactly (cut-active and free-flip terms are
        # disjoint and union to cut-active | flipped).
        self.flip_pen = float(flip_penalty)
        self.W_A = float(flip_allowance)
        if self.flip_pen > 0.0 and self.T:
            self.flipped = self.local_flips(np.arange(self.T))
        else:
            self.flipped = np.zeros(self.T, bool)
        self.S_free = float(
            self.dpw[self.flipped & ~(self.tri_act > 0)].sum()
        )

        self.changed: set = set()
        matched = match_pair >= 0
        self.obj = (
            float(self.pair_costs[match_pair[matched]].sum())
            + self.pc * float(np.maximum(self.u - 1, 0).sum())
            + float(self.nm[~matched].sum())
            + float(self.dpw[self.tri_act > 0].sum())
            + max(0.0, self.S_free - self.W_A)
        )

    # -- local structure lookups -----------------------------------------
    def tris_of(self, v):
        return self._vt_t[self._vt_start[v] : self._vt_start[v + 1]]

    def cuts_of(self, v):
        s, e = self._vc_start[v], self._vc_start[v + 1]
        return self._vc_k[s:e], self._vc_pos[s:e]

    def local_flips(self, ts, override_v=None, override_j=None):
        """Flip flags for triangle ids ``ts`` under the current matching.

        ``override_v``/``override_j`` evaluate the flags as if vertex v were
        matched to ref j (side-effect-free what-if for move deltas).
        """
        if len(ts) == 0:
            return np.zeros(0, bool)
        sub = self.tris[ts]
        mr = self.match_ref[sub]
        if override_v is not None:
            mr = np.where(sub == override_v, override_j, mr)
        ok = (mr >= 0).all(axis=1)
        out = np.zeros(len(ts), bool)
        if ok.any():
            p = self.ref_xy[np.clip(mr[ok], 0, len(self.ref_xy) - 1)]
            cross = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
                p[:, 1, 1] - p[:, 0, 1]
            ) * (p[:, 2, 0] - p[:, 0, 0])
            rs = np.sign(cross).astype(np.int32)
            s = self.src[ts][ok]
            out[ok] = (rs != 0) & (s != 0) & (rs != s)
        return out

    # -- move accounting --------------------------------------------------
    def delta(self, v, p_new, j_new):
        """Objective change of moving vertex v to pair p_new / ref j_new."""
        p_old = self.match_pair[v]
        j_old = self.match_ref[v]
        d = 0.0
        d += self.pair_costs[p_new] if p_new >= 0 else self.nm[v]
        d -= self.pair_costs[p_old] if p_old >= 0 else self.nm[v]
        if j_old != j_new:
            if j_old >= 0 and self.u[j_old] >= 2:
                d -= self.pc
            if j_new >= 0 and self.u[j_new] >= 1:
                d += self.pc
        # Tearing term: a triangle pays dp * w_t iff it has an active cut
        # triple OR (flip-pay mode) it is flipped; accumulate per-triangle
        # pay-state changes across both mechanisms.
        tri_delta: dict = {}
        ks, poss = self.cuts_of(v)
        if len(ks):
            was = self.cmatch[ks, poss]
            now = self.cp[ks, poss] == p_new
            chg = was != now
            if chg.any():
                ks_c, delta_m = ks[chg], now[chg].astype(np.int64) * 2 - 1
                new_nmatch = self.cut_nmatch[ks_c] + delta_m
                act_delta = (new_nmatch == 3).astype(np.int64) - (
                    self.cut_nmatch[ks_c] == 3
                ).astype(np.int64)
                for t, ad in zip(self.ct[ks_c], act_delta):
                    tri_delta[t] = tri_delta.get(t, 0) + ad
        flip_after = {}
        if self.flip_pen > 0.0:
            ts = self.tris_of(v)
            if len(ts):
                fa = self.local_flips(ts, override_v=v, override_j=j_new)
                for t, f_new in zip(ts, fa):
                    if bool(f_new) != bool(self.flipped[t]):
                        flip_after[int(t)] = bool(f_new)
        ds_free = 0.0
        for t in set(tri_delta) | set(flip_after):
            ad = tri_delta.get(t, 0)
            f_before = bool(self.flipped[t]) if self.flip_pen > 0.0 else False
            f_after = flip_after.get(t, f_before)
            act_before = self.tri_act[t] > 0
            act_after = (self.tri_act[t] + ad) > 0
            if act_after and not act_before:
                d += self.dpw[t]
            elif act_before and not act_after:
                d -= self.dpw[t]
            ds_free += self.dpw[t] * (
                int(f_after and not act_after) - int(f_before and not act_before)
            )
        if ds_free:
            d += max(0.0, self.S_free + ds_free - self.W_A) - max(
                0.0, self.S_free - self.W_A
            )
        return d

    def apply(self, v, p_new, j_new):
        """Execute the move (returns its delta, already added to .obj)."""
        d = self.delta(v, p_new, j_new)
        self.changed.add(int(v))
        p_old = self.match_pair[v]
        j_old = self.match_ref[v]
        if j_old >= 0:
            self.u[j_old] -= 1
        if j_new >= 0:
            self.u[j_new] += 1
        self.match_pair[v] = p_new
        self.match_ref[v] = j_new
        ks, poss = self.cuts_of(v)
        affected = set()
        if len(ks):
            affected.update(int(t) for t in self.ct[ks])
        ts = self.tris_of(v)
        if self.flip_pen > 0.0 and len(ts):
            affected.update(int(t) for t in ts)
        aff = np.fromiter(affected, np.int64, len(affected))
        if len(aff):
            free_before = float(
                self.dpw[aff][
                    self.flipped[aff] & ~(self.tri_act[aff] > 0)
                ].sum()
            )
        if len(ks):
            now = self.cp[ks, poss] == p_new
            chg = self.cmatch[ks, poss] != now
            if chg.any():
                ks_c, poss_c = ks[chg], poss[chg]
                delta_m = now[chg].astype(np.int64) * 2 - 1
                was_full = self.cut_nmatch[ks_c] == 3
                self.cmatch[ks_c, poss_c] = now[chg]
                self.cut_nmatch[ks_c] += delta_m
                is_full = self.cut_nmatch[ks_c] == 3
                for t, wf, f in zip(self.ct[ks_c], was_full, is_full):
                    self.tri_act[t] += int(f) - int(wf)
        if self.flip_pen > 0.0 and len(ts):
            self.flipped[ts] = self.local_flips(ts)
        if len(aff):
            free_after = float(
                self.dpw[aff][
                    self.flipped[aff] & ~(self.tri_act[aff] > 0)
                ].sum()
            )
            self.S_free += free_after - free_before
        self.obj += d
        return d

    def capacity_ok(self, v, j_new):
        if j_new < 0:
            return True
        if j_new == self.match_ref[v]:
            return True
        return self.u[j_new] < self.limits[j_new]


def resolve_repair_workers(workers):
    """None -> auto: one MILP thread per core, capped at 8 (1 on 1-core)."""
    if workers is not None:
        return max(1, int(workers))
    import os

    return max(1, min(8, os.cpu_count() or 1))


def _vertex_regret(st, problem, pair_costs):
    """Per-vertex cost regret: current assignment cost minus the cheapest
    candidate's cost. High-regret vertices mark places the solver settled
    for a worse match — usually to avoid a flip the remaining budget
    allowance would now make free (Gurobi spends the callback's allowed
    flip fraction exactly here; reference src/same.py:641-669)."""
    n = st.n
    cand_cost = np.where(
        problem.valid[:n],
        pair_costs[np.where(problem.valid[:n], problem.pair_idx[:n], 0)],
        np.inf,
    )
    best = np.minimum(cand_cost.min(axis=1), st.nm)
    mp = st.match_pair[:n]
    cur = np.where(mp >= 0, pair_costs[np.maximum(mp, 0)], st.nm)
    return np.maximum(cur - best, 0.0)


def _tri_cuts_index(st):
    """Triangle id -> registered cut row ids (built once per repair)."""
    idx = getattr(st, "_tri_cuts", None)
    if idx is None:
        idx = {}
        for k, t in enumerate(st.ct):
            idx.setdefault(int(t), []).append(k)
        st._tri_cuts = idx
    return idx


def local_repair(
    problem, pair_costs, tris, tri_weights, source_signs, ref_coords,
    match_ref, match_pair, cut_arrays, delaunay_penalty, penalty_coeff,
    hard, max_sweeps: int = 5, deadline=None, flip_penalty: float = 0.0,
    flip_allowance: float = 0.0, stats: dict | None = None,
    workers: int | None = None,
):
    """Greedy exact-objective descent; returns (match_ref, match_pair, timed_out).

    Move set per vertex: each candidate pair (respecting hard ref
    capacities) and no-match; plus a compound move re-matching an unmatched
    vertex while unmatching the neighbor whose absence disables the
    would-be flipped triangles. In ``hard`` mode a move creating a flip on
    an incident triangle is rejected. ``flip_allowance`` (in dp*w units)
    exempts a budget's worth of uncut flips from the flips-pay term (see
    _RepairState).

    ``stats`` receives the repair's spans (``sweep_time``, the greedy
    sweeps; ``components_time``, the component passes; ``intensify_time``,
    the last long solves) and counters: ``sweeps`` begun,
    ``sweeps_cut_short`` (0 or 1), ``sweep_candidates`` listed and
    ``sweep_vertices`` evaluated (both summed over the sweeps),
    ``sweep_moves`` and ``compound_moves`` applied, ``component_passes``,
    the objective ``objective_in``, ``objective_after_sweeps`` and
    ``objective_out``, and ``ended_by``: ``deadline``, ``converged`` (a
    sweep found no move), ``stall`` (component passes stopped gaining) or
    ``max_passes``.
    """
    workers = resolve_repair_workers(workers)
    stats = {} if stats is None else stats
    stats["repair_workers"] = workers
    with span(stats, "sweep_time"):
        st = _RepairState(
            problem, pair_costs, tris, tri_weights, source_signs, ref_coords,
            match_ref, match_pair, cut_arrays, delaunay_penalty, penalty_coeff,
            flip_penalty=flip_penalty, flip_allowance=flip_allowance,
        )
        n = st.n
        timed_out = False
        stats["flips_in"] = int(st.local_flips(np.arange(st.T)).sum())
        stats["objective_in"] = float(st.obj)

        # The greedy sweeps get at most ~40% of the repair budget: the exact
        # component MILPs below find the coordinated escapes greedy cannot, so
        # starving them for more 1-move sweeps is a bad trade.
        sweep_deadline = deadline
        if deadline is not None:
            now = _time.time()
            sweep_deadline = now + 0.4 * max(deadline - now, 0.0)

        sweeps_cut_short = False
        ended_by = "max_passes"
        sweeps = sweep_candidates = sweep_vertices = sweep_moves = compound_moves = 0
        for _ in range(max_sweeps):
            if sweep_deadline is not None and _time.time() > sweep_deadline:
                sweeps_cut_short = True
                break
            sweeps += 1
            all_t = np.arange(st.T)
            flipped_t = all_t[st.local_flips(all_t)]
            cand = set(st.tris[flipped_t].ravel().tolist())
            if len(st.ct):
                cand.update(np.unique(st.cv).tolist())
            if not hard and st.flip_pen > 0.0 and st.W_A - st.S_free > 1e-9:
                # Leftover flip-budget allowance: also visit the highest-regret
                # vertices — moves that flip a triangle within the allowance
                # are free under delta(), so greedy can spend the budget on
                # cost-reducing flips the incumbent search suppressed.
                reg = _vertex_regret(st, problem, pair_costs)
                k = 2048 if n <= 6144 else 512
                top = np.argsort(-reg)[:k]
                cand.update(int(v) for v in top[reg[top] > 1e-9])
            cand = sorted(c for c in cand if 0 <= c < n)
            sweep_candidates += len(cand)
            if not cand:
                ended_by = "converged"
                break
            improved = False

            for vi, v in enumerate(cand):
                if (
                    sweep_deadline is not None
                    and (vi & 63) == 0
                    and _time.time() > sweep_deadline
                ):
                    sweeps_cut_short = True
                    break
                sweep_vertices += 1
                cur_pair = int(st.match_pair[v])
                cur_ref = int(st.match_ref[v])
                best_d, best_move = -1e-9, None
                inc = st.tris_of(v)
                options = [(-1, -1)]
                for c in np.flatnonzero(problem.valid[v]):
                    p = int(problem.pair_idx[v, c])
                    j = int(problem.cand_ref[v, c])
                    if p != cur_pair and st.capacity_ok(v, j):
                        options.append((p, j))
                for p, j in options:
                    if p == cur_pair:
                        continue
                    d = st.delta(v, p, j)
                    if d >= best_d:
                        continue
                    if hard and p >= 0:
                        # Reject moves creating a flip on incident triangles.
                        st.apply(v, p, j)
                        bad = st.local_flips(inc).any()
                        st.apply(v, cur_pair, cur_ref)
                        if bad:
                            continue
                    best_d, best_move = d, (p, j)
                if best_move is not None:
                    st.apply(v, *best_move)
                    improved = True
                    sweep_moves += 1

            if sweeps_cut_short:
                break
            # Compound move: re-match an unmatched vertex and simultaneously
            # unmatch one neighbor whose absence disables the would-be flipped
            # triangles — the MIP's favourite escape (an orientation check only
            # applies to fully matched triangles).
            for vi, v in enumerate(cand):
                if st.match_ref[v] >= 0:
                    continue
                if (
                    sweep_deadline is not None
                    and (vi & 63) == 0
                    and _time.time() > sweep_deadline
                ):
                    sweeps_cut_short = True
                    break
                sweep_vertices += 1
                inc = st.tris_of(v)
                best_d, best_compound = -1e-9, None
                for c in np.flatnonzero(problem.valid[v]):
                    p = int(problem.pair_idx[v, c])
                    j = int(problem.cand_ref[v, c])
                    if not st.capacity_ok(v, j):
                        continue
                    d1 = st.apply(v, p, j)
                    new_flips = inc[st.local_flips(inc)]
                    neighbors = {
                        int(w)
                        for t in new_flips
                        for w in st.tris[t]
                        if w != v and st.match_ref[w] >= 0
                    }
                    for w in neighbors:
                        wp, wj = int(st.match_pair[w]), int(st.match_ref[w])
                        d2 = st.delta(w, -1, -1)
                        total = d1 + d2
                        if total >= best_d:
                            continue
                        if hard:
                            st.apply(w, -1, -1)
                            bad = (
                                st.local_flips(inc).any()
                                or st.local_flips(st.tris_of(w)).any()
                            )
                            st.apply(w, wp, wj)
                            if bad:
                                continue
                        best_d, best_compound = total, (p, j, w)
                    st.apply(v, -1, -1)
                if best_compound is not None:
                    p, j, w = best_compound
                    st.apply(v, p, j)
                    st.apply(w, -1, -1)
                    improved = True
                    compound_moves += 1

            if not improved or sweeps_cut_short:
                ended_by = "converged"
                break
        if sweeps_cut_short:
            ended_by = "deadline"

        # Exact finishing pass for the zero-flip-budget / hard regimes: greedy
        # 1/2-moves cannot find branch-and-bound's coordinated multi-vertex
        # escapes, but the hard region is small and local by construction —
        # solve each connected component of paying triangles exactly with the
        # MILP oracle, boundary vertices frozen. A component fix can unlock
        # further improvements in its neighbors, so iterate to a fixed point
        # (bounded).
        stats["flips_after_greedy"] = int(
            st.local_flips(np.arange(st.T)).sum()
        )
    stats.update(
        sweeps=sweeps, sweeps_cut_short=int(sweeps_cut_short),
        sweep_candidates=sweep_candidates, sweep_vertices=sweep_vertices,
        sweep_moves=sweep_moves,
        compound_moves=compound_moves, objective_after_sweeps=float(st.obj),
    )
    component_passes = 0
    if (st.flip_pen > 0.0 or hard) and st.T and not timed_out:
        with span(stats, "components_time"):
            dirty = None  # first pass: all components
            stall = 0
            hops = 0
            # Small/medium windows escalate to 1-hop-expanded, larger
            # components when the base pass stalls: the extra MILP cost is
            # bounded by the deadline and the quality is decided here (paper
            # synthetic flip counts; heart violation parity).
            small = n <= 6144
            # Small windows keep rotating chunk seeds until the budget runs
            # out or the stall tolerance trips: every pass only improves, the
            # quality-deciding component MILPs are root-bound wall-clock-
            # limited HiGHS runs whose cut-off point jitters with load, and a
            # later rotation regularly unlocks an escape an earlier identical
            # state missed (measured band on the paper synthetic: 54-63
            # violation nodes at 8 passes, consistently <=55 with extended
            # rotations).
            max_passes = 24 if n <= 1024 else 8
            stall_limit = 4 if n <= 1024 else 2
            ended_by = "max_passes"
            for pass_idx in range(max_passes):
                component_passes += 1
                obj_before = st.obj
                st.changed = set()
                timed_out = _exact_component_repair(
                    st, problem, pair_costs, hard, deadline, stats=stats,
                    dirty=dirty, chunk_seed=pass_idx, expand_hops=hops,
                    max_comp_verts=(64 if hops else 40),
                    workers=workers,
                )
                dirty = set(st.changed)
                if timed_out:
                    ended_by = "deadline"
                    break
                if st.obj >= obj_before - 1e-9:
                    # No gain with this chunking of the oversized blobs; retry
                    # with rotated BFS chunk boundaries (different frozen cuts
                    # expose different coordinated escapes), on small windows
                    # also with 1-hop-expanded free sets, then stop.
                    stall += 1
                    dirty = None
                    if small and hops == 0:
                        hops = 1
                    elif stall >= stall_limit:
                        ended_by = "stall"
                        break
                else:
                    stall = 0
        # Final intensification: the rotation passes above run 10 s
        # root-bound chunk MILPs; whatever budget remains buys a few LARGE
        # long-cap solves over the worst regions — bigger free sets (and a
        # hop of context) see coordinated escapes that chunk boundaries
        # hide, and root-bound HiGHS keeps improving with wall-clock. Only
        # improving solutions are applied (rollback in
        # _exact_component_repair), so this pass is monotone like the rest.
        if (
            small
            and not timed_out
            and deadline is not None
            and deadline - _time.time() > 15.0
        ):
            with span(stats, "intensify_time"):
                t_int0 = _time.time()
                timed_out = _exact_component_repair(
                    st, problem, pair_costs, hard, deadline, stats=stats,
                    chunk_seed=101, expand_hops=1, max_comp_verts=96,
                    milp_time_limit=min(60.0, (deadline - t_int0) / 3.0),
                    max_comps=12, workers=workers,
                )
            if timed_out:
                ended_by = "deadline"
    stats.update(
        component_passes=component_passes, objective_out=float(st.obj),
        ended_by=ended_by,
        flips_out=int(st.local_flips(np.arange(st.T)).sum()),
    )
    return st.match_ref, st.match_pair, timed_out


def _exact_component_repair(
    st, problem, pair_costs, hard, deadline,
    max_comp_verts: int = 40, max_comps: int = 200,
    milp_time_limit: float = 10.0,
    stats: dict | None = None,
    dirty: set | None = None, chunk_seed: int = 0, expand_hops: int = 0,
    workers: int = 1,
):
    """Exact MILP repair over connected components of paying triangles.

    For each component: the component's vertices keep their full candidate
    sets; vertices of adjacent triangles are frozen to their current match;
    ref capacities are reduced by usage outside the component; every
    triangle fully inside the frozen+free vertex set carries its
    orientation term. The component optimum is applied through the
    incremental state, so the global objective only improves.

    ``workers > 1`` solves groups of subproblems concurrently in threads
    (scipy's HiGHS releases the GIL — the TPU-era analog of the reference's
    32-worker precompute pool, src/helpers.py:485-495). Group members are
    vertex- AND ref-disjoint, so each member's extraction inputs are
    untouched by the others' applies: results are exactly what sequential
    processing in the same order would produce.
    """
    import time as _time

    timed_out = False
    # Seeds: triangles paying the tearing price, plus triangles whose
    # orientation check is disabled by an unmatched vertex — unmatching is
    # the greedy escape, and the exact pass must be allowed to revisit it.
    paying = st.flipped | (st.tri_act > 0)
    unmatched = np.flatnonzero(st.match_ref[: st.n] < 0)
    for v in unmatched:
        ts = st.tris_of(int(v))
        if len(ts):
            paying[ts] = True
    # ... plus triangles incident to vertices matched to refs paying
    # over-capacity penalties: un-doubling a ref needs the same coordinated
    # reassignment chains as unflipping a triangle, and the assignment
    # penalty (penalty_coeff per extra match) is part of the exact
    # objective the component MILP minimizes. Measured on the paper
    # synthetic benchmark, these seeds recover most of the double-match
    # gap to the published Gurobi solution.
    over = np.flatnonzero(st.u > 1)
    if len(over):
        for v in np.flatnonzero(np.isin(st.match_ref[: st.n], over)):
            ts = st.tris_of(int(v))
            if len(ts):
                paying[ts] = True
    # ... plus (when the window-level flip budget has slack) triangles
    # around the highest-regret vertices: the component MILPs below model
    # the allowance, so they can ADD cost-reducing flips in regions with no
    # violation at all — the freedom Gurobi's callback budget gives it.
    if not hard and st.flip_pen > 0.0 and st.W_A - st.S_free > 1e-9:
        reg = _vertex_regret(st, problem, pair_costs)
        top = np.argsort(-reg)[: (1024 if st.n <= 6144 else 256)]
        n_seeded = 0
        for v in top[reg[top] > 1e-9]:
            ts = st.tris_of(int(v))
            if len(ts):
                paying[ts] = True
                n_seeded += 1
        if stats is not None and n_seeded:
            stats["regret_seeds"] = stats.get("regret_seeds", 0) + n_seeded
    if not paying.any():
        return False

    # Connected components of paying triangles via shared vertices.
    comp_of = {}
    comps = []
    for t in np.flatnonzero(paying):
        verts = [int(v) for v in st.tris[t]]
        hit = {comp_of[v] for v in verts if v in comp_of}
        if not hit:
            cid = len(comps)
            comps.append(set(verts))
        else:
            cid = min(hit)
            for other in hit - {cid}:
                comps[cid] |= comps[other]
                for v in comps[other]:
                    comp_of[v] = cid
                comps[other] = set()
            comps[cid] |= set(verts)
        for v in verts:
            comp_of[v] = cid
    comps = [c for c in comps if c]
    # Optional hop expansion: grow each component's free set through the
    # triangle adjacency. Coordinated escapes (un-double a ref, unflip a
    # triangle via an augmenting chain) often need movers one hop outside
    # the paying region; with the boundary frozen the component MILP cannot
    # see them. Used as a stall escalation on small windows (local_repair).
    for _ in range(max(0, expand_hops)):
        for comp in comps:
            extra = set()
            for v in comp:
                for t in st.tris_of(v):
                    extra.update(int(w) for w in st.tris[t])
            comp |= extra
    # Oversized components (flip-heavy regions merge into large blobs on
    # real data) are split into BFS chunks over the triangle adjacency:
    # each chunk is solved with the rest of the component frozen as
    # boundary, which is exactly the existing frozen-boundary subproblem
    # semantics — strictly better than skipping the component outright.
    chunked = []
    for comp in comps:
        if len(comp) <= max_comp_verts:
            chunked.append(comp)
            continue
        remaining = set(comp)
        adj = {}
        for v in comp:
            neigh = set()
            for t in st.tris_of(v):
                neigh.update(int(w) for w in st.tris[t] if int(w) in remaining)
            neigh.discard(v)
            adj[v] = neigh
        while remaining:
            ordered = sorted(remaining)
            seed = ordered[(chunk_seed * 7919) % len(ordered)]
            chunk, frontier = set(), [seed]
            while frontier and len(chunk) < max_comp_verts:
                v = frontier.pop()
                if v in chunk or v not in remaining:
                    continue
                chunk.add(v)
                frontier.extend(
                    sorted(w for w in adj[v] if w in remaining and w not in chunk)
                )
            remaining -= chunk
            chunked.append(chunk)
    comps = chunked
    comps.sort(key=len, reverse=True)
    if dirty is not None:
        # Later passes only revisit components near vertices the previous
        # pass actually changed — untouched subproblems are already optimal.
        expanded = set(dirty)
        for v in dirty:
            for t in st.tris_of(int(v)):
                expanded.update(int(w) for w in st.tris[t])
        comps = [c for c in comps if c & expanded]
    if stats is not None:
        sizes = sorted((len(c) for c in comps), reverse=True)
        stats.setdefault("comp_sizes", []).append(sizes[:12])
        stats["comps_total"] = len(comps)

    memo = getattr(st, "_comp_memo", None)
    if memo is None:
        memo = st._comp_memo = set()

    comps = [c for c in comps[:max_comps] if len(c) <= max_comp_verts]
    workers = max(1, int(workers))
    idx = 0
    while idx < len(comps):
        if deadline is not None and _time.time() > deadline:
            return True
        # Form a group of vertex- and ref-disjoint subproblems (size 1 when
        # workers == 1 -- exactly the sequential behavior). A conflicting
        # component stays queued and is re-extracted after this group's
        # applies, since those may change its inputs.
        group = []
        used_verts: set = set()
        used_refs: set = set()
        while idx < len(comps) and len(group) < workers:
            sub = _extract_subproblem(st, problem, pair_costs, comps[idx], memo)
            if sub is None:
                idx += 1
                continue
            if group and (
                sub["verts_set"] & used_verts or sub["refs_set"] & used_refs
            ):
                break
            group.append(sub)
            used_verts |= sub["verts_set"]
            used_refs |= sub["refs_set"]
            idx += 1
        if not group:
            continue

        if len(group) == 1:
            solved = [
                _solve_subproblem(group[0], st, hard, milp_time_limit, deadline)
            ]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(group)) as pool:
                solved = list(
                    pool.map(
                        lambda s: _solve_subproblem(
                            s, st, hard, milp_time_limit, deadline
                        ),
                        group,
                    )
                )

        for sub, (oracle, dt_milp) in zip(group, solved):
            if stats is not None:
                stats["milp_calls"] = stats.get("milp_calls", 0) + 1
                stats["milp_time"] = stats.get("milp_time", 0.0) + dt_milp
                log = stats.setdefault("milp_call_log", [])
                log.append(
                    (len(sub["free"]), len(sub["sub_tris"]), round(dt_milp, 2))
                )
                # The log feeds solver_state.json via window info dicts;
                # uncapped it reaches thousands of entries on big windows.
                # Keep only the slowest calls (the ones worth debugging).
                if len(log) > 64:
                    log.sort(key=lambda rec: -rec[2])
                    del log[48:]
            if oracle is None:
                continue
            _apply_subproblem(st, problem, sub, oracle, hard, memo)
    return timed_out


def _extract_subproblem(st, problem, pair_costs, comp, memo):
    """Freeze a component's boundary and build its standalone MILP inputs.

    Returns None when the component's local state is memoized as already
    component-optimal. Pure read of ``st`` -- extraction for a group of
    vertex-/ref-disjoint components commutes with their applies.
    """
    free = sorted(comp)
    free_set = set(free)
    # Closure: triangles touching the free set; their other matched
    # vertices are frozen boundary.
    tri_ids = sorted({int(t) for v in free for t in st.tris_of(v)})
    boundary = set()
    sub_tris = []
    for t in tri_ids:
        verts = [int(v) for v in st.tris[t]]
        outside = [v for v in verts if v not in free_set]
        if any(st.match_ref[v] < 0 for v in outside):
            # A permanently unmatched boundary vertex disables the
            # orientation check for this triangle; skip it.
            continue
        boundary.update(outside)
        sub_tris.append(t)
    sub_verts = free + sorted(boundary)
    local_of = {v: i for i, v in enumerate(sub_verts)}

    # Skip subproblems whose local state is unchanged since they were
    # last solved to (component) optimality -- the stall passes re-enter
    # every component, and an unchanged one cannot improve.
    if _comp_sig(st, free, sub_verts) in memo:
        return None

    # Candidate pairs: full sets for free vertices, frozen singleton
    # for boundary vertices.
    s_pairs, s_costs = [], []
    for v in free:
        seen = set()
        for c in np.flatnonzero(problem.valid[v]):
            p = int(problem.pair_idx[v, c])
            if p in seen:
                continue
            seen.add(p)
            s_pairs.append((local_of[v], int(problem.cand_ref[v, c])))
            s_costs.append(float(pair_costs[p]))
    for v in sorted(boundary):
        s_pairs.append((local_of[v], int(st.match_ref[v])))
        s_costs.append(float(pair_costs[st.match_pair[v]]))
    s_pairs = np.asarray(s_pairs, np.int64)

    # Remap refs; capacities reduced by usage outside the subproblem.
    sub_refs = np.unique(s_pairs[:, 1])
    ref_map = {int(j): k for k, j in enumerate(sub_refs)}
    s_pairs[:, 1] = [ref_map[int(j)] for j in s_pairs[:, 1]]
    inside_usage = np.zeros(len(sub_refs), np.int64)
    for v in sub_verts:
        j = int(st.match_ref[v])
        if j in ref_map:
            inside_usage[ref_map[j]] += 1
    limits = np.array(
        [
            int(st.limits[j]) - (int(st.u[j]) - int(inside_usage[ref_map[j]]))
            for j in sub_refs
        ],
        np.int64,
    )
    nm_cost = np.concatenate([st.nm[free], np.full(len(boundary), 1e9)])
    tris_local = np.array(
        [[local_of[int(v)] for v in st.tris[t]] for t in sub_tris],
        np.int64,
    ).reshape(-1, 3)
    # Eager triangle enumeration beats the lazy outer loop when the
    # combo count is bounded: one exact HiGHS solve instead of up to
    # max_outer_iters of them (measured ~5 s/component lazy vs
    # sub-second eager on the paper synthetic's components).
    cand_count = np.bincount(
        s_pairs[:, 0].astype(np.int64), minlength=len(sub_verts)
    ).astype(np.float64)
    n_combos = (
        float(np.prod(cand_count[tris_local], axis=1).sum())
        if len(sub_tris)
        else 0.0
    )
    use_eager = len(sub_tris) > 0 and n_combos <= 60000
    # Seed the oracle's lazy-cut registry with the triples that flip
    # under the CURRENT incumbent: its first separation round would
    # rediscover exactly these, at the price of one extra HiGHS solve.
    local_pair_of = {
        (int(lv), int(lr)): k for k, (lv, lr) in enumerate(s_pairs)
    }
    init_cuts = []
    for si, t in enumerate(sub_tris):
        if not st.flipped[t]:
            continue
        triple = [si]
        for v in (int(w) for w in st.tris[t]):
            j = int(st.match_ref[v])
            k = (
                local_pair_of.get((local_of[v], ref_map[j]))
                if (v in local_of and j in ref_map and j >= 0)
                else None
            )
            if k is None:
                triple = None
                break
            triple.append(k)
        if triple is not None:
            init_cuts.append(tuple(triple))
    # Component flip allowance: whatever of the window's budget W_A is not
    # consumed by free flips OUTSIDE this subproblem is local headroom the
    # component MILP may spend (exact: the triangles whose flip state the
    # subproblem controls are exactly sub_tris). Registered cut triples map
    # into local pair ids so the MILP charges them regardless of budget.
    flip_allowance = 0.0
    reg_cuts = []
    if st.flip_pen > 0.0 and st.W_A > 0.0:
        st_arr = np.asarray(sub_tris, np.int64)
        inside_free = (
            float(
                st.dpw[st_arr][
                    st.flipped[st_arr] & ~(st.tri_act[st_arr] > 0)
                ].sum()
            )
            if len(sub_tris)
            else 0.0
        )
        flip_allowance = max(0.0, st.W_A - (st.S_free - inside_free))
        if flip_allowance > 0.0 and len(sub_tris) and len(st.ct):
            tri_cuts = _tri_cuts_index(st)
            for si, t in enumerate(sub_tris):
                for k in tri_cuts.get(int(t), ()):
                    triple = [si]
                    for v, p in zip(st.cv[k], st.cp[k]):
                        v, j = int(v), int(st.ref_of_pair[int(p)])
                        lk = (
                            local_pair_of.get((local_of[v], ref_map[j]))
                            if (v in local_of and j in ref_map)
                            else None
                        )
                        if lk is None:
                            triple = None
                            break
                        triple.append(lk)
                    if triple is not None:
                        reg_cuts.append(tuple(triple))
    return {
        "flip_allowance": flip_allowance,
        "reg_cuts": reg_cuts,
        "free": free,
        "sub_verts": sub_verts,
        "local_of": local_of,
        "sub_refs": sub_refs,
        "s_pairs": s_pairs,
        "s_costs": np.asarray(s_costs),
        "limits": limits,
        "nm_cost": nm_cost,
        "sub_tris": sub_tris,
        "tris_local": tris_local,
        "use_eager": use_eager,
        "init_cuts": init_cuts,
        "verts_set": set(sub_verts),
        "refs_set": {int(j) for j in sub_refs},
    }


def _comp_sig(st, free, sub_verts):
    """Local-state signature for the component-optimality memo.

    Includes the window's remaining flip-budget slack: a component proven
    optimal under one allowance is NOT optimal once other components free
    or consume budget, so such entries must not match.
    """
    return hash((
        tuple(free),
        tuple(int(st.match_pair[v]) for v in sub_verts),
        tuple((j, int(st.u[j])) for j in sorted(
            {int(st.match_ref[v]) for v in sub_verts
             if st.match_ref[v] >= 0})),
        round(max(0.0, st.W_A - st.S_free), 6),
    ))


def _solve_subproblem(sub, st, hard, milp_time_limit, deadline):
    """One component MILP call; returns (OracleResult | None, wall seconds).

    Reads only the extracted descriptor plus immutable ``st`` arrays
    (weights, signs, coordinates), so concurrent calls are safe.
    """
    import time as _time

    from .milp_oracle import solve_mip_oracle

    comp_budget = milp_time_limit
    if deadline is not None:
        comp_budget = min(comp_budget, max(deadline - _time.time(), 0.5))
    sub_tris = sub["sub_tris"]
    t0 = _time.time()
    try:
        oracle = solve_mip_oracle(
            sub["s_pairs"], sub["s_costs"], len(sub["sub_verts"]),
            len(sub["sub_refs"]),
            np.maximum(sub["limits"], 0), st.pc, sub["nm_cost"],
            triangles=sub["tris_local"] if len(sub_tris) else None,
            tri_weights=np.array([st.w[t] for t in sub_tris])
            if len(sub_tris)
            else None,
            source_signs=np.array([st.src[t] for t in sub_tris], np.int32)
            if len(sub_tris)
            else None,
            # The oracle's separation indexes ref_coords by the
            # (remapped) ref row of s_pairs.
            ref_coords=st.ref_xy[sub["sub_refs"]],
            delaunay_penalty=(
                1e7 if hard else (st.flip_pen if st.flip_pen > 0 else 0.0)
            ),
            lazy_allowed_flip_fraction=0.0,
            flip_allowance=(0.0 if hard else sub["flip_allowance"]),
            registered_cuts=sub["reg_cuts"] or None,
            max_outer_iters=6,
            # Loose relative gap: proving the last ~0.1% of a component
            # bound costs HiGHS multiples of finding the solution
            # (measured 6.4 s/call at 1e-5 vs sub-second at 2e-3), and
            # the rollback in _apply_subproblem already discards
            # non-improvements.
            mip_gap=2e-3,
            time_limit=comp_budget,
            init_cuts=None if sub["use_eager"] else sub["init_cuts"],
            eager_triangles=sub["use_eager"],
        )
    except Exception:
        return None, _time.time() - t0
    return oracle, _time.time() - t0


def _apply_subproblem(st, problem, sub, oracle, hard, memo):
    """Apply a component optimum with the exact-objective rollback guard.

    The oracle's separation loop can terminate before converging
    (max_outer_iters / time_limit), in which case its solution may carry
    unpenalized flips and score WORSE under exact flips-pay semantics --
    snapshot and roll back unless the exact objective improved (and, in
    hard mode, no incident triangle is left flipped).
    """
    free = sub["free"]
    local_of = sub["local_of"]
    sub_refs = sub["sub_refs"]
    if oracle.status == 0:
        # Solved to (component) optimality for this local state: stall
        # passes can skip it until a neighbor changes the state.
        memo.add(_comp_sig(st, free, sub["sub_verts"]))
    obj_before = st.obj
    snapshot = [
        (v, int(st.match_pair[v]), int(st.match_ref[v])) for v in free
    ]
    for v in free:
        new_ref_local = int(oracle.match_ref[local_of[v]])
        if new_ref_local < 0:
            p_new, j_new = -1, -1
        else:
            j_new = int(sub_refs[new_ref_local])
            # Find the original pair id for (v, j_new).
            p_new = -1
            for c in np.flatnonzero(problem.valid[v]):
                if int(problem.cand_ref[v, c]) == j_new:
                    p_new = int(problem.pair_idx[v, c])
                    break
            if p_new < 0:
                continue
        if p_new != int(st.match_pair[v]):
            st.apply(v, p_new, j_new)
    worse = st.obj >= obj_before - 1e-9
    if not worse and hard:
        inc = np.unique(
            np.concatenate([st.tris_of(v) for v in free])
            if free
            else np.zeros(0, np.int64)
        )
        worse = bool(st.local_flips(inc).any())
    applied_change = any(
        int(st.match_pair[v]) != p for v, p, _ in snapshot
    )
    if worse and applied_change:
        for v, p_old, j_old in snapshot:
            if int(st.match_pair[v]) != p_old:
                st.apply(v, p_old, j_old)
    # NOTE: timed-out no-improvement states are deliberately NOT
    # memoized: the hard components are root-bound in HiGHS (cut/
    # heuristic loops at node 0), where a wall-clock limit cuts at a
    # load-dependent point -- a later re-solve of the same state can
    # genuinely improve (measured on the paper synthetic: memoizing
    # them cost +3.5% objective for a ~5% wall saving).
    if not worse and oracle.status == 0:
        # The applied state IS the component optimum -- memoize it too
        # so the next pass skips straight past it.
        memo.add(_comp_sig(st, free, sub["sub_verts"]))
