"""The plain reference against the port, and its optimum against a dense
assignment solver, on small seeded windows on the CPU."""

import numpy as np
import scipy.optimize

from port_bench import spec
from port_bench.gen import tissue
from port_bench.reference import window as rw

SMALL = dict(n_cells=2000, extent=3700, centers_per_type=6, query_keep=0.94, jitter=15)


def test_reference_agrees_with_the_port_on_a_window():
    from same_tpu_torch import run_same

    config = spec.load_json("configs", "luad_ms3_dp25.json")
    ref_df, aligned_df = tissue.make([2**32 + 9, 0], SMALL, config)
    solver = dict(config["solver_params"], tpu_repair_budget=1)
    matches, var_out = run_same(
        ref_df, aligned_df, tissue.LUAD_TYPES, optim_params=config["optim_params"],
        solver_params=solver, verbose=False, device="cpu",
    )
    w = rw.build_window(ref_df, aligned_df, tissue.LUAD_TYPES, config["optim_params"],
                        solver["lazy_allowed_flip_fraction"])
    j = rw.judge(w, matches["Aligned_metacell_id"], matches["Ref_metacell_id"])
    assert j.infeasible == 0
    assert j.flips == len(var_out["triangle_data"]["flipped_triangles"])
    np.testing.assert_allclose(j.assignment, var_out["tpu"]["assignment_objective"],
                               rtol=1e-12)
    port = {tuple(sorted(t)) for t in
            w.aligned_ids[np.asarray(var_out["triangle_data"]["triangles"])].tolist()}
    assert port == {tuple(sorted(t)) for t in w.aligned_ids[w.tris].tolist()}
    opt, _ = rw.optimum(w)
    assert opt <= j.assignment + 1e-9


def test_optimum_equals_a_dense_assignment():
    rng = np.random.default_rng(4)
    n, m = 40, 30
    pairs = np.array([(i, j) for i in range(n) for j in rng.choice(m, 5, replace=False)])
    w = rw.Window(
        aligned_ids=np.arange(n), ref_ids=np.arange(m), pairs=pairs,
        pair_cost=rng.uniform(0, 10, len(pairs)), capacity=rng.integers(1, 4, m),
        no_match=np.full(n, 30.0), tris=np.zeros((0, 3), np.int64),
        tri_weight=np.zeros(0), source_sign=np.zeros(0, np.int64),
        ref_xy=np.zeros((m, 2)), penalty_coeff=4.0, delaunay_penalty=0.0,
        flip_allowance=0.0,
    )
    opt, match = rw.optimum(w)
    big = 1e9
    cols = [(j, s) for j in range(m) for s in range(w.capacity[j])]
    dense = np.full((n, len(cols) + n), big)
    for p, (i, j) in enumerate(pairs):
        for c, (jj, s) in enumerate(cols):
            if jj == j:
                dense[i, c] = w.pair_cost[p] + (4.0 if s else 0.0)
    dense[np.arange(n), len(cols) + np.arange(n)] = 30.0
    r, c = scipy.optimize.linear_sum_assignment(dense)
    np.testing.assert_allclose(opt, dense[r, c].sum(), rtol=1e-12)
    j = rw.judge(w, np.flatnonzero(match >= 0), match[match >= 0])
    assert j.infeasible == 0
    np.testing.assert_allclose(j.assignment, opt, rtol=1e-12)
