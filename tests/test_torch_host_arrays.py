"""The window's whole-array host passes (``same_tpu_torch/host_arrays.py``)
against the loops they replace.

Each pass must return what its loop returns, bit for bit, in the same order
and with the same types: the greedy matching and the warm-start prices
against ``warmstart.py``, the triangle index against the vertex loop and
``eval.precompute_triangle_info``, the violation check against
``eval.verify_spatial_preservation`` and the triangle areas against
``finalize_window``'s per-triangle loop over ``geometry.calculate_signed_area``.

``luad`` is one LUAD-scale window of the benchmark's generator (10,703
aligned metacells, 85,303 pairs, 7,108 triangles), matched by the greedy
scan; ``small`` is a set of hand-made windows: cost ties, rows that prefer
no match, a NaN cost, refs of capacity above 1, no triangles, no matches,
unmatched vertices inside triangles, a ref matched by two rows, and vertex
ids whose sets come out in the order they were filled.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

from same_tpu_torch import core, eval as port_eval, host_arrays, warmstart
from same_tpu_torch.models.assignment import build_assignment_problem
from torch_parity import areas_loop, assert_bit_equal, assert_same, vertices_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Window:
    """A window's inputs as the passes take them."""

    def __init__(self, pairs, costs, sizes, nmp, xy_a, xy_r, tris, matches,
                 ref_limits=None, max_matches=1):
        self.pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        self.costs = np.asarray(costs, dtype=np.float64)
        self.sizes = np.asarray(sizes, dtype=np.float64)
        self.nmp = nmp
        self.n, self.m = len(xy_a), len(xy_r)
        self.aligned_df = pd.DataFrame({"X": xy_a[:, 0], "Y": xy_a[:, 1]})
        self.ref_df = pd.DataFrame({"X": xy_r[:, 0], "Y": xy_r[:, 1]})
        self.xy_a, self.xy_r = xy_a, xy_r
        self.tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
        self.matches = pd.DataFrame(
            {"aligned_idx": np.asarray(matches[0], dtype=np.int64),
             "ref_idx": np.asarray(matches[1], dtype=np.int64)})
        self.ref_limits = (np.ones(self.m, dtype=np.int64) if ref_limits is None
                           else np.asarray(ref_limits, dtype=np.int64))
        self.max_matches = max_matches

    def copy_greedy(self):
        return warmstart.compute_warm_start_pairs(
            valid_pairs=[(int(i), int(j)) for i, j in self.pairs], costs=self.costs,
            n_aligned=self.n, n_ref=self.m, aligned_sizes=self.sizes,
            no_match_penalty=self.nmp, max_matches=self.max_matches,
            init_method="greedy", verbose=False,
        )

    def problem(self):
        return build_assignment_problem(
            self.pairs, np.nan_to_num(self.costs, nan=7.5), self.n, self.m,
            self.ref_limits, 100.0, float(self.nmp) * self.sizes,
        )


def _small_windows():
    rng = np.random.default_rng(20261018)
    out = {}

    def pairs_for(n, m, per_row):
        return np.array([(i, int(j)) for i in range(n)
                         for j in np.sort(rng.choice(m, per_row, replace=False))])

    def grid_points(k):
        # Integer coordinates: equal X or Y across vertices, zero areas.
        return rng.integers(0, 6, (k, 2)).astype(np.float64)

    def random_tris(n, T):
        return np.array([rng.choice(n, 3, replace=False) for _ in range(T)])

    # Cost ties across rows and refs; more rows than refs.
    n, m = 30, 20
    pairs = pairs_for(n, m, 5)
    costs = rng.integers(0, 4, len(pairs)).astype(np.float64)
    w = Window(pairs, costs, np.ones(n), 10, grid_points(n), grid_points(m),
               random_tris(n, 40), ([], []))
    chosen, _ = w.copy_greedy()
    w.matches = pd.DataFrame({"aligned_idx": [c[0] for c in chosen],
                              "ref_idx": [c[1] for c in chosen]})
    out["ties"] = w

    # Rows whose best pair costs more than no match (sizes 1-3, penalty
    # 2; row 0's best, to a ref of its own, equals it), a NaN cost in a row
    # the scan matches first, refs of capacity 2 and 3, max_matches 3; half
    # the rows matched, two rows on each matched ref.
    n, m = 24, 19
    pairs = pairs_for(n, m - 1, 4)
    pairs[0, 1] = m - 1
    costs = rng.uniform(0, 6, len(pairs)).round(1)
    costs[:6] = [2.0, 2.5, 3.0, 4.0, 0.0, np.nan]
    sizes = rng.integers(1, 4, n)
    sizes[0] = 1
    rows = np.arange(0, n, 2)
    out["no_match_preferred"] = Window(
        pairs, costs, sizes, 2, grid_points(n), grid_points(m),
        random_tris(n, 30), (rows, rows // 4), ref_limits=rng.integers(1, 4, m),
        max_matches=3,
    )

    # Nothing prefers a match; no matches at all.
    n, m = 12, 10
    pairs = pairs_for(n, m, 3)
    out["no_matches"] = Window(
        pairs, rng.uniform(1, 2, len(pairs)), np.ones(n), 0, grid_points(n),
        grid_points(m), random_tris(n, 15), ([], []),
    )

    # No triangles; every row matched to ref i // 2.
    n, m = 10, 8
    pairs = pairs_for(n, m, 4)
    out["no_triangles"] = Window(
        pairs, rng.uniform(0, 1, len(pairs)), np.ones(n), 5, grid_points(n),
        grid_points(m), np.zeros((0, 3)), (np.arange(n), np.arange(n) // 2),
    )

    # Unmatched vertices inside triangles, a ref matched by two rows, and
    # random coordinates.
    n, m = 16, 12
    pairs = pairs_for(n, m, 3)
    rows = np.array([0, 1, 2, 3, 5, 6, 8, 9, 10, 12, 13, 15])
    refs = np.array([0, 0, 1, 2, 3, 3, 4, 5, 6, 7, 7, 8])
    out["ref_twice"] = Window(
        pairs, rng.uniform(0, 1, len(pairs)), np.ones(n), 5,
        rng.uniform(0, 10, (n, 2)), rng.uniform(0, 10, (m, 2)),
        random_tris(n, 25), (rows, refs),
    )

    # Vertex ids equal modulo 8, so that the order of a small set's list
    # follows the order it was filled in: every order of 33, 9 and 17 is
    # reversed by the matching.
    n, m = 40, 12
    xy_a, xy_r = rng.uniform(0, 10, (n, 2)), rng.uniform(0, 10, (m, 2))
    xy_a[[33, 9, 17]] = [[0, 0], [1, 1], [2, 2]]
    xy_r[:3] = [[5, 5], [4, 4], [3, 3]]
    out["colliding_ids"] = Window(
        pairs_for(n, m, 3), rng.uniform(0, 1, 3 * n), np.ones(n), 5, xy_a, xy_r,
        [[33, 9, 17], [25, 1, 9]], ([9, 17, 33], [1, 2, 0]),
    )
    return out


def _luad_window():
    from port_bench.gen import tissue

    with open(os.path.join(REPO, "port_bench/configs/luad_ms3_dp25.json")) as f:
        config = json.load(f)
    with open(os.path.join(REPO, "port_bench/traffic/window.json")) as f:
        traffic = json.load(f)
    ref_df, aligned_df = tissue.make([3, 0], traffic, config)
    pw = core.prepare_window(
        ref_df, aligned_df, tissue.LUAD_TYPES, optim_params=config["optim_params"],
        solver_params=config["solver_params"], verbose=False, device="cpu",
    )
    nmp = config["optim_params"]["no_match_penalty"]
    w = Window(pw.valid_pairs, pw.pair_costs, pw.aligned_df["size"].to_numpy(float),
               nmp, pw.aligned_coords, pw.ref_coords, pw.tris, ([], []))
    w.aligned_df, w.ref_df = pw.aligned_df, pw.ref_df
    w.pw = pw
    chosen, _ = w.copy_greedy()
    w.matches = pd.DataFrame({"aligned_idx": [c[0] for c in chosen],
                              "ref_idx": [c[1] for c in chosen]}).sort_values("aligned_idx")
    assert (w.n, len(w.pairs), len(w.tris)) == (10703, 85303, 7108)
    return [w]


@pytest.fixture(scope="module")
def windows():
    return {"luad": _luad_window(), "small": list(_small_windows().values())}


KINDS = ["luad", "small"]


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_pairs_equal_the_scan(windows, kind):
    for w in windows[kind]:
        chosen, unmatched = w.copy_greedy()
        got, rounds = host_arrays.greedy_pairs(
            w.pairs, w.costs, w.n, w.m, float(w.nmp) * w.sizes)
        assert_same([tuple(c) for c in got.tolist()], chosen)
        mine = set(range(w.n)) - set(got[:, 0].tolist())
        assert_same(list(mine), list(unmatched))
        assert (rounds >= 1) == bool(chosen)
        if kind == "luad":
            assert len(chosen) == 10122 and w.pw.warm_info["greedy_rounds"] == rounds


@pytest.mark.parametrize("kind", KINDS)
def test_warm_start_prices_equal_the_loop(windows, kind):
    for w in windows[kind]:
        problem = w.pw.problem if kind == "luad" else w.problem()
        chosen, _ = w.copy_greedy()
        lists = [chosen, chosen + [(0, 0, 10 ** 6)]]
        if kind == "small" and w.max_matches == 1:
            lists.append(warmstart.compute_warm_start_pairs(
                valid_pairs=[(int(i), int(j)) for i, j in w.pairs],
                costs=np.nan_to_num(w.costs, nan=7.5), n_aligned=w.n, n_ref=w.m,
                aligned_sizes=w.sizes, no_match_penalty=w.nmp, max_matches=1,
                init_method="hungarian", verbose=False)[0])
        for pairs in lists:
            want = warmstart.warm_start_prices(problem, pairs)
            assert_bit_equal(host_arrays.warm_start_prices(problem, pairs), want)
        got, _ = host_arrays.greedy_pairs(w.pairs, w.costs, w.n, w.m,
                                          float(w.nmp) * w.sizes)
        assert_bit_equal(host_arrays.warm_start_prices(problem, got),
                         warmstart.warm_start_prices(problem, chosen))
        if kind == "luad":
            assert_bit_equal(w.pw.prices0, warmstart.warm_start_prices(problem, chosen))


@pytest.mark.parametrize("kind", KINDS)
def test_triangle_index_equals_the_loop(windows, kind):
    for w in windows[kind]:
        want = {i: set() for i in range(w.n)}
        for t, tri in enumerate(w.tris):
            for v in tri:
                want[int(v)].add(t)
        got = host_arrays.simplex_map(w.tris, w.n)
        assert_same({k: list(v) for k, v in got.items()},
                    {k: list(v) for k, v in want.items()})
        info = host_arrays.triangle_info(w.aligned_df, w.tris)
        assert_same(info, port_eval.precompute_triangle_info(w.aligned_df, w.tris))
        assert all(np.shares_memory(v["vertices"], w.tris) for v in info.values())


@pytest.mark.parametrize("kind", KINDS)
def test_violations_equal_verify_spatial_preservation(windows, kind):
    for w in windows[kind]:
        info = port_eval.precompute_triangle_info(w.aligned_df, w.tris)
        want = port_eval.verify_spatial_preservation(
            w.aligned_df, w.ref_df, w.matches, info)
        ref_of = host_arrays.ref_of_aligned(w.matches, w.n)
        got = host_arrays.spatial_violations(w.aligned_df, w.ref_df, w.tris, ref_of)
        assert_same(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_triangle_areas_equal_the_loop(windows, kind):
    rng = np.random.default_rng(5)
    for w in windows[kind]:
        want = areas_loop(w.tris, w.xy_a, w.xy_r, w.matches)
        ref_of = host_arrays.ref_of_aligned(w.matches, w.n)
        got = host_arrays.triangle_areas(w.tris, w.xy_a, w.xy_r, ref_of)
        assert_same(got, want)
        if kind == "luad":
            assert len(want[2]) > 0
        q = np.flatnonzero(rng.random(len(w.tris)) < 0.3)
        for which in (q, want[2]):
            mine = host_arrays.vertices_of(w.tris, which)
            assert_same(list(mine), list(vertices_loop(w.tris, which)))
