"""Port parity: ``same_tpu_torch.parallel`` and the batched tear loop against
the JAX package on the CPU.

The port's mesh is a list of torch devices: ``[cpu]`` stands for JAX's
``make_mesh(1)`` and ``[cpu] * 8`` for ``make_mesh(8)`` (the virtual 8-device
CPU mesh of conftest.py). On CPU tensors the batched kernels K5
(``auction_loop_batch``) and K6 (``tear_metrics_batch``) run their plain
versions.

The tear-loop cases use the windows of tests/test_torch_windows.py's tissue
(the lower left 10 x 10 of the seed-8899 synthetic) prepared at
``delaunay_penalty=5``, which gives flips in every round, and at
``max_matches=1``: with two matches a ref, jitted XLA on the CPU contracts
the cross product of a triangle with two vertices on one ref into an FMA
(ROADMAP C9), and the two packages' tear rounds part at the first such
round. Each JAX call of the vmapped loop compiles anew (a new closure a
call), so the cases share one bucket's run through a module fixture.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import same_tpu
import same_tpu_torch
from same_tpu.core import prepare_window as jax_prepare
from same_tpu.parallel import make_mesh as jax_mesh
from same_tpu.parallel import solve_window_batch as jax_solve_batch
from same_tpu.parallel import stack_problems as jax_stack
from same_tpu.solver.tearing_device import run_tearing_device_batch as jax_tear_batch
from same_tpu_torch import parallel
from same_tpu_torch.core import prepare_window
from same_tpu_torch.kernels import (
    auction_loop,
    auction_loop_batch,
    tear_metrics,
    tear_metrics_batch,
)
from same_tpu_torch.models.assignment import to_device
from same_tpu_torch.solver.tearing_device import (
    run_tearing_device,
    run_tearing_device_batch,
)
from same_tpu_torch.utils.params import init_optim_params, init_solver_params
from same_tpu_torch.windows import _collect_window_tasks
from test_parallel import _problem
from test_windows import _window_params
from torch_parity import assert_bit_equal

CPU = torch.device("cpu")
TYPES = ["c1", "c2", "c3"]
KEY = ["Aligned_cell_idx", "Ref_cell_idx", "window_id"]
TEAR_OPTIM = _window_params() | {"delaunay_penalty": 5, "max_matches": 1}
TEAR_ROUNDS = 5  # rounds 0-4: the first solve, three warm ones, a cold restart


@pytest.fixture(scope="module")
def tissue():
    ref_df, query_df, _q, _gt, _e = same_tpu_torch.create_full_benchmark(seed=8899)
    return tuple(
        df[(df["X"] < 9.9) & (df["Y"] < 9.9)].reset_index(drop=True)
        for df in (ref_df, query_df)
    )


def test_stack_problems_matches_jax():
    problems = [_problem(s)[0] for s in range(4)]
    for got, want in zip(parallel.stack_problems(problems), jax_stack(problems)):
        assert_bit_equal(got, want)
    with pytest.raises(ValueError, match="shape buckets"):
        parallel.stack_problems([_problem(0, n=20)[0], _problem(1, n=500)[0]])


@pytest.mark.parametrize("n_problems, n_devices", [(3, 1), (5, 8)])
def test_solve_window_batch_matches_jax(n_problems, n_devices):
    """Identical choices, prices, rounds and match lists; a batch padded to
    the mesh returns one result a problem."""
    problems = [_problem(s)[0] for s in range(n_problems)]
    got, got_info = parallel.solve_window_batch(problems, mesh=[CPU] * n_devices)
    want, want_info = jax_solve_batch(problems, mesh=jax_mesh(n_devices))
    assert len(got) == len(want) == n_problems
    for (gr, gp), (wr, wp) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gp, wp)
    for key in ("choices", "prices", "rounds"):
        assert_bit_equal(got_info[key], want_info[key], key)


def _prepared(pkg_prepare, tissue, **kw):
    """The tissue's windows, prepared by one package at TEAR_OPTIM."""
    ref_df, query_df = tissue
    optim = init_optim_params(**TEAR_OPTIM)
    x_min = min(ref_df["X"].min(), query_df["X"].min())
    x_max = max(ref_df["X"].max(), query_df["X"].max())
    y_min = min(ref_df["Y"].min(), query_df["Y"].min())
    y_max = max(ref_df["Y"].max(), query_df["Y"].max())
    step = optim["window_size"] - optim["overlap"]
    tasks = _collect_window_tasks(
        ref_df, query_df, list(range(int(x_min), int(x_max), step)),
        list(range(int(y_min), int(y_max), step)), optim["window_size"],
        optim["overlap"], optim["min_cells_per_window"], None, x_min, x_max,
        y_min, y_max, False,
    )
    return [
        pkg_prepare(t["ref_sub"], t["mov_sub"], TYPES, optim_params=optim,
                    solver_params=init_solver_params(), verbose=False, **kw)
        for t in tasks
    ]


def _batch_args(pws):
    return (
        [p.problem for p in pws], [p.tris for p in pws], [p.tri_weights for p in pws],
        [p.source_signs for p in pws], [p.ref_coords for p in pws],
    ), dict(
        delaunay_penalties=[5.0] * len(pws),
        allowed_flip_fractions=[p.solver["lazy_allowed_flip_fraction"] for p in pws],
        hards=[False] * len(pws), eps_finals=[p.eps_solver for p in pws],
        penalty_coeffs=[100.0] * len(pws), prices0_list=[p.prices0 for p in pws],
        plateau_patiences=[6] * len(pws), plateau_tols=[0.0] * len(pws),
        obj_patience=128, mip_gaps=[None] * len(pws), max_tear_rounds=TEAR_ROUNDS,
    )


@pytest.fixture(scope="module")
def tear_bucket(tissue):
    """The largest shape bucket of the tissue's windows through both
    packages' batched tear loops (JAX on its one-device mesh)."""
    jax_pws = _prepared(jax_prepare, tissue)
    pws = _prepared(prepare_window, tissue, device="cpu")
    buckets = {}
    for i, p in enumerate(pws):
        buckets.setdefault((p.problem.costs.shape, p.problem.n_slots), []).append(i)
    idx = max(buckets.values(), key=len)
    assert len(idx) >= 2
    args, kw = _batch_args([pws[i] for i in idx])
    jargs, jkw = _batch_args([jax_pws[i] for i in idx])
    return {
        "pws": [pws[i] for i in idx],
        "port": run_tearing_device_batch(*args, mesh=[CPU], **kw),
        "jax": jax_tear_batch(*jargs, mesh=jax_mesh(1), **jkw),
    }


def _assert_same_rounds(got, want):
    assert got["rounds_used"] == want["rounds_used"]
    for key in ("choices", "flipped", "checked", "auction_rounds"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    for key in ("cuts_added", "cut_tris", "time_limit_reached"):
        assert got[key] == want[key], key
    for key in ("cut_verts", "cut_pairs"):
        assert [list(v) for v in got[key]] == [list(v) for v in want[key]], key


def test_tear_loop_batch_matches_jax(tear_bucket):
    """Every window's per-round choices, flips, checks, auction rounds and
    cut registry are the JAX batch's."""
    for got, want in zip(tear_bucket["port"], tear_bucket["jax"]):
        assert got["rounds_used"] == TEAR_ROUNDS and got["cuts_added"] > 0
        _assert_same_rounds(got, want)


def test_tear_loop_batch_equals_solo_loops(tear_bucket):
    """Each window of the batch is the solo loop given the batch's round
    budget and schedule length."""
    for pw, got in zip(tear_bucket["pws"], tear_bucket["port"]):
        solo = run_tearing_device(
            pw.problem, pw.tris, pw.tri_weights, pw.source_signs, pw.ref_coords,
            5.0, pw.solver["lazy_allowed_flip_fraction"], eps_final=pw.eps_solver,
            prices0=pw.prices0, max_tear_rounds=TEAR_ROUNDS, obj_patience=128,
            device="cpu", max_rounds=got["max_rounds"],
            schedule_len=got["schedule_len"],
        )
        _assert_same_rounds(got, solo)


def test_tear_loop_batch_deadline_is_per_window(tear_bucket):
    """A deadline already past stops the batch after its first round; each
    window records ``time_limit_reached`` as the solo loop does, and the
    batch's ``device_time`` is split evenly over its windows."""
    pws = tear_bucket["pws"]
    args, kw = _batch_args(pws)
    got = run_tearing_device_batch(*args, mesh=[CPU], deadline=0.0, **kw)
    assert len({d["device_time"] for d in got}) == 1
    for pw, data in zip(pws, got):
        solo = run_tearing_device(
            pw.problem, pw.tris, pw.tri_weights, pw.source_signs, pw.ref_coords,
            5.0, pw.solver["lazy_allowed_flip_fraction"], eps_final=pw.eps_solver,
            prices0=pw.prices0, max_tear_rounds=TEAR_ROUNDS, obj_patience=128,
            device="cpu", max_rounds=data["max_rounds"],
            schedule_len=data["schedule_len"], deadline=0.0,
        )
        assert data["rounds_used"] == 1 and data["time_limit_reached"]
        _assert_same_rounds(data, solo)


def test_batched_kernels_on_cpu_are_per_window(tear_bucket):
    """K5 solves only the listed windows, each as ``auction_loop``; K6 gives
    ``tear_metrics`` window by window on the unpadded triangles and leaves
    the padded ones unchecked."""
    pws = tear_bucket["pws"]
    probs = [to_device(p.problem, CPU) for p in pws]
    stack = {f: torch.stack([getattr(p, f) for p in probs]) for f in (
        "costs", "slots", "valid", "nm_cost", "pair_idx", "cand_ref", "slot_rows",
        "slot_cols")}
    S1 = pws[0].problem.n_slots + 1
    prices0 = torch.stack([torch.as_tensor(p.prices0, dtype=torch.float32) for p in pws])
    sched = np.stack([[p.eps_solver * 8, p.eps_solver] for p in pws]).astype(np.float32)
    res = auction_loop_batch(
        stack["costs"], stack["slots"], stack["valid"], stack["nm_cost"], prices0,
        sched, 300, slot_rows=stack["slot_rows"], slot_cols=stack["slot_cols"],
        windows=[1],
    )
    assert res.rounds[0] == 0 and res.rounds[1] > 0
    one = auction_loop(
        probs[1].costs, probs[1].slots, probs[1].valid, probs[1].nm_cost, prices0[1],
        sched[1], 300, slot_rows=probs[1].slot_rows, slot_cols=probs[1].slot_cols,
    )
    assert (res.rounds[1], res.phase[1], res.polish[1]) == (one.rounds, one.phase, one.polish)
    for got, want in ((res.choice[1], one.choice), (res.prices[1], one.prices),
                      (res.owner[1], one.owner)):
        assert_bit_equal(got, want)

    T_list = [len(p.tris) for p in pws]
    T_pad, m = max(T_list) + 5, max(len(p.ref_coords) for p in pws)
    tris = torch.zeros((len(pws), T_pad, 3), dtype=torch.int32)
    src = torch.zeros((len(pws), T_pad), dtype=torch.int32)
    ref_xy = torch.zeros((len(pws), m, 2), dtype=torch.float32)
    for b, p in enumerate(pws):
        tris[b, :T_list[b]] = torch.as_tensor(p.tris, dtype=torch.int32)
        src[b, :T_list[b]] = torch.as_tensor(p.source_signs, dtype=torch.int32)
        ref_xy[b, :len(p.ref_coords)] = torch.from_numpy(np.array(p.ref_coords, np.float32))
    tri_mask = torch.arange(T_pad)[None, :] < torch.as_tensor(T_list)[:, None]
    extra = torch.zeros_like(stack["costs"])
    extra[:, ::7, ::3] = 25.0
    choice = torch.as_tensor(np.stack([d["choices"][1] for d in tear_bucket["port"]]))
    prices = torch.zeros((len(pws), S1), dtype=torch.float32)
    got = tear_metrics_batch(
        stack["costs"], extra, stack["slots"], stack["valid"], stack["nm_cost"],
        stack["pair_idx"], stack["cand_ref"], tris, tri_mask, src, ref_xy, prices, choice,
    )
    assert not got[0][tri_mask.logical_not()].any()
    for b, p in enumerate(pws):
        T = T_list[b]
        want = tear_metrics(
            stack["costs"][b], extra[b], stack["slots"][b], stack["valid"][b],
            stack["nm_cost"][b], stack["pair_idx"][b], stack["cand_ref"][b], tris[b, :T],
            torch.ones(T, dtype=torch.bool), src[b, :T],
            ref_xy[b, :len(p.ref_coords)], prices[b], choice[b],
        )
        assert int(want[1].sum()) > 0
        for g, w in zip(got, want):
            assert_bit_equal(g[b, :T], w)


def test_mesh_grid_matches_jax(tissue):
    """``sliding_window_matching(mesh=[cpu])`` returns the JAX package's rows
    with ``mesh=make_mesh(1)`` at ``delaunay_penalty=0`` (no wall-clock
    repair): the same (aligned, ref, window) triples in the same order."""
    kw = dict(commonCT=TYPES, optim_params=_window_params() | {"delaunay_penalty": 0},
              verbose=False)
    want = same_tpu.sliding_window_matching(*tissue, mesh=jax_mesh(1), **kw)
    got = same_tpu_torch.sliding_window_matching(*tissue, mesh=[CPU], device="cpu", **kw)
    assert got["window_id"].nunique() >= 3
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(
        got[KEY].reset_index(drop=True), want[KEY].reset_index(drop=True))
