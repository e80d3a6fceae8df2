"""Port parity: ``same_tpu_torch.sliding_window_matching`` against the JAX
package on the lower left 10 x 10 of the seed-8899 synthetic tissue
(tests/test_windows.py's parameters), on the CPU. The cut keeps the file's
grid runs short and leaves a 2 x 2 grid of full windows, none of which is
merged into a neighbour, so a resumed run walks the same grid.

``delaunay_penalty=0`` keeps every window's solve deterministic (no
wall-clock-budgeted repair, as tests/test_windows.py's
``test_pipelined_matches_sequential`` argues), so the port must return the
JAX package's rows: the same window ids and the same (aligned, ref, window)
triples in the same order, sequentially and with three windows in flight.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import same_tpu
import same_tpu_torch
from same_tpu.windows import _hopcroft_karp_py as hk_jax
from same_tpu_torch import windows as tw
from test_windows import _window_params

KEY = ["Aligned_cell_idx", "Ref_cell_idx", "window_id"]
TYPES = ["c1", "c2", "c3"]
OPTIM = _window_params() | {"delaunay_penalty": 0}


def _grid(pkg, ref_df, query_df, pipeline, outprefix=None, **kw):
    if pkg is same_tpu_torch:
        kw.setdefault("device", "cpu")
    return pkg.sliding_window_matching(
        ref_df, query_df, commonCT=TYPES, optim_params=OPTIM, outprefix=outprefix,
        solver_params=dict(tpu_pipeline_windows=pipeline), verbose=False, **kw,
    )


@pytest.fixture(scope="module")
def tissue():
    ref_df, query_df, _q, _gt, _e = same_tpu_torch.create_full_benchmark(seed=8899)
    return tuple(
        df[(df["X"] < 9.9) & (df["Y"] < 9.9)].reset_index(drop=True)
        for df in (ref_df, query_df)
    )


@pytest.fixture(scope="module")
def grids(tissue, tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_windows")
    return {
        "jax": _grid(same_tpu, *tissue, 1),
        "seq": _grid(same_tpu_torch, *tissue, 1, outprefix=str(out)),
        "out": out,
    }


def test_sequential_rows_match_jax(grids):
    mj, mt = grids["jax"], grids["seq"]
    assert mt["window_id"].nunique() >= 3
    assert sorted(mt["window_id"].unique()) == sorted(mj["window_id"].unique())
    assert list(mt.columns) == list(mj.columns)
    pd.testing.assert_frame_equal(
        mt[KEY].reset_index(drop=True), mj[KEY].reset_index(drop=True))


def test_pipelined_equals_sequential(tissue, grids):
    pipe = _grid(same_tpu_torch, *tissue, 3)
    pd.testing.assert_frame_equal(
        pipe[KEY].reset_index(drop=True), grids["seq"][KEY].reset_index(drop=True))


def test_resume_skips_checkpointed_windows(tissue, grids, tmp_path, monkeypatch):
    mt, out = grids["seq"], grids["out"]
    saved = pd.read_csv(out / "matchedDF.csv")
    assert len(saved) == len(mt) and (out / "window_0" / "matches_df.csv").exists()
    solved = []
    orig = tw.run_same
    monkeypatch.setattr(
        tw, "run_same", lambda *a, **k: solved.append(1) or orig(*a, **k))
    # Every window with rows is in the checkpoint and is not solved again. A
    # window whose central crop kept no row left none there, and is solved
    # on every resume (the reference's behaviour too).
    wids = list(pd.unique(saved["window_id"]))
    again = _grid(same_tpu_torch, *tissue, 1, outprefix=str(out))
    rowless = len(solved)
    assert rowless < len(wids) and len(again) == len(mt)
    pd.testing.assert_frame_equal(
        again[KEY].reset_index(drop=True), mt[KEY].reset_index(drop=True))
    solved.clear()
    # A checkpoint cut after the first two windows: only the rest is solved,
    # and the checkpointed rows come back as they were saved.
    saved[saved["window_id"].isin(wids[:2])].to_csv(tmp_path / "matchedDF.csv", index=False)
    resumed = _grid(same_tpu_torch, *tissue, 1, outprefix=str(tmp_path))
    assert len(solved) == len(wids) - 2 + rowless
    pd.testing.assert_frame_equal(
        resumed[KEY].reset_index(drop=True), mt[KEY].reset_index(drop=True))


def test_merge_unique_ref_matches_jax(grids):
    want = same_tpu.merge_window_matches_unique_ref([grids["jax"]], cell_id_col="cell_idx")
    got = same_tpu_torch.merge_window_matches_unique_ref([grids["seq"]], cell_id_col="cell_idx")
    assert got["Aligned_cell_idx"].is_unique and got["Ref_cell_idx"].is_unique
    pd.testing.assert_frame_equal(got[KEY], want[KEY])
    assert same_tpu_torch.merge_window_matches_unique_ref([]).empty


@pytest.mark.parametrize("trial", range(8))
def test_hopcroft_karp_matches_jax(trial):
    """Five random graphs a case, drawn as tests/test_windows.py:145-168."""
    rng = np.random.default_rng(100 + trial)
    for _ in range(5):
        n_a, n_b = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        n_e = int(rng.integers(1, 4 * max(n_a, n_b)))
        ai, bi = rng.integers(0, n_a, n_e), rng.integers(0, n_b, n_e)
        np.testing.assert_array_equal(
            tw._hopcroft_karp_py(ai, bi, n_a, n_b), hk_jax(ai, bi, n_a, n_b))
        np.testing.assert_array_equal(
            tw._max_bipartite_matching(ai, bi, n_a, n_b), hk_jax(ai, bi, n_a, n_b))


def test_subset_and_unprocessed_windows_match_jax(tissue, grids):
    ref_df, query_df = tissue
    pd.testing.assert_frame_equal(
        tw.subset_data(ref_df, 2, 7, 3, 9), same_tpu.subset_data(ref_df, 2, 7, 3, 9))
    xs, ys = list(range(0, 13, 5)), list(range(0, 13, 5))
    args = (query_df, str(grids["out"] / "matchedDF.csv"), xs, ys, 7, 2)
    todo_t, existing_t = tw.get_unprocessed_windows(*args, cell_id_col="cell_idx")
    todo_j, existing_j = same_tpu.get_unprocessed_windows(*args, cell_id_col="cell_idx")
    assert todo_t == todo_j
    pd.testing.assert_frame_equal(existing_t, existing_j)


def test_host_shard_single_process_is_the_sequential_grid(tissue, grids):
    """With no process group the one process owns every window."""
    shard = _grid(same_tpu_torch, *tissue, 1, host_shard=True)
    pd.testing.assert_frame_equal(
        shard[KEY].reset_index(drop=True), grids["seq"][KEY].reset_index(drop=True))


def test_grid_needs_card_by_default(tissue, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        _grid(same_tpu_torch, *tissue, 1, device=None)


def test_cell_type_mismatch_raises(tissue):
    ref_df, query_df = tissue
    bad_ref = ref_df.copy()
    bad_ref["cell_type"] = "other"
    with pytest.raises(ValueError, match="Cell type categories differ"):
        _grid(same_tpu_torch, bad_ref, query_df, 1)


def test_new_modules_import_no_jax(tmp_path):
    """The window grid, the batched window solve, the device kNN and the
    Sinkhorn start run with jax made unimportable; the multi-process grid,
    the entry-point twins and the figures import without it."""
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path[:0] = [{os.path.dirname(tests_dir)!r}, {tests_dir!r}]\n"
        "import numpy as np\n"
        "import same_tpu_torch.windows, same_tpu_torch.ops.pairwise, same_tpu_torch.ops.sinkhorn\n"
        "import same_tpu_torch.parallel, same_tpu_torch.parallel.distributed\n"
        "import same_tpu_torch.graft_entry, same_tpu_torch.viz\n"
        "from same_tpu_torch.models.assignment import build_assignment_problem\n"
        "from torch_parity import knn_points, sinkhorn_problem\n"
        "q, r, radius, k = knn_points('ties')\n"
        "idx, _d, mask = same_tpu_torch.ops.pairwise.radius_knn_device(q, r, radius, k, device='cpu')\n"
        "assert bool(mask.any())\n"
        "pb = build_assignment_problem(*sinkhorn_problem(1, 30, 25, 4))\n"
        "prices = same_tpu_torch.ops.sinkhorn.sinkhorn_prices(pb, n_iters=5, device='cpu')\n"
        "assert np.isfinite(prices).all()\n"
        "assert callable(same_tpu_torch.sliding_window_matching)\n"
        "(match_ref, _p), = same_tpu_torch.parallel.solve_window_batch([pb], mesh=['cpu'])[0]\n"
        "assert (match_ref >= 0).any()\n"
        "loaded = [k for k, mod in sys.modules.items()\n"
        "          if (k == 'jax' or k.startswith(('jax.', 'jaxlib', 'same_tpu.')))\n"
        "          and mod is not None]\n"
        "assert not loaded, loaded\n"
        "print('OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().startswith("OK")
