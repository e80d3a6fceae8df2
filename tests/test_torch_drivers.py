"""The port's drivers against the JAX package's scripts, on the CPU.

``same_tpu_torch.examples.bench_grid`` (the twin of ``examples/bench_grid.py``)
and the root ``bench_torch.py`` (the twin of ``bench.py``): the tissue, the
grid's rows at dp = 0 (no wall-clock-budgeted repair decides them), the
downstream evaluation and the stage telemetry against the scripts' own
functions on the same inputs, ``bench_torch``'s JSON line against
``bench.py``'s fields, and that neither runs on the CPU unless asked.

The JAX scripts are loaded from their files under private module names;
``bench.py`` and ``examples/bench_grid.py`` set ``JAX_COMPILATION_CACHE_DIR``
and ``sys.path`` when they are imported, which is undone afterwards.
"""

import ast
import importlib.util
import json
import os
import sys

import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from same_tpu_torch import greedy_triangle_collapse  # noqa: E402
from same_tpu_torch.examples import bench_grid as twin  # noqa: E402
from same_tpu_torch.instances import make_instance  # noqa: E402

KEY = ["window_id", "Aligned_metacell_id", "Ref_metacell_id"]
# Small enough for one window of about 600 aligned metacells (the fused
# loop) in a few seconds on each package.
TISSUE = dict(n_cells=1500, extent=3000.0)


def load_script(relpath):
    """The repo's script ``relpath`` as a module, leaving ``os.environ`` and
    ``sys.path`` as they were."""
    name = "_jax_script_" + relpath.replace("/", "_").removesuffix(".py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
        mp.setattr(sys, "path", list(sys.path))
        spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def script():
    return load_script("examples/bench_grid.py")


@pytest.fixture(scope="module")
def grids(script, tmp_path_factory):
    """Each package's collapse and ``run_grid`` at dp = 0 on one tissue."""
    ref_df, qry_df, types = twin.make_tissue(**TISSUE)
    out = {"types": types}
    for pkg, mod in (("jax", script), ("port", twin)):
        mc_align, mc_ref = mod.collapse(qry_df), mod.collapse(ref_df)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        ckpt = tmp_path_factory.mktemp(f"grid_{pkg}")
        _t, matches = mod.run_grid(mc_ref, mc_align, types, 0.0, out=str(ckpt),
                                   verbose=False, **kw)
        out[pkg] = dict(mc_ref=mc_ref, mc_align=mc_align, matches=matches, out=str(ckpt))
    return out


def test_make_tissue_frames_equal_the_scripts(script):
    got = twin.make_tissue(n_cells=2000, extent=4000.0, seed=5, query_keep=0.9)
    want = script.make_tissue(n_cells=2000, extent=4000.0, seed=5, query_keep=0.9)
    for a, b in zip(got[:2], want[:2]):
        pd.testing.assert_frame_equal(a, b)
    assert got[2] == want[2] == twin.LUAD_TYPES


def test_run_grid_rows_equal_the_scripts(grids):
    for side in ("mc_ref", "mc_align"):
        pd.testing.assert_frame_equal(grids["port"][side].metacell_df,
                                      grids["jax"][side].metacell_df)
    got = grids["port"]["matches"].sort_values(KEY).reset_index(drop=True)
    want = grids["jax"]["matches"].sort_values(KEY).reset_index(drop=True)
    assert len(got) > 400 and list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[KEY], want[KEY])


def test_evaluate_equals_the_scripts(script, grids):
    jax = grids["jax"]
    args = (jax["matches"], jax["mc_ref"], jax["mc_align"], grids["types"])
    got, want = twin.evaluate(*args), script.evaluate(*args)
    for d in (got, want):
        d.pop("downstream_seconds")
    assert got == want
    assert got["individual_matches"] > len(jax["matches"])


def test_harvest_stage_telemetry_equals_the_scripts(script, grids, tmp_path):
    stages = [
        dict(device_time=1.25, separation_time=2.5, repair_time=4.0,
             incumbent_eval_time=0.125),
        dict(device_time=0.5, separation_time=0.75),
        {},
    ]
    for i, st in enumerate(stages):
        (tmp_path / f"window_{i}").mkdir()
        (tmp_path / f"window_{i}" / "solver_state.json").write_text(
            json.dumps({"solve": {"stage_times": st}}))
    (tmp_path / "window_9").mkdir()
    (tmp_path / "window_9" / "solver_state.json").write_text("{not json")
    got = twin.harvest_stage_telemetry(str(tmp_path), 6.5)
    assert got == script.harvest_stage_telemetry(str(tmp_path), 6.5)
    assert got["windows_with_telemetry"] == 3 and got["repair_s"] == 4.0
    # And on the checkpoints the port's run_grid wrote.
    out = grids["port"]["out"]
    got = twin.harvest_stage_telemetry(out, 3.0)
    assert got == script.harvest_stage_telemetry(out, 3.0)
    assert got["windows_with_telemetry"] == grids["port"]["matches"]["window_id"].nunique()
    assert twin.harvest_stage_telemetry(str(tmp_path / "none"), 1.0) == {}


def small_window():
    ref_df, qry_df, types = make_instance(n_cells=500, extent=1300.0)
    kw = dict(original_idx_col="Cell_Num_Old", max_metacell_size=3, r_max=250,
              min_angle_deg=15, return_object=True, verbose=False)
    return greedy_triangle_collapse(ref_df, **kw), greedy_triangle_collapse(qry_df, **kw), types


def test_run_once_runs_on_the_cpu():
    mc_ref, mc_align, types = small_window()
    wall, matches, var_out = bench_torch.run_once(mc_ref, mc_align, types, dp=0.0,
                                                  device="cpu")
    assert wall > 0 and 0.9 * len(mc_align.metacell_df) <= len(matches)
    assert matches["Aligned_metacell_id"].is_unique
    assert var_out["tpu"]["auction_rounds_total"] > 0


def bench_py_fields():
    """The keys of the dict that ``bench.py``'s main prints."""
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict) and n.keys
             and all(isinstance(k, ast.Constant) for k in n.keys)]
    return [k.value for k in max(dicts, key=lambda d: len(d.keys)).keys]


def test_bench_torch_prints_bench_py_fields(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "make_instance",
                        lambda: make_instance(n_cells=500, extent=1300.0))
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--dp", "0", "--device", "cpu"])
    bench_torch.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fields = bench_py_fields()
    assert "platform" in fields and "iterations_s" in fields
    assert list(line) == fields + ["device"]
    assert line["platform"] == line["device"] == "cpu"
    assert len(line["iterations_s"]) == 3 and line["matches"] > 0


def test_twins_need_a_card(monkeypatch):
    """Without a card and without ``--device cpu`` both fail before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_work(*a, **k):
        raise AssertionError("a twin started work without a card")

    monkeypatch.setattr(twin, "make_tissue", no_work)
    monkeypatch.setattr(bench_torch, "make_instance", no_work)
    for module, argv in ((twin, ["bench_grid", "--dp", "25"]), (bench_torch, ["bench_torch.py"])):
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(RuntimeError, match="CUDA card"):
            module.main()
