"""Spans and counters of same_tpu_torch (``same_tpu_torch/trace.py``).

A span sums its durations into the window's own dict and, only while a
torch profiler records, puts a ``same.<name>`` annotation into the
profiler's trace. ``run_same`` on the CPU, on the small labeled window of
the parity tests, must fill every span of the solve path that applies, each
inside its parent, and the repair's counters must say how it ended.
"""

import json

import pytest
import torch

import same_tpu_torch
from same_tpu_torch import trace
from torch_parity import WINDOW_SOLVER, labeled_window, run_window

# Each span and the span it lies in.
PARENT = {
    "inputs": "prepare_window",
    "candidates": "prepare_window",
    "triangulate": "prepare_window",
    "filter_triangles": "prepare_window",
    "triangle_index": "prepare_window",
    "costs": "prepare_window",
    "build_problem": "prepare_window",
    "eps_estimate": "prepare_window",
    "warm_start": "prepare_window",
    "separation_time": "solve",
    "host_queue_time": "solve",
    "incumbent_eval_time": "solve",
    "repair_time": "solve",
    "final_check": "solve",
    "separation_setup": "separation_time",
    "tear_round": "separation_time",
    "separation_readback": "separation_time",
    "device_wait": "tear_round",
    "sweep_time": "repair_time",
    "components_time": "repair_time",
    "intensify_time": "repair_time",
    "assemble": "finalize_window",
    "verify": "finalize_window",
    "violations": "verify",
    "triangle_areas": "verify",
}
# The spans the repair keeps in repair_stats (intensify_time only when its
# budget is left); finalize_window is in the trace alone; the fused loop
# alone has separation_setup and separation_readback.
REPAIR_SPANS = {"sweep_time", "components_time", "intensify_time"}
FUSED_ONLY = {"separation_setup", "separation_readback"}


def test_span_sums_and_nests_without_record_function(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a))
    times = {}
    with trace.span(times, "outer") as outer:
        for _ in range(3):
            with trace.span(times, "inner"):
                sum(range(10000))
    with trace.span(None, "untimed") as alone:
        pass
    assert calls == []
    assert set(times) == {"outer", "inner"}
    assert 0 < times["inner"] <= times["outer"] == outer.seconds
    assert alone.seconds >= 0
    both = {"inner": 1.0}
    trace.add(both, times)
    assert both["inner"] == 1.0 + times["inner"] and both["outer"] == times["outer"]


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [
        (e["name"][len(trace.PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and str(e.get("name", "")).startswith(trace.PREFIX)
    ]


def test_span_is_an_annotation_while_the_profiler_records(tmp_path):
    times = {}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with trace.span(times, "outer"):
            with trace.span(times, "inner"):
                torch.ones(8).sum()
    spans = {name: (t0, t1) for name, t0, t1 in _annotations(prof, tmp_path)}
    assert set(spans) == {"outer", "inner"}
    assert spans["outer"][0] <= spans["inner"][0] <= spans["inner"][1] <= spans["outer"][1]
    assert set(times) == {"outer", "inner"}


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """Two solves of the labeled window on the CPU, two tear rounds each
    (which leave the repair flips to remove): the host loop with a repair
    budget ~10x what it needs, traced; the fused loop with none."""
    ref, qry = labeled_window()
    short = dict(WINDOW_SOLVER, tpu_max_tear_rounds=2, tpu_eps_final=0.5)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _m, host = run_window(same_tpu_torch, ref, qry,
                              solver_params=dict(short, tpu_repair_budget=20.0))
    spans = _annotations(prof, tmp_path_factory.mktemp("trace"))
    _m, fused = run_window(
        same_tpu_torch, ref, qry,
        solver_params=dict(short, tpu_device_loop="force", tpu_repair_budget=0.0),
    )
    return {"host": (host["tpu"], spans), "fused": (fused["tpu"], None)}


@pytest.mark.parametrize("loop", ["host", "fused"])
def test_run_same_fills_every_span(windows, loop):
    tpu, _ = windows[loop]
    st, rs = tpu["stage_times"], tpu["repair_stats"]
    want = set(PARENT) - REPAIR_SPANS - {"finalize_window"} | {"prepare_window", "solve"}
    if loop == "host":
        want -= FUSED_ONLY
    assert want <= set(st), want - set(st)
    assert "sweep_time" in rs and "components_time" in rs
    assert all(v >= 0 for v in st.values())
    assert all(rs[k] >= 0 for k in REPAIR_SPANS if k in rs)


@pytest.mark.parametrize("loop", ["host", "fused"])
def test_children_fit_in_their_parents(windows, loop):
    tpu, _ = windows[loop]
    times = dict(tpu["stage_times"])
    rs = tpu["repair_stats"]
    times.update({k: rs[k] for k in REPAIR_SPANS if k in rs})
    kids = {}
    for child, parent in PARENT.items():
        if child in times and parent in times:
            kids[parent] = kids.get(parent, 0.0) + times[child]
    assert {"prepare_window", "solve", "separation_time", "tear_round",
            "repair_time", "verify"} <= set(kids)
    for parent, total in kids.items():
        assert total <= times[parent] + 1e-3, (parent, total, times[parent])
    assert kids["prepare_window"] >= 0.9 * times["prepare_window"]


def test_trace_spans_lie_in_their_parents(windows):
    _, spans = windows["host"]
    names = {name for name, _t0, _t1 in spans}
    assert {"prepare_window", "solve", "finalize_window", "tear_round",
            "device_wait", "sweep_time", "violations"} <= names
    for name, t0, t1 in spans:
        parent = PARENT.get(name)
        if parent is None:
            continue
        assert any(p == parent and p0 <= t0 + 1 and t1 <= p1 + 1
                   for p, p0, p1 in spans), name


def test_host_pass_spans_and_greedy_rounds(windows):
    for tpu, _ in windows.values():
        st = tpu["stage_times"]
        for name in ("eps_estimate", "triangle_index", "warm_start",
                     "violations", "triangle_areas"):
            assert 0 <= st[name] <= st[PARENT[name]], name
        assert tpu["warm_start"]["greedy_rounds"] >= 1


def test_repair_counters_under_a_generous_budget(windows):
    rs = windows["host"][0]["repair_stats"]
    assert rs["ended_by"] in ("converged", "stall", "max_passes")
    assert rs["sweeps"] >= 1 and rs["sweep_candidates"] >= 1 and rs["sweep_vertices"] >= 1
    assert rs["component_passes"] >= 1
    tol = 1e-9 * abs(rs["objective_in"])
    assert rs["objective_out"] <= rs["objective_after_sweeps"] + tol
    assert rs["objective_after_sweeps"] <= rs["objective_in"] + tol


def test_repair_counters_under_no_budget(windows):
    rs = windows["fused"][0]["repair_stats"]
    assert rs["ended_by"] == "deadline"
    assert rs["sweeps_cut_short"] == 1
    assert rs["sweep_moves"] == rs["compound_moves"] == 0
    assert rs["objective_out"] == rs["objective_after_sweeps"] == rs["objective_in"]
