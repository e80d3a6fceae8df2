"""BENCHMARK.json is well formed, and every name in it has its files."""

import os
import re

from port_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_is_well_formed():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in b["workloads"]] + [
        c["name"] for c in b["configs"]]
    for n in names:
        assert NAME.match(n), n
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])


def test_every_layer_metric_moves_a_metric_its_cells_report():
    b = spec.benchmark()
    for w in b["workloads"]:
        cell = spec.Cell(w["name"], b)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in b["per_layer"]:
        moved = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        for name in m.get("workloads", []):
            assert name in moved.get("workloads", [name])


def test_every_configuration_has_a_cell_and_every_name_its_file():
    b = spec.benchmark()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert c["name"] in used
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert c["file"].startswith(b["paths"][0] + "/")
    for w in b["workloads"]:
        cell = spec.Cell(w["name"], b)
        cell.entry(), cell.generator()
        assert set(cell.limits)
    for m in b["end_to_end"] + b["per_layer"]:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
