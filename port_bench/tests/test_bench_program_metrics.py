"""The readers of the program's spans and counters, on records made by hand:
a mean over the windows that carry what they read, and nothing (not an
error) from a program without those spans."""

from types import SimpleNamespace

import pytest

from port_bench import spec

READERS = (
    "prep.triangle_index_s", "prep.eps_estimate_s", "separation.host_s",
    "repair.sweeps_s", "repair.components_s", "repair.sweep_vertices_per_s",
    "repair.deadline_pct", "finalize.violations_s",
)


def _record(stage_times, repair_stats):
    return {"wall": 13.6, "program": {
        "tear_rounds": 25, "auction_rounds_total": 60000,
        "stage_times": stage_times, "repair_stats": repair_stats}}


def _run(*records):
    return SimpleNamespace(records=list(records), timeline=None)


WINDOWS = _run(
    _record(
        {"triangle_index": 0.2, "eps_estimate": 0.1, "separation_time": 0.3,
         "device_wait": 0.2, "violations": 0.25},
        {"sweep_time": 4.0, "components_time": 7.0, "sweep_vertices": 8000,
         "ended_by": "deadline"},
    ),
    _record(
        {"triangle_index": 0.4, "eps_estimate": 0.3, "separation_time": 0.5,
         "device_wait": 0.2, "violations": 0.15},
        {"sweep_time": 2.0, "components_time": 1.0, "sweep_vertices": 2000,
         "ended_by": "stall"},
    ),
    {"wall": 1.0, "error": "Traceback ..."},
    _record(None, None),
)

WANT = {
    "prep.triangle_index_s": 0.3,
    "prep.eps_estimate_s": 0.2,
    "separation.host_s": 0.2,
    "repair.sweeps_s": 3.0,
    "repair.components_s": 4.0,
    "repair.sweep_vertices_per_s": 1500.0,
    "repair.deadline_pct": 50.0,
    "finalize.violations_s": 0.2,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_takes_the_mean_over_the_windows(name):
    assert spec.load_module("metrics", name).read(WINDOWS) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_an_older_program(name):
    older = _run(_record({"separation_time": 0.3, "prepare_window": 0.7},
                         {"flips_in": 1400, "flips_out": 1150, "sweep_time": 4.8}),
                 _record(None, None))
    value = spec.load_module("metrics", name).read(older)
    if name == "repair.sweeps_s":
        assert value == pytest.approx(4.8)
    else:
        assert value is None


def test_each_reader_has_its_entry():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["moves"] == "aligned_per_s" and m["workloads"] == ["luad.dp25.window"]
        kind = "program_counter" if name in ("repair.sweep_vertices_per_s",
                                             "repair.deadline_pct") else "program_span"
        assert m["source"] == kind
