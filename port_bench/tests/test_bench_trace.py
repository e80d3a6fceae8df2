"""The traced run's arithmetic on a timeline made by hand (times in us, as
the profiler's trace gives them)."""

import pytest

from port_bench.trace import Timeline


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_and_gaps_inside_the_calls():
    events = [
        _x("user_annotation", "bench.call", 0, 1000),
        _x("user_annotation", "bench.solve_prepared", 100, 800),
        _x("user_annotation", "bench.call", 2000, 500),
        _x("kernel", "auction_loop_kernel(LoopArgs)", 200, 100),
        _x("kernel", "tear_scalars_kernel<false>", 250, 150),   # overlaps
        _x("gpu_memcpy", "Memcpy HtoD", 2100, 50),
        _x("kernel", "auction_loop_kernel(LoopArgs)", 1500, 100),  # between calls
        _x("cpu_op", "aten::add", 300, 10),
        _x("user_annotation", "other", 0, 5000),
    ]
    t = Timeline(events)
    assert t.window_s() == pytest.approx(1500e-6)
    assert t.busy_s() == pytest.approx(250e-6)
    assert t.op_seconds(("auction_loop",)) == pytest.approx(100e-6)
    assert (t.op_count(("auction_loop",), 0), t.op_count(("auction_loop",), 1)) == (1, 0)
    gaps = t.idle_gaps()
    assert gaps[0] == ["solve_prepared", pytest.approx(600e-6)]
    assert [g[0] for g in gaps] == ["solve_prepared", "call", "solve_prepared", "call"]
    assert t.top_ops()[0][0] == "tear_scalars_kernel<false>"
