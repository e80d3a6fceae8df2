"""Spans of the program: where a window's time goes, on two clocks.

``with span(times, name):`` adds the block's duration, in seconds on
``time.perf_counter``, to ``times[name]`` (summed over repeats). The stores
are a window's own dicts (``PreparedWindow.stage_times``, a solve's
``TearingResult.info``, the repair's ``repair_stats``), so windows solved in
threads never share one; ``times=None`` keeps the span in the trace alone.
Deadlines stay on ``time.time``.

While a ``torch.profiler`` records, the span also opens
``torch.profiler.record_function("same." + name)``, which puts it into the
profiler's trace on the same clock as the device's kernels. The check costs
well under a microsecond; ``record_function`` itself costs several even with
no profiler, so it is opened only then.
"""

from __future__ import annotations

import contextlib
import time

import torch

PREFIX = "same."


class span:
    """Time a block into ``times[name]``; annotate it while a profiler records.
    After the block, ``seconds`` holds its duration."""

    __slots__ = ("times", "name", "t0", "annotation", "seconds")

    def __init__(self, times, name):
        self.times = times
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(PREFIX + self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.seconds = time.perf_counter() - self.t0
        if self.times is not None:
            self.times[self.name] = self.times.get(self.name, 0.0) + self.seconds
        return False


def add(into, times):
    """Sum the spans of ``times`` into ``into``."""
    for name, seconds in times.items():
        into[name] = into.get(name, 0.0) + seconds


@contextlib.contextmanager
def locked(times, lock):
    """Hold ``lock`` for the block; the wait to take it is the span
    ``host_queue_time``."""
    with span(times, "host_queue_time"):
        lock.acquire()
    try:
        yield
    finally:
        lock.release()
