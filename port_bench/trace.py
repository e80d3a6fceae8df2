"""Spans of the benchmark's own and the device's timeline from torch.profiler.

The benchmark opens a span (``torch.profiler.record_function``) around each
call and around each stage of the program it calls. The traced run exports
the profiler's trace to a file under ``TMPDIR``, reads the spans and the
device operations (kernels, copies, memsets) from it on one clock, and
deletes it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Spans:
    """Host-clock spans of a run; in a traced run also profiler annotations."""

    def __init__(self, traced):
        self.traced = traced

    @contextlib.contextmanager
    def __call__(self, name, record):
        """Time ``name`` into ``record["spans"]`` (seconds, summed)."""
        t0 = time.perf_counter()
        if self.traced:
            import torch

            with torch.profiler.record_function(f"bench.{name}"):
                yield
        else:
            yield
        spans = record.setdefault("spans", {})
        spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


class Timeline:
    """Device operations and benchmark spans of one traced window, in seconds
    on the profiler's clock."""

    def __init__(self, events):
        self.ops = []      # (name, start, end)
        self.spans = []    # (name, start, end), name without "bench."
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e["dur"]) * 1e-6
            if e.get("cat") in DEVICE_CATS:
                self.ops.append((e.get("name", "?"), t0, t1))
            elif e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("bench."):
                self.spans.append((e["name"][len("bench."):], t0, t1))
        self.ops.sort(key=lambda o: o[1])
        self.calls = sorted((s for s in self.spans if s[0] == "call"), key=lambda s: s[1])

    @classmethod
    def from_profiler(cls, prof):
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        return cls(data.get("traceEvents", data if isinstance(data, list) else []))

    def window_s(self):
        """The traced window: the calls' spans, summed."""
        return sum(t1 - t0 for _, t0, t1 in self.calls)

    def busy_intervals(self, lo, hi):
        """Union of the device operations' intervals, clipped to [lo, hi]."""
        out = []
        for _name, t0, t1 in self.ops:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 <= t0:
                continue
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out

    def busy_s(self):
        """Seconds in which a device operation ran, inside the calls."""
        return sum(
            t1 - t0
            for _, lo, hi in self.calls
            for t0, t1 in self.busy_intervals(lo, hi)
        )

    def op_seconds(self, match):
        """Summed device time, inside the calls, of the operations whose
        name contains one of ``match``."""
        return sum(
            min(t1, hi) - max(t0, lo)
            for _, lo, hi in self.calls
            for name, t0, t1 in self.ops
            if t1 > lo and t0 < hi and any(m in name for m in match)
        )

    def op_count(self, match, call):
        """Device operations of call number ``call`` whose name contains one
        of ``match``."""
        _, lo, hi = self.calls[call]
        return sum(
            1 for name, t0, _t1 in self.ops
            if lo <= t0 < hi and any(m in name for m in match)
        )

    def top_ops(self, n=10):
        by_name = {}
        for _, lo, hi in self.calls:
            for name, t0, t1 in self.ops:
                if t1 > lo and t0 < hi:
                    by_name[name] = by_name.get(name, 0.0) + min(t1, hi) - max(t0, lo)
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The longest stretches inside the calls with no device operation,
        each named by the innermost benchmark span open at its middle."""
        gaps = []
        for _, lo, hi in self.calls:
            t = lo
            for t0, t1 in self.busy_intervals(lo, hi) + [[hi, hi]]:
                if t0 > t:
                    gaps.append((t, t0))
                t = max(t, t1)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for t0, t1 in gaps[:n]:
            mid = 0.5 * (t0 + t1)
            inner = [s for s in self.spans if s[1] <= mid <= s[2]]
            name = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "outside"
            out.append([name, t1 - t0])
        return out
