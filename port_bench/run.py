"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, entry, generator, limits and metric
readers are files under this folder, found by the names in
``BENCHMARK.json`` (``spec.py``). A run makes its inputs from ``--seed``,
warms up on the cell's own shapes (counted as set-up), then calls the entry
in a closed loop, one new seeded input a call, until the calls have taken
``--seconds``; the call in flight finishes. Inputs are made between calls
with the clock stopped. With ``--trace 1`` the calls run under
torch.profiler and the line carries the per-layer metrics; with ``--trace
0`` it carries the end-to-end ones. After the window the plain reference
judges the calls' outputs; each number compared is printed beside its limit
as the last lines of standard error and under ``checks``, the line's last
key. The run raises without a CUDA card: there is no CPU fallback.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from port_bench import guard, spec  # noqa: E402
from port_bench.trace import Spans, Timeline  # noqa: E402

WARM_UP_STREAM = 1 << 40   # the warm-up input's index in the seed's streams


class NoCard(RuntimeError):
    pass


def execute(workload, seed, seconds, trace, device=None, overrides=None):
    """One run; returns its result line as a dict.

    ``device=None`` is the first CUDA card and raises ``NoCard`` without
    enough of them. ``device="cpu"`` and ``overrides`` (``{"traffic": {...},
    <configuration group>: {...}}``, keys that replace the mix's and the
    configuration's) exist for the tests, which drive the rest of a run on
    the CPU at a small size.
    """
    cell = spec.Cell(workload, overrides=overrides)
    import torch

    on_card = device is None
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(
                f"cell {workload} needs {cell.chips} CUDA card(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            )
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    import same_tpu_torch  # noqa: F401  (fails here when the program is absent)

    gen = cell.generator()
    entry = cell.entry()
    ctx = SimpleNamespace(
        config=cell.config, traffic=cell.traffic, types=list(gen.LUAD_TYPES),
        device=device,
    )

    def make_input(index):
        return gen.make([int(seed), int(index)], cell.traffic, cell.config)

    entry.warm_up(ctx, make_input(WARM_UP_STREAM))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    spans = Spans(bool(trace))
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    inputs, records, failed, elapsed = [], [], 0, 0.0
    while elapsed < seconds:
        inp = make_input(len(records))
        rec = {}
        t0 = time.perf_counter()
        try:
            with spans("call", rec):
                entry.call(ctx, inp, spans, rec)
                if on_card:
                    torch.cuda.synchronize()
        except Exception:  # a failed call is counted and reported, not fatal
            failed += 1
            rec["error"] = traceback.format_exc(limit=3)
            print(rec["error"], file=sys.stderr)
        rec["wall"] = time.perf_counter() - t0
        elapsed += rec["wall"]
        inputs.append(inp)
        records.append(rec)
    if prof is not None:
        prof.stop()
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    timeline = Timeline.from_profiler(prof) if prof is not None else None
    del prof
    if on_card:
        torch.cuda.empty_cache()

    picks = [k for k, r in enumerate(records) if "error" not in r]
    checks, extras = entry.judge(ctx, inputs, records, picks) if picks else ({}, {})
    limits = cell.limits
    correct = (
        failed == 0 and bool(picks) and set(checks) == set(limits)
        and all(checks[k] <= limits[k] for k in limits)
    )

    run = SimpleNamespace(
        setup_s=setup_s, records=records, inputs=inputs, extras=extras,
        timeline=timeline, ctx=ctx, seconds=seconds,
    )
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": cell.chips,
        "memory_peak_bytes": memory_peak,
    }
    result = {
        "correct": bool(correct),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s()
        dev["window_s"] = timeline.window_s()
        result["breakdown"] = {
            "device_ops": timeline.top_ops(),
            "idle_gaps": timeline.idle_gaps(),
        }
    for k, r in enumerate(records):
        print(f"call {k}: {r['n_aligned'] if 'n_aligned' in r else '-'} aligned, "
              f"{r['wall']:.3f} s", file=sys.stderr)
    result["checks"] = {
        k: {"value": float(checks[k]) if k in checks else None, "limit": limits[k]}
        for k in limits
    }
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = execute(args.workload, args.seed, args.seconds, args.trace)
    except NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 3
    found = guard.forbidden_loaded()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
