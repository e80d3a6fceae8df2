"""Controls: the plain reference put in the program's place with one of the
configuration's guarantees broken, judged exactly as a run judges the
program. Each has to come out not correct.

- ``capacity_free``: each aligned metacell takes its cheapest candidate, or
  none, with the reference capacities dropped;
- ``no_tearing`` (configurations with a tearing term): the assignment
  optimum without the tearing term, so the Delaunay penalty is dropped.

    python3 -m port_bench.control --workload <cell> --seeds 11 12 13 [--calls 4]

prints one JSON line a seed and control: the numbers that ``correct``
compares, over the inputs of the run's first ``--calls`` calls, beside the
cell's limits. It runs no program and needs no card.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np

from port_bench import spec
from port_bench.reference import window as rw



def _window_record(w, match):
    """A record as the program's entry fills it, from a reference matching
    (ref row per aligned row): the reference's own triangles and flips, so
    that only the matching differs."""
    ok = match >= 0
    return {
        "n_aligned": len(w.aligned_ids),
        "aligned_ids": w.aligned_ids[ok],
        "ref_ids": w.ref_ids[match[ok]],
        "triangles": w.tris,
        "flips": int(rw.flipped_triangles(w, match).sum()),
    }


def window_control(name, w):
    if name == "no_tearing":
        return _window_record(w, rw.optimum(w)[1])
    if name == "capacity_free":
        best_cost = np.full(len(w.aligned_ids), np.inf)
        np.minimum.at(best_cost, w.pairs[:, 0], w.pair_cost)
        first = w.pair_cost == best_cost[w.pairs[:, 0]]
        match = np.full(len(w.aligned_ids), -1, np.int64)
        rows = w.pairs[first, 0]
        keep = np.ones(len(rows), bool)
        keep[1:] = rows[1:] != rows[:-1]
        take = w.pairs[first][keep]
        cheaper = w.pair_cost[first][keep] < w.no_match[take[:, 0]]
        match[take[cheaper, 0]] = take[cheaper, 1]
        return _window_record(w, match)
    raise KeyError(name)


def controls_of(cell):
    if float(cell.config["optim_params"]["delaunay_penalty"]) > 0:
        return ("capacity_free", "no_tearing")
    return ("capacity_free",)


def control_checks(workload, seed, calls, control, overrides=None):
    """The numbers a run of ``workload`` with ``--seed seed`` would compare
    if ``control`` had answered its first ``calls`` calls."""
    cell = spec.Cell(workload, overrides=overrides)
    gen, entry = cell.generator(), cell.entry()
    ctx = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                          types=list(gen.LUAD_TYPES))
    inputs = [gen.make([int(seed), k], cell.traffic, cell.config) for k in range(calls)]
    records = [window_control(control, entry.window_of(ctx, inp)) for inp in inputs]
    checks, _ = entry.judge(ctx, inputs, records, list(range(calls)))
    return checks, cell.limits


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)
    names = controls_of(spec.Cell(args.workload))
    for seed in args.seeds:
        for name in names:
            checks, limits = control_checks(args.workload, seed, args.calls, name)
            failed = sorted(k for k in limits if checks[k] > limits[k])
            print(json.dumps({"workload": args.workload, "seed": seed, "control": name,
                              "checks": checks, "limits": limits,
                              "correct": not failed, "fails": failed}), flush=True)


if __name__ == "__main__":
    main()
