"""Faults planted in the program through its own dials, read at the cell's
own size on the card.

    python3 -m port_bench.faults --workload <cell> --fault repair_skipped \\
        --seeds 11 12 13 --seconds 4

runs the cell once a seed with the fault planted and prints one JSON line a
seed: the run's numbers that ``correct`` compares, beside their limits. Each
fault has to come out not correct.

- ``repair_skipped``: ``tpu_repair_budget`` 0, the warm-up's own setting.
  The host repair (``solver/repair.py::local_repair``) gets a deadline that
  has already passed, so the separation loop's matching is returned as the
  loop left it.
"""

from __future__ import annotations

import argparse
import json

FAULTS = {
    "repair_skipped": {"solver_params": {"tpu_repair_budget": 0}},
}


def main(argv=None):
    from port_bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        res = run.execute(args.workload, seed, args.seconds, 0,
                          overrides=FAULTS[args.fault])
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)


if __name__ == "__main__":
    main()
