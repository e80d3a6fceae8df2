"""``repair.sweeps_s``: mean seconds a window of the repair's greedy sweeps
(the program's span ``sweep_time`` in ``solver/repair.py::local_repair``),
from ``repair_stats``."""


def read(run):
    v = [((r.get("program") or {}).get("repair_stats") or {}).get("sweep_time")
         for r in run.records]
    v = [x for x in v if x is not None]
    return sum(v) / len(v) if v else None
