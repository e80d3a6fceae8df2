"""``repair.components_s``: mean seconds a window of the repair's component
MILP passes (the program's span ``components_time`` in
``solver/repair.py::local_repair``), from ``repair_stats``."""


def read(run):
    v = [((r.get("program") or {}).get("repair_stats") or {}).get("components_time")
         for r in run.records]
    v = [x for x in v if x is not None]
    return sum(v) / len(v) if v else None
