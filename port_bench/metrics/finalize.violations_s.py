"""``finalize.violations_s``: mean seconds a window of the program's span
``violations`` in ``core.finalize_window`` (``verify_spatial_preservation``),
from ``stage_times``."""


def read(run):
    v = [((r.get("program") or {}).get("stage_times") or {}).get("violations")
         for r in run.records]
    v = [x for x in v if x is not None]
    return sum(v) / len(v) if v else None
