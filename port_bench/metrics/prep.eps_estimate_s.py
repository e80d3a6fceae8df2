"""``prep.eps_estimate_s``: mean seconds a window of the program's span
``eps_estimate`` in ``core.prepare_window`` (the greedy matching, its
objective and the auction's epsilon), from ``stage_times``."""


def read(run):
    v = [((r.get("program") or {}).get("stage_times") or {}).get("eps_estimate")
         for r in run.records]
    v = [x for x in v if x is not None]
    return sum(v) / len(v) if v else None
