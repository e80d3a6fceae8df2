"""``prep.triangle_index_s``: mean seconds a window of the program's span
``triangle_index`` in ``core.prepare_window`` (the simplex map and
``precompute_triangle_info``), from ``stage_times``."""


def read(run):
    v = [((r.get("program") or {}).get("stage_times") or {}).get("triangle_index")
         for r in run.records]
    v = [x for x in v if x is not None]
    return sum(v) / len(v) if v else None
