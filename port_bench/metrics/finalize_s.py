"""``finalize_s``: mean seconds a window of the benchmark's span around
``core.finalize_window`` (output assembly and the violation check)."""


def read(run):
    v = [r["spans"]["finalize_window"] for r in run.records
         if "finalize_window" in r.get("spans", {})]
    return sum(v) / len(v) if v else None
