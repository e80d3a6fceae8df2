"""``prep_s``: mean seconds a window of the benchmark's span around
``core.prepare_window`` (traced runs call the three stages of ``run_same``)."""


def read(run):
    v = [r["spans"]["prepare_window"] for r in run.records
         if "prepare_window" in r.get("spans", {})]
    return sum(v) / len(v) if v else None
