"""``separation_s``: mean seconds a window of the separation loop (the
program's counter ``stage_times["separation_time"]``: the auction and the
tear rounds, up to the repair)."""


def read(run):
    v = [r["program"]["stage_times"]["separation_time"] for r in run.records
         if (r.get("program") or {}).get("stage_times", {}).get("separation_time") is not None]
    return sum(v) / len(v) if v else None
