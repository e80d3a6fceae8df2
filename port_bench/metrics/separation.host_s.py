"""``separation.host_s``: mean seconds a window that the separation loop
spends on the host, from ``stage_times``: the program's span
``separation_time`` less its spans ``device_wait`` (every point where the
host blocks on the card)."""


def read(run):
    v = []
    for r in run.records:
        st = (r.get("program") or {}).get("stage_times") or {}
        if "separation_time" in st and "device_wait" in st:
            v.append(st["separation_time"] - st["device_wait"])
    return sum(v) / len(v) if v else None
