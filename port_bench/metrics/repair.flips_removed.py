"""``repair.flips_removed``: mean flipped triangles a window that the host
repair (``solver/repair.py::local_repair``) removed, from the program's
counters ``repair_stats["flips_in"] - repair_stats["flips_out"]``."""


def read(run):
    v = []
    for r in run.records:
        rs = (r.get("program") or {}).get("repair_stats") or {}
        if "flips_in" in rs and "flips_out" in rs:
            v.append(rs["flips_in"] - rs["flips_out"])
    return sum(v) / len(v) if v else None
