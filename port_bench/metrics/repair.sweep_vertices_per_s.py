"""``repair.sweep_vertices_per_s``: the repair's greedy sweeps' speed, mean
over the windows of the program's counter ``sweep_vertices`` (vertices
whose moves were evaluated) over its span ``sweep_time``, from
``repair_stats``."""


def read(run):
    v = []
    for r in run.records:
        rs = (r.get("program") or {}).get("repair_stats") or {}
        if rs.get("sweep_vertices") is not None and rs.get("sweep_time"):
            v.append(rs["sweep_vertices"] / rs["sweep_time"])
    return sum(v) / len(v) if v else None
