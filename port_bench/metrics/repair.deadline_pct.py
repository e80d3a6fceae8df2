"""``repair.deadline_pct``: 100 x the windows whose repair the clock ended
(the program's counter ``ended_by == "deadline"``) over the windows
repaired (those with ``ended_by``), from ``repair_stats``."""


def read(run):
    ended = [((r.get("program") or {}).get("repair_stats") or {}).get("ended_by")
             for r in run.records]
    ended = [e for e in ended if e is not None]
    return 100.0 * ended.count("deadline") / len(ended) if ended else None
