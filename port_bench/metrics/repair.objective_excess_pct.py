"""``repair.objective_excess_pct``: over the judged windows, 100 x (summed objective
of the program's matchings - summed optimum of the assignment without the
tearing term) / that optimum, both worked out by the plain reference
(``reference/window.py``). At a fixed repair budget this is what the repair
and the separation deliver."""


def read(run):
    opt = run.extras.get("optimum_sum")
    if not opt:
        return None
    return 100.0 * (run.extras["objective_sum"] - opt) / opt
