"""``aligned_per_s``: aligned metacells handed to the entry in the calls that
completed, over all the time of the calls (the window; inputs are made
between calls with the clock stopped)."""


def read(run):
    wall = sum(r["wall"] for r in run.records)
    done = sum(r["n_aligned"] for r in run.records if "error" not in r)
    return done / wall if wall > 0 and done else None
