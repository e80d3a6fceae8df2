"""``device_idle_pct``: 100 x (1 - the union of the device operations'
intervals / the traced window), both inside the calls' spans."""


def read(run):
    if run.timeline is None:
        return None
    w = run.timeline.window_s()
    return 100.0 * (1.0 - run.timeline.busy_s() / w) if w > 0 else None
