"""``tear_kernels_us_per_round``: the profiler's device time of the rest of
the tear round, K2 ``tear_metrics`` (two kernels), K7 ``tear_scalars`` and
K8 ``register_cuts``, over the tear rounds run (the program's counter
``tear_rounds``), in microseconds."""

TEAR = ("tear_metrics_rows_kernel", "tear_metrics_tris_kernel",
        "tear_scalars_kernel", "register_cuts_kernel")


def read(run):
    if run.timeline is None:
        return None
    t = run.timeline.op_seconds(TEAR)
    rounds = sum((r.get("program") or {}).get("tear_rounds") or 0
                 for r in run.records)
    return 1e6 * t / rounds if t > 0 and rounds > 0 else None
