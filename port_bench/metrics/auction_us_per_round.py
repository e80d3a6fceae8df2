"""``auction_us_per_round``: the profiler's device time of the auction
kernels over the bidding rounds they ran (the program's counter
``auction_rounds_total``), in microseconds."""

AUCTION = ("auction_loop_kernel", "auction_loop_batch_kernel")


def read(run):
    if run.timeline is None:
        return None
    t = run.timeline.op_seconds(AUCTION)
    rounds = sum((r.get("program") or {}).get("auction_rounds_total") or 0
                 for r in run.records)
    return 1e6 * t / rounds if t > 0 and rounds > 0 else None
