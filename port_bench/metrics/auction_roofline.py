"""``auction_roofline_pct``: the least time the auction solves of the calls
need for their bytes at the card's peak bandwidth (``roofline/auction.py``,
from the inputs' shapes as the plain reference finds them, once a solve),
over the auction kernels' device time, in percent."""

from port_bench.reference.window import problem_shapes
from port_bench.roofline import auction

AUCTION = ("auction_loop_kernel", "auction_loop_batch_kernel")


def read(run):
    if run.timeline is None:
        return None
    t = run.timeline.op_seconds(AUCTION)
    if t <= 0:
        return None
    floor = 0.0
    for k, inp in enumerate(run.inputs):
        launches = run.timeline.op_count(AUCTION, k)
        if launches:
            shapes = problem_shapes(*inp, run.ctx.config["optim_params"])
            floor += launches * auction.floor_seconds(*shapes)
    return 100.0 * floor / t
