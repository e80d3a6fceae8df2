"""Microbenchmark of the auction bidding round on the card, split into parts.

The port's counterpart of ``examples/bench_pallas.py``, on the same random
instance (``np.random.default_rng(0)``, [n, C] = [12288, 8] by default, one
slot per ref):

  (a) a full bidding round: price gather, masked values, top-2, bid scatter
      (kernel K1 ``auction_bid``), with the plain PyTorch round beside it;
  (b) the ``prices[slots]`` gather alone;
  (c) the compute-only step (masked values, top-2, increments) on gathered
      prices, in plain PyTorch (``bid_compute_plain``);
  (d) the same compute-only step as kernel K9 ``bid_compute``, the port of
      the Pallas kernel.

Usage: python -m same_tpu_torch.microbench [--n 12288] [--c 8] [--iters 200]

Runs on the first CUDA card and raises without one (``--device cpu`` times
the plain versions on the CPU instead). Times are CUDA-event means over
``--iters`` calls after a warm-up.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .kernels.auction_bid import auction_bid, auction_bid_plain
from .kernels.bid_compute import bid_compute, bid_compute_plain
from .models.assignment import resolve_device


def instance(n: int, C: int, device):
    """examples/bench_pallas.py's instance, drawn in the same order."""
    S = n  # one slot per ref, LUAD-like
    rng = np.random.default_rng(0)
    costs = rng.uniform(0, 200, (n, C)).astype(np.float32)
    slots = rng.integers(0, S, (n, C)).astype(np.int32)
    valid = rng.random((n, C)) < 0.9
    nm = np.full(n, 10000.0, np.float32)
    prices = rng.uniform(0, 50, S + 1).astype(np.float32)

    def up(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return {
        "costs": up(costs, torch.float32), "slots": up(slots, torch.int32),
        "valid": up(valid, torch.bool), "nm": up(nm, torch.float32),
        "prices": up(prices, torch.float32),
        # A cold round: every bidder unassigned, every slot free.
        "assigned": torch.full((n,), -1, dtype=torch.int32, device=device),
        "owner": torch.full((S + 1,), -1, dtype=torch.int32, device=device),
    }


def timed(fn, iters: int, device) -> float:
    """Mean time of fn() over ``iters`` calls after one warm-up, in ms."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(n: int = 12288, C: int = 8, iters: int = 200, device=None) -> dict:
    """Time (a)-(d) on ``device`` (None: the first CUDA card); returns ms."""
    device = resolve_device(device)
    x = instance(n, C, device)
    bid = (x["costs"], x["slots"], x["valid"], x["nm"], x["prices"], x["assigned"],
           x["owner"], 1.0)
    p_slot = x["prices"][x["slots"].long()]
    step = (x["costs"], p_slot, x["valid"], x["nm"])
    return {
        "full_round_kernel": timed(lambda: auction_bid(*bid), iters, device),
        "full_round_plain": timed(lambda: auction_bid_plain(*bid), iters, device),
        "gather_only": timed(lambda: x["prices"][x["slots"].long()], iters, device),
        "compute_plain": timed(lambda: bid_compute_plain(*step), iters, device),
        "compute_kernel": timed(lambda: bid_compute(*step), iters, device),
    }


def report(results: dict, n: int, C: int, device) -> list:
    """The four rows, as printed."""
    device = torch.device(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    r = results
    return [
        f"n={n} C={C} device={name}",
        f"  (a) full_round: K1 auction_bid {r['full_round_kernel']:.4f} ms, "
        f"plain {r['full_round_plain']:.4f} ms",
        f"  (b) gather_only: {r['gather_only']:.4f} ms",
        f"  (c) compute_plain: {r['compute_plain']:.4f} ms",
        f"  (d) compute_kernel: K9 bid_compute {r['compute_kernel']:.4f} ms",
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=12288)
    ap.add_argument("--c", type=int, default=8)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = run(args.n, args.c, args.iters, device)
    for line in report(results, args.n, args.c, device):
        print(line, flush=True)
    return results


if __name__ == "__main__":
    main()
