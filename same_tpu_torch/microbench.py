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
      the Pallas kernel;
  (e) the barrier probe (``csrc/barrier_probe.cu``): us per barrier of an
      empty persistent loop, for the software grid barrier the auction loop
      used before its cluster design (113 and 33 co-resident blocks of 256
      threads: the LUAD window's grid and a grid window's) and for the
      hardware barrier of one thread-block cluster at several shapes, with
      the clusters of each shape the card holds at once.

Usage: python -m same_tpu_torch.microbench [--n 12288] [--c 8] [--iters 200]

Runs on the first CUDA card and raises without one (``--device cpu`` times
the plain versions on the CPU instead, and leaves out (e)). Times are CUDA-event
means over ``--iters`` calls after a warm-up; (e) times one launch of
``BARRIER_ROUNDS`` barriers after a warm-up launch.
"""

from __future__ import annotations

import argparse
import ctypes
import time

import numpy as np
import torch

from .kernels import _build
from .kernels.auction_bid import auction_bid, auction_bid_plain
from .kernels.auction_loop import cluster_shape
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


# (e): software barriers over these grids, cluster barriers at these
# (blocks, threads) shapes.
SOFT_GRIDS = (113, 33)
CLUSTER_SHAPES = ((8, 1024), (16, 512), (16, 1024))
BARRIER_ROUNDS = 4000


def _probe_lib():
    lib = _build.load("barrier_probe")
    if lib.same_probe_soft.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_probe_soft.restype = i
        lib.same_probe_soft.argtypes = [i, i, p, p]
        lib.same_probe_max_clusters.restype = i
        lib.same_probe_max_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.same_probe_cluster.restype = i
        lib.same_probe_cluster.argtypes = [i, i, i, p]
    return lib


def barrier_probe(device, rounds: int = BARRIER_ROUNDS) -> dict:
    """(e): us per barrier of each software grid and cluster shape, and the
    clusters of each shape the card holds at once."""
    lib = _probe_lib()
    bar = torch.zeros(2, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def one_launch_us(launch):
        _build.check(lib, launch(), "barrier probe")  # warm-up
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _build.check(lib, launch(), "barrier probe")
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / rounds

    blocks, threads, held = cluster_shape(device)
    out = {"rounds": rounds, "soft": {}, "cluster": {},
           "solve_shape": (blocks, threads), "solve_clusters_held": held}
    for g in SOFT_GRIDS:
        out["soft"][g] = one_launch_us(
            lambda: lib.same_probe_soft(g, rounds, bar.data_ptr(), stream))
    for blocks, threads in CLUSTER_SHAPES:
        held = ctypes.c_int(0)
        _build.check(lib, lib.same_probe_max_clusters(blocks, threads, ctypes.byref(held)),
                     "barrier probe (cluster query)")
        us = None
        if held.value > 0:
            us = one_launch_us(
                lambda: lib.same_probe_cluster(blocks, threads, rounds, stream))
        out["cluster"][(blocks, threads)] = {"us": us, "clusters_held": held.value}
    return out


def run(n: int = 12288, C: int = 8, iters: int = 200, device=None) -> dict:
    """Time (a)-(d) on ``device`` (None: the first CUDA card); returns ms."""
    device = resolve_device(device)
    x = instance(n, C, device)
    bid = (x["costs"], x["slots"], x["valid"], x["nm"], x["prices"], x["assigned"],
           x["owner"], 1.0)
    p_slot = x["prices"][x["slots"].long()]
    step = (x["costs"], p_slot, x["valid"], x["nm"])
    out = {
        "full_round_kernel": timed(lambda: auction_bid(*bid), iters, device),
        "full_round_plain": timed(lambda: auction_bid_plain(*bid), iters, device),
        "gather_only": timed(lambda: x["prices"][x["slots"].long()], iters, device),
        "compute_plain": timed(lambda: bid_compute_plain(*step), iters, device),
        "compute_kernel": timed(lambda: bid_compute(*step), iters, device),
    }
    if device.type == "cuda":
        out["barriers"] = barrier_probe(device)
    return out


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
        *barrier_rows(r.get("barriers")),
    ]


def barrier_rows(b) -> list:
    """(e) as printed."""
    if b is None:
        return []
    rows = [f"  (e) barriers, us per barrier over {b['rounds']} in one launch:"]
    for g, us in b["soft"].items():
        rows.append(f"      software grid barrier, {g} blocks x 256: {us:.3f} us")
    for (blocks, threads), c in b["cluster"].items():
        us = "does not fit" if c["us"] is None else f"{c['us']:.3f} us"
        rows.append(f"      cluster barrier, {blocks} blocks x {threads}: {us} "
                    f"({c['clusters_held']} clusters of the probe held at once)")
    blocks, threads = b["solve_shape"]
    rows.append(f"      the auction solve's cluster: {blocks} blocks x {threads}, "
                f"{b['solve_clusters_held']} held at once")
    return rows


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
