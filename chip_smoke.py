#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``same_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # the full check, about 7 minutes on an H100

Phases (any failure exits nonzero; no phase's exception is swallowed):

0. Require a CUDA card; print its name and ``nvidia-smi``'s name and power
   limit.
1. Build the kernels from ``same_tpu_torch/csrc`` with nvcc for sm_90a, one
   nvcc per source, all started together: ``auction_loop`` (one persistent
   launch per auction solve, the main path; its source also holds K5
   ``auction_loop_batch``, the same solve for a batch of windows), K1
   ``auction_bid`` (one bidding round on the same device bodies, the test
   entry), K2 ``tear_metrics`` (its source also holds K6
   ``tear_metrics_batch``), K3 ``radius_knn`` (the device kNN), K4
   ``sinkhorn_sparse`` (the Sinkhorn warm start), ``tear_round`` (K7
   ``tear_scalars`` and K8 ``register_cuts``, the rest of a tear round),
   K9 ``bid_compute`` (the Pallas microbenchmark's compute step) and K10
   ``sinkhorn_dense``.
2. Hold each kernel against its plain PyTorch version on the card, on the
   same inputs:
   - ``auction_loop`` against the plain Python loop on (a) the LUAD window
     cold from its warm-start prices at obj_patience 128, (b) the same
     window warm from (a)'s end state with a sparse 75.0 surcharge, as a
     tear round runs it, (c) the 144-point window and a 2,048-bidder random
     instance at obj_patience 0, (d) a solve cut at 50 rounds, so that the
     placement runs with bidders left unplaced. ``choice``, ``owner``,
     ``rounds``, ``phase`` and ``polish`` identical and ``prices`` bit-equal;
     at obj_patience 128 a difference passes only where the first round at
     which the control inputs diverge differs by the objective sum's
     rounding alone (relative 1e-6; the kernel sums in a fixed order that is
     not torch's), and it is printed. Median wall time of one solve (5
     solves after a warm-up) for both, rounds, us per round, the byte bound
     from the kernel's counters;
   - K1 at the Pallas microbenchmark's shape [12288, 8] and on the LUAD
     window, K2 on that window's triangles: integer outputs and prices
     bit-equal; median times over 60 runs;
   - K3 on the LUAD window's own coordinates (10,681 queries, 11,418 refs,
     k = 8, radius 250): ``idx`` and ``mask`` identical, ``dist`` bit-equal;
     and against the host cKDTree on the same input, within what the f32
     expansion |q|^2 + |r|^2 - 2 q.r allows at these coordinates (4 ulp of
     |q|^2 + |r|^2 on every squared distance, twice that between the two
     lists position by position); the rows whose lists differ are counted;
   - K4 on the LUAD problem ([12288, 24], 100 iterations): ``g`` within 1e-4
     of its largest magnitude and the plan within 1e-5 (the design is
     bit-equal but for CUDA's exp and log, which may be compiled another way
     into PyTorch; whether they came out bit-equal is printed);
   - one small window solved end to end on the card and on the CPU must
     give identical incumbents in both separation loops;
   - K7 ``tear_scalars`` at the LUAD window's round-0 state (its first
     auction solve and K2 at no surcharge): bit-equal to its plain version,
     the counts exact and the three float sums within 1e-6 relative of a
     float64 sum, the stop decisions of both identical; K8
     ``register_cuts`` on the same state, twice (the second round finds its
     cuts in memory), and on three synthetic windows with dp = 0.1
     surcharges on duplicate (vertex, column) targets, a column block
     clamped at C - 1, full dedup memories, and the per-round and total caps
     binding: ``cut_mem``, ``cut_cnt``, ``extra`` and the cuts added
     bit-equal to the plain version;
   - K9 ``bid_compute`` at [12288, 8] and [12288, 24] on the
     microbenchmark's instance: bit-equal to its plain version;
   - K10 ``sinkhorn_dense`` through ``same_tpu_torch.ops.sinkhorn`` (no
     ``device``) at [4096, 4096], eps 0.05, 200 iterations: finite, its
     largest error on f and g against a float64 run of the plain version at
     most twice the float32 plain version's, the plan's columns summing to
     their marginals.
7. The microbenchmark ``python -m same_tpu_torch.microbench`` at its
   defaults ([12288, 8], 200 iterations), in this process: its four rows,
   (a) a full bidding round by K1 and by the plain round, (b) the price
   gather, (c) the compute step in plain PyTorch and (d) by K9.
3. The slice: the LUAD-scale window of ``bench.py`` (25k cells a side, MS=3
   metacells) through ``same_tpu_torch.run_same`` on the card (no
   ``device`` argument), three times:
   - the main path, with bench.py's parameters (default repair budgets, as
     in the JAX record);
   - at a 65 s repair budget (the speculative thread's default) with the
     speculative repair off, so that the repair after separation runs (it
     must). The repair is an anytime search cut by the clock (ROADMAP C4):
     at 20 s its objective ranged over 31,522-39,789 in five runs on H100
     hosts of different speeds, past the 5 % gate on the slowest, so this
     run gets the speculative thread's default budget;
   - at a 20 s budget with the speculative repair on, the library default
     for a caller who sets only the budget. Once separation is fast its
     answer is a race between the two repairs (ROADMAP C8), so it is
     printed and held only to a valid answer.
   In each run ``auction_loop`` and K7 must have launched once per auction
   solve (a tear round), K8 once a round that registered cuts (every round
   but perhaps the last), K2 at least once, and the single-round K1 not at
   all; the first two runs print the split of a tear round, timed with CUDA
   events: the auction, K2, K7, K8 and the host's reads between them (the
   first beside the speculative repair thread, the second alone); the matching must
   be valid and the objective finite and not below the window's lower
   bound. In the first two, matches and flip fraction must sit within 1 %
   and 0.01 of the JAX package's record in BENCH_r05.json, and the
   objective at most 5 % (the window's mip_gap) above it.

4. The window grid: a tissue of ``examples/bench_grid.py::make_tissue`` at
   LUAD density over a quarter of its area (25k cells a side, MS=3 metacells,
   2 x 2 windows of about 3,000 aligned metacells, C = 24, dp = 25) through
   ``same_tpu_torch.sliding_window_matching`` on the card (no ``device``
   argument) and ``merge_window_matches_unique_ref``, three times:
   sequentially, with two windows in flight (the library default), and
   sequentially with ``init_method="sinkhorn"`` and ``SAME_TPU_KNN=tpu``, so
   that K3 and K4 run inside the slice. The three must give the same window
   ids and the same decomposition; in every window ``auction_loop`` and K7
   must have launched once per auction solve, K8 once a registering round,
   and K2 at least once, K1 never, and
   in the third run K3 and K4 once a window; every window's matching must be
   valid and its objective finite and not below its lower bound; the merged
   frame must hold each aligned and each ref id at most once; the pipelined
   run's incumbents before repair must equal the sequential run's, window by
   window, and the match counts after repair agree within 1 % (within 1 % of
   the first run's for the third, whose candidate sets differ).
6. The batched window solve, on phase 4's tissue:
   (f) ``sliding_window_matching(mesh=parallel.make_mesh())`` with phase 4's
   parameters, the counts from 0: K5 launched once a tear round of each
   batch (more only where a batch's blocks cannot all be co-resident), K6
   and K7 once a tear round, K8 once a round in which a window registered,
   no solo ``auction_loop`` or K2 launch but an eps-retry re-solve's; the
   split of a batched tear round, as in phase 3; the same window ids as phase 4's sequential run, merged
   matches within 1 % + 2 of it and merged-pair agreement at least 0.90
   (tests/test_windows_sharded.py's gate: each solve gets the batch's round
   budget, so the incumbents differ); every window a valid matching at or
   above its lower bound. Then on the windows of its largest batch:
   (a) K5 cold on the full schedule at the batch's budget against one solo
   ``auction_loop`` launch a window and against its plain version, (b) K5
   against its plain version on three 144-point windows, (c) K5 on more
   copies of the LUAD window than one launch holds, and on two copies of a
   window wider than the batch kernel's co-resident grid (73,728 slots),
   each copy against a solo launch, (d) K6 against one K2
   launch a window and against its plain version, K7 and K8 on the same
   stack against their plain versions and K7 against each window alone
   (unpadded), all bit-equal; (e) each
   batch of (f) against ``run_tearing_device`` window by window given the
   batch's budget and schedule length: identical incumbents before repair
   and cut registries. Times of K5 (beside the solo launches) and K6, their
   plain versions and their byte bounds.
5. Only with ``--synthetic`` (its repair runs for minutes at the default
   budget of a window this small): the paper's synthetic tissue (seed 8899,
   372 query cells, the host separation loop for windows under 512 points)
   through ``same_tpu_torch.run_same`` with ``examples/run_synthetic.py``'s
   parameters; matches, accuracy and flipped triangles are printed beside
   the JAX package's quality record and held to a valid answer.

Prints the kernel table as one JSON line, then the nvidia-smi line, then as
the last line ``{"ok": true, "device": {...}}``. Debugging options, each
ending with ``"ok": false`` and exit code 2: ``--cells N`` shrinks the LUAD
window (the anchor check then does not apply), ``--no-slice`` stops after
phases 2 and 7, ``--grid-only`` runs phases 0-1, the K3 and K4 checks and
phases 4 and 6.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LUAD_CELLS = 25000
# The JAX package's answer on this window (BENCH_r05.json, TPU v5e run).
ANCHOR_FILE = "BENCH_r05.json"
OPTIM = dict(
    max_matches=1, radius=250, knn=8, no_match_penalty=10000,
    dist_ct_coeff=1, penalty_coeff=100, delaunay_penalty=25.0,
    cell_id_col="metacell_id", ref_metacell_match_multiplier=3,
)
# bench.py's solver parameters, the JAX record's own: the repair budgets are
# the library defaults.
SOLVER = dict(
    mip_gap=0.05, lazy_allowed_flip_fraction=0.05,
    tpu_tear_plateau_tol=1e-4, tpu_auction_patience=128,
)
# Phase 3's settings: (label, solver parameters, held to the JAX record). At
# a 20 s budget with the speculative repair on, separation now ends soon
# after the speculative snapshot; that repair then runs alone from an early
# incumbent, can win the ranking, and the final repair is skipped, so the
# answer depends on which repair wins (ROADMAP C8).
SLICE_RUNS = (
    ("bench.py parameters", SOLVER, True),
    ("65 s repair budget, speculative repair off",
     dict(SOLVER, tpu_repair_budget=65, tpu_speculative_repair=False), True),
    ("20 s repair budget, speculative repair on",
     dict(SOLVER, tpu_repair_budget=20), False),
)


# Phase 4: bench_grid.py::run_grid's parameters on a quarter of its tissue. A
# 6,750-unit window over the 13,000-unit extent gives 2 x 2 solvable windows
# of about 3,000 aligned metacells: the fused loop (n >= 512) without the
# speculative repair (n <= 6144). The default repair budget at this size is
# 450 s; the smoke gives the repair after separation a few seconds.
GRID_CELLS = 25000
GRID_EXTENT = 13000.0
GRID_OPTIM = dict(OPTIM, window_size=6750, overlap=250, min_cells_per_window=30)
GRID_REPAIR_BUDGET_S = 4.0
GRID_SOLVER = dict(SOLVER, tpu_repair_budget=GRID_REPAIR_BUDGET_S)
GRID_RUNS = (
    ("sequential", dict(GRID_SOLVER, tpu_pipeline_windows=1), False),
    ("pipelined, 2 windows in flight", dict(GRID_SOLVER, tpu_pipeline_windows=2), False),
    ("sequential, Sinkhorn start + device kNN",
     dict(GRID_SOLVER, tpu_pipeline_windows=1, init_method="sinkhorn"), True),
)
# H100 SXM peak f32 rate outside the tensor cores (NVIDIA's data sheet).
F32_FLOP_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=60, warmup=3):
    """Median CUDA-event time of fn() over ``reps`` calls, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def first_diff(a, b):
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    idx = (a != b).nonzero()
    return None if idx.numel() == 0 else tuple(int(v) for v in idx[0])


def require_equal(name, a, b):
    """Bit-equality of two tensors; on a miss name the first differing index."""
    require(a.shape == b.shape, f"{name}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
    d = first_diff(a, b)
    if d is not None:
        raise SmokeFailure(
            f"{name}: kernel and twin differ first at index {d}: "
            f"{a[d].item()} vs {b[d].item()}"
        )


# ----------------------------------------------------------------------------
# Phase 0 / 1
# ----------------------------------------------------------------------------

def phase0():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name}; count {torch.cuda.device_count()}")
    log(f"[phase 0] nvidia-smi: {smi_line}")
    return name, smi_line


# The kernels' sources (one nvcc each) and their wrappers: K5
# ``auction_loop_batch`` is in auction_loop.cu, K6 ``tear_metrics_batch`` in
# tear_metrics.cu, K7 ``tear_scalars`` and K8 ``register_cuts`` in
# tear_round.cu.
SOURCES = ("auction_loop", "auction_bid", "tear_metrics", "radius_knn",
           "sinkhorn_sparse", "tear_round", "bid_compute", "sinkhorn_dense")
KERNELS = ("auction_loop", "auction_bid", "tear_metrics", "radius_knn",
           "sinkhorn_sparse", "auction_loop_batch", "tear_metrics_batch",
           "tear_scalars", "register_cuts", "bid_compute", "sinkhorn_dense")


def phase1():
    from concurrent.futures import ThreadPoolExecutor

    from same_tpu_torch.kernels import _build

    def build(name):
        t0 = time.time()
        _build.load(name)
        return time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        took = dict(zip(SOURCES, pool.map(build, SOURCES)))
    log(f"[phase 1] built {', '.join(SOURCES)} in parallel in "
        f"{time.time() - t0:.1f}s ({os.path.relpath(_build.BUILD_DIR, HERE)})")
    for name in SOURCES:
        log(f"[phase 1] {name}: {took[name]:.1f}s")
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[phase 1]   {line.strip()}")


# H100 SXM device memory rate (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(nbytes):
    """Least time to move ``nbytes`` once through device memory, in ms."""
    return nbytes / HBM_BYTES_PER_S * 1e3


# ----------------------------------------------------------------------------
# Phase 2: kernels against their twins
# ----------------------------------------------------------------------------

def consistent_state(rng, slots, valid, C, S, frac_held=0.5):
    """Random assigned/owner pair in which each held slot has one owner."""
    n = slots.shape[0]
    assigned = np.full(n, -1, np.int32)
    owner = np.full(S + 1, -1, np.int32)
    for b in rng.permutation(n):
        r = rng.random()
        if r < frac_held:
            cols = np.flatnonzero(valid[b])
            rng.shuffle(cols)
            for k in cols:
                s = slots[b, k]
                if owner[s] < 0:
                    owner[s] = b
                    assigned[b] = k
                    break
        elif r < frac_held + 0.1:
            assigned[b] = C
    return assigned, owner


def compare_k1(tag, costs, slots, valid, nm, prices, assigned, owner, eps, rounds):
    """Run ``rounds`` chained bidding rounds with K1 and with the twin."""
    import torch

    from same_tpu_torch.kernels.auction_bid import auction_bid, auction_bid_plain

    st_k = (prices, assigned, owner)
    st_p = (prices, assigned, owner)
    err = 0.0
    for r in range(rounds):
        k = auction_bid(costs, slots, valid, nm, st_k[0], st_k[1], st_k[2], eps)
        p = auction_bid_plain(costs, slots, valid, nm, st_p[0], st_p[1], st_p[2], eps)
        torch.cuda.synchronize()
        for field in ("new_assigned", "new_owner", "newp", "moved"):
            require_equal(f"K1 {tag} round {r} {field}", getattr(k, field), getattr(p, field))
        err = max(err, float((k.newp - p.newp).abs().max()))
        st_k = (k.newp, k.new_assigned, k.new_owner)
        st_p = (p.newp, p.new_assigned, p.new_owner)
    t_k = median_ms(lambda: auction_bid(costs, slots, valid, nm, prices, assigned, owner, eps))
    t_p = median_ms(lambda: auction_bid_plain(costs, slots, valid, nm, prices, assigned, owner, eps))
    n, C = costs.shape
    S1 = prices.shape[0]
    active = int(((assigned < 0) | (assigned == C)).sum())
    # Each input read once, each output written once: the active bidders'
    # rows (cost, slot, valid) and no-match costs, the [n] and [S+1]
    # vectors, and the new assignments, owners, prices and moved flag.
    nbytes = 9 * C * active + 4 * active + 4 * n + 8 * S1 + 4 * n + 8 * S1 + 4
    b_ms = bound_ms(nbytes)
    log(f"[phase 2] K1 {tag}: [n, C] = {list(costs.shape)}, S+1 = {S1}, "
        f"{active} active bidders, {rounds} chained rounds bit-equal; "
        f"kernel {t_k:.4f} ms, twin {t_p:.4f} ms (median of 60); "
        f"bound {nbytes / 1e6:.3f} MB = {b_ms * 1e3:.3f} us")
    return err, t_k, t_p, b_ms


def phase2_k1_random(device):
    import torch

    rng = np.random.default_rng(0)
    n, C = 12288, 8
    S = n  # one slot per ref, as in examples/bench_pallas.py
    costs = rng.uniform(0, 200, (n, C)).astype(np.float32)
    slots = rng.integers(0, S, (n, C)).astype(np.int32)
    valid = rng.random((n, C)) < 0.9
    nm = np.full(n, 10000.0, np.float32)
    prices = rng.uniform(0, 50, S + 1).astype(np.float32)
    prices[S] = 0.0
    assigned, owner = consistent_state(rng, slots, valid, C, S)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return compare_k1(
        "random [12288, 8]", t(costs, torch.float32), t(slots, torch.int32),
        t(valid, torch.bool), t(nm, torch.float32), t(prices, torch.float32),
        t(assigned, torch.int32), t(owner, torch.int32), 1.0, rounds=20,
    )


def phase2_window(pw, device):
    """K1 and K2 on the LUAD window's own problem and triangles."""
    import torch

    from same_tpu_torch.kernels.tear_metrics import tear_metrics, tear_metrics_plain
    from same_tpu_torch.models.assignment import to_device
    from same_tpu_torch.solver.auction import solve_assignment

    prob = pw.problem
    pd = to_device(prob, device)
    n, C = prob.costs.shape
    S = prob.n_slots
    prices0 = torch.as_tensor(pw.prices0, dtype=torch.float32).to(device)
    eps = float(np.float32(pw.eps_solver))
    # Cold state: every bidder active, the first round of a solve.
    cold_assigned = torch.full((n,), -1, dtype=torch.int32, device=device)
    cold_owner = torch.full((S + 1,), -1, dtype=torch.int32, device=device)
    k1 = compare_k1(
        "LUAD window, cold", pd.costs, pd.slots, pd.valid, pd.nm_cost, prices0,
        cold_assigned, cold_owner, eps, rounds=30,
    )

    # One auction solve on the card gives the choice and prices for K2.
    t0 = time.time()
    res = solve_assignment(
        pd, eps_final=pw.eps_solver, prices0=pw.prices0, return_raw=True,
        obj_patience=128,
    )
    torch.cuda.synchronize()
    log(f"[phase 2] auction solve on the window: {res.rounds} bidding rounds, "
        f"{time.time() - t0:.2f}s wall")
    # Late state: the solve's own end state, where few bidders still bid.
    compare_k1(
        "LUAD window, end of solve", pd.costs, pd.slots, pd.valid, pd.nm_cost,
        res.prices, res.choice, res.owner, eps, rounds=5,
    )

    T = len(pw.tris)
    rng = np.random.default_rng(1)
    extra_np = np.zeros((n, C), np.float32)
    hit = rng.random((n, C)) < 0.01
    extra_np[hit] = 75.0
    extra = torch.as_tensor(extra_np).to(device)
    args = (
        pd.costs, extra, pd.slots, pd.valid, pd.nm_cost, pd.pair_idx,
        pd.cand_ref,
        torch.as_tensor(np.ascontiguousarray(pw.tris), dtype=torch.int32).to(device),
        torch.ones(T, dtype=torch.bool, device=device),
        torch.as_tensor(np.ascontiguousarray(pw.source_signs, np.int32)).to(device),
        torch.as_tensor(np.ascontiguousarray(pw.ref_coords, np.float32)).to(device),
        res.prices, res.choice,
    )
    out_k = tear_metrics(*args)
    out_p = tear_metrics_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("checked", "flipped", "vmove"), out_k, out_p):
        require_equal(f"K2 {name}", a, b)
    k2_err = max(float((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                 for a, b in zip(out_k, out_p))
    t_k = median_ms(lambda: tear_metrics(*args))
    t_p = median_ms(lambda: tear_metrics_plain(*args))
    # Each input read once and each output written once.
    nbytes = tensor_bytes(*args, *out_k)
    b_ms = bound_ms(nbytes)
    log(f"[phase 2] K2 LUAD window: T = {T}, [n, C] = [{n}, {C}], "
        f"{int(out_k[0].sum())} checked, {int(out_k[1].sum())} flipped; bit-equal; "
        f"kernel {t_k:.4f} ms, twin {t_p:.4f} ms (median of 60); "
        f"bound {nbytes / 1e6:.3f} MB = {b_ms * 1e3:.3f} us")
    return k1, (k2_err, t_k, t_p, b_ms), res


def phase2_knn(mc_ref, mc_align, device, smi_line):
    """K3 on the LUAD window's coordinates: against its plain version (bit
    for bit) and against the host cKDTree (within the f32 expansion)."""
    import torch

    from same_tpu_torch.candidates import radius_knn as radius_knn_host
    from same_tpu_torch.kernels.radius_knn import radius_knn, radius_knn_plain

    k, radius = OPTIM["knn"], float(OPTIM["radius"])
    q64 = mc_align.metacell_df[["X", "Y"]].to_numpy(dtype=np.float64)
    r64 = mc_ref.metacell_df[["X", "Y"]].to_numpy(dtype=np.float64)
    q = torch.as_tensor(np.ascontiguousarray(q64, dtype=np.float32)).to(device)
    r = torch.as_tensor(np.ascontiguousarray(r64, dtype=np.float32)).to(device)
    n, m = len(q64), len(r64)
    out_k = radius_knn(q, r, radius, k)
    out_p = radius_knn_plain(q, r, radius, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("idx", "dist", "mask"), out_k, out_p):
        require_equal(f"K3 {name}", a, b)
    finite = out_k[2]
    err = float((out_k[1][finite] - out_p[1][finite]).abs().max())

    # Against the exact answer: each squared distance the kernel reports is
    # within 4 ulp of |q|^2 + |r|^2 of the exact one (the expansion's
    # rounding), and position by position its list is within twice that of
    # the cKDTree's, whose candidates are exact. A slot only one of them
    # fills lies that close to the radius.
    idx_k, dist_k, mask_k = (t.cpu().numpy() for t in out_k)
    idx_h, dist_h, mask_h = radius_knn_host(q64, r64, radius, k, backend="host")
    q32, r32 = q64.astype(np.float32).astype(np.float64), r64.astype(np.float32).astype(np.float64)
    got = r32[np.clip(idx_k, 0, None)]
    exact2 = ((q32[:, None, :] - got) ** 2).sum(-1)
    tol = 4 * 2.0 ** -23 * ((q32 ** 2).sum(1)[:, None] + (got ** 2).sum(-1))
    rep2 = dist_k.astype(np.float64) ** 2
    bad = mask_k & (np.abs(np.where(mask_k, rep2, 0.0) - exact2) > tol)
    require(not bad.any(), f"K3: {int(bad.sum())} squared distances off the exact ones "
            f"by more than 4 ulp of |q|^2 + |r|^2")
    host2 = np.where(mask_h, dist_h, radius) ** 2
    kern2 = np.where(mask_k, exact2, radius ** 2)
    both = mask_k | mask_h
    far = both & (np.abs(kern2 - host2) > 2 * tol)
    require(not far.any(), f"K3: {int(far.sum())} list entries further from the cKDTree's "
            f"than the expansion allows")
    rows = int(((idx_k != idx_h) & both).any(axis=1).sum())
    edge = int((mask_k != mask_h).sum())
    filled = mask_k & mask_h
    dd = float(np.abs(dist_k[filled] - dist_h[filled]).max()) if filled.any() else 0.0

    t_k = median_ms(lambda: radius_knn(q, r, radius, k), reps=30)
    t_p = median_ms(lambda: radius_knn_plain(q, r, radius, k), reps=3, warmup=1)
    nbytes = tensor_bytes(q, r, *out_k)
    flops = 8.0 * n * m  # per pair: 3 mul, 3 add/sub, the clamp and the test
    b_bytes, b_ops = bound_ms(nbytes), flops / F32_FLOP_PER_S * 1e3
    log(f"[phase 2] K3 LUAD window: {n} queries, {m} refs, k = {k}, radius {radius:g}; "
        f"idx, mask, dist bit-equal to the plain version; against the cKDTree {rows} rows "
        f"differ ({edge} slots filled by one only, largest distance gap {dd:.4f}, all "
        f"within 4 ulp of |q|^2+|r|^2 = {float(tol.max()):.1f} units^2 at most); "
        f"kernel {t_k:.4f} ms (median of 30), plain {t_p:.3f} ms (median of 3); bound "
        f"{flops / 1e9:.3f} GFLOP / 67 TFLOP/s = {b_ops * 1e3:.2f} us (operations; bytes "
        f"{nbytes / 1e6:.3f} MB = {b_bytes * 1e3:.2f} us); {smi_line}")
    return {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "rows_differing_from_ckdtree": rows}


def phase2_sinkhorn(pw, device, smi_line):
    """K4 on the LUAD window's problem against its plain version."""
    import torch

    from same_tpu_torch.kernels.sinkhorn_sparse import (
        sinkhorn_sparse, sinkhorn_sparse_plain,
    )

    prob = pw.problem
    n, K = prob.costs.shape
    iters = 100

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    args = (up(prob.costs, torch.float32),
            up(np.clip(np.asarray(prob.cand_ref), 0, None), torch.int32),
            up(prob.valid, torch.bool), up(prob.nm_cost, torch.float32))
    kw = dict(n_ref=int(prob.n_ref), eps=1.0, n_iters=iters)
    plan_k, g_k = sinkhorn_sparse(*args, **kw)
    plan_p, g_p = sinkhorn_sparse_plain(*args, **kw)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(g_k).all()) and bool(torch.isfinite(plan_k).all()),
            "K4: the duals or the plan are not finite")
    g_err = float((g_k - g_p).abs().max())
    p_err = float((plan_k - plan_p).abs().max())
    g_scale = max(1.0, float(g_p.abs().max()))
    exact = first_diff(g_k, g_p) is None and first_diff(plan_k, plan_p) is None
    require(g_err <= 1e-4 * g_scale, f"K4: g off the plain version by {g_err} "
            f"(allowed 1e-4 x {g_scale})")
    require(p_err <= 1e-5, f"K4: plan off the plain version by {p_err} (allowed 1e-5)")
    row_err = float((plan_k.sum(1) - 1.0).abs().max())
    require(row_err <= 1e-4, f"K4: a plan row sums to 1 +- {row_err}")
    require(bool((plan_k[prob.n_aligned:, K] == 1.0).all()),
            "K4: a padded row sent mass elsewhere than to the sink")
    t_k = median_ms(lambda: sinkhorn_sparse(*args, **kw), reps=20, warmup=2)
    t_p = median_ms(lambda: sinkhorn_sparse_plain(*args, **kw), reps=2, warmup=0)
    entries = int(prob.valid.sum()) + n
    nbytes = tensor_bytes(*args, plan_k, g_k)
    # Per entry and pass: the logit (2), the maximum (1), exp of the shifted
    # logit into the sum (3) and exp into the plan (2).
    flops = 8.0 * entries * (iters + 1)
    b_bytes, b_ops = bound_ms(nbytes), flops / F32_FLOP_PER_S * 1e3
    log(f"[phase 2] K4 LUAD window: [n, K] = [{n}, {K}], n_ref = {prob.n_ref}, "
        f"{entries - n} valid candidates, {iters} iterations ({2 * iters + 1} launches a "
        f"call); against the plain version: "
        f"{'bit-equal' if exact else 'not bit-equal'}, max |g| gap {g_err:.3g} of "
        f"{g_scale:.4g} (allowed 1e-4 of it), plan gap {p_err:.3g} (allowed 1e-5); "
        f"kernel {t_k:.4f} ms (median of 20), plain {t_p:.2f} ms (median of 2); bound "
        f"{flops / 1e9:.4f} GFLOP / 67 TFLOP/s = {b_ops * 1e3:.2f} us (operations; bytes "
        f"{nbytes / 1e6:.3f} MB = {b_bytes * 1e3:.2f} us); {smi_line}")
    return {"err": max(g_err, p_err), "ms": t_k, "plain_ms": t_p,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes",
            "bit_equal": exact}


def small_window_problem(seed=7):
    """The 144-point window: a jittered 12x12 grid with swapped features."""
    from same_tpu_torch.candidates import radius_knn
    from same_tpu_torch.geometry import delaunay_simplices, orientation_signs_np
    from same_tpu_torch.models.assignment import build_assignment_problem

    rng = np.random.default_rng(seed)
    side = 12
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1).reshape(-1, 2).astype(float)
    ref_xy = g + rng.normal(0, 0.05, g.shape)
    qry_xy = g + rng.normal(0, 0.05, g.shape)
    n = len(g)
    feat = np.arange(n)
    for s in range(0, n - 1, 9):  # swapped feature identities force flips
        feat[s], feat[s + 1] = feat[s + 1], feat[s]
    idx, dist, mask = radius_knn(qry_xy, ref_xy, radius=2.5, k=4)
    pairs, costs = [], []
    for i in range(n):
        for j, d in zip(idx[i][mask[i]], dist[i][mask[i]]):
            pairs.append((i, int(j)))
            costs.append((0.0 if feat[i] == j else 20.0) + 0.1 * float(d))
    pairs, costs = np.asarray(pairs), np.asarray(costs)
    tris = delaunay_simplices(qry_xy)
    src = orientation_signs_np(qry_xy, tris)
    w = np.full(len(tris), 3.0)
    nm = np.full(n, 100.0)
    prob = build_assignment_problem(pairs, costs, n, n, np.ones(n, int), 100.0, nm)
    return prob, costs, tris, w, src, ref_xy


def phase2_small_window(device):
    """One small window solved on the card and on the CPU twins: identical."""
    import torch

    from same_tpu_torch.solver import tearing

    prob, costs, tris, w, src, ref_xy = small_window_problem()
    n = prob.n_aligned
    captured = {}
    orig = tearing._finish_solve

    def spy(*a, **k):
        captured["inc"] = a[10]
        return orig(*a, **k)

    tearing._finish_solve = spy
    try:
        for loop in (False, "force"):
            out = {}
            for dev in (device, torch.device("cpu")):
                res = tearing.solve_with_tearing(
                    prob, costs, tris, w, src, ref_xy, delaunay_penalty=5.0,
                    penalty_coeff=100.0, allowed_flip_fraction=0.0,
                    eps_final=1e-3, device_loop=loop, repair_budget=60.0,
                    device=dev,
                )
                out[dev.type] = (res, captured.pop("inc"))
            (rc, ic), (rp, ip) = out["cuda"], out["cpu"]
            require(len(ic) == len(ip), f"small window ({loop}): tear rounds differ")
            for r, (a, b) in enumerate(zip(ic, ip)):
                for k, name in ((0, "match_ref"), (2, "flipped"), (3, "checked")):
                    require(np.array_equal(a[k], b[k]),
                            f"small window ({loop}) round {r}: {name} differs")
                require(a[5] == b[5], f"small window ({loop}) round {r}: auction rounds differ")
            require(abs(rc.objective - rp.objective) <= 1e-6 * abs(rp.objective),
                    f"small window ({loop}): objective {rc.objective} vs {rp.objective}")
            log(f"[phase 2] small window n={n} ({'fused' if loop else 'host'} loop): "
                f"card == CPU twins over {len(ic)} tear rounds, objective {rc.objective:.4f}")
    finally:
        tearing._finish_solve = orig


def loop_bytes(n, C, S, Ps, stats, start_bytes):
    """Byte bound of one auction solve, from the kernel's device counters.

    What the solve needs, each byte counted once where it is needed:
    - the caller's start state read once (``start_bytes``: prices, and the
      assignments and owners when given) and the outputs written once
      (choice, prices, owners);
    - each round, one read of the [n] assignments (which bidders bid);
    - each active bidder in each round, its row: cost, slot id, valid flag
      and one price gather per column (13 B x C) and its no-match cost;
    - each slot that got a bid, in that round: its key (8 B), its old
      owner, new price, new owner and the winner's assignment (4 B each);
    - each boundary round, the rows of the holders its release reads, and
      4 reverse drains over every row and the [S, Ps] slot lists (8 B an
      entry);
    - the rows of the bidders still unplaced at the loop's end.
    Not counted, because they are the implementation's and not the
    function's: the bid-column scratch, the keys of slots without a bid,
    the whole price and owner vectors each round, and the per-round
    objective's cost reads (a running sum over the changes would do).
    """
    row = 13 * C + 4
    io = start_bytes + 4 * n + 8 * (S + 1)
    rounds = (4 * n * stats["rounds"] + row * stats["active_bidder_rounds"]
              + 24 * stats["resolved_slot_rounds"])
    boundary = (row * stats["released_rows_read"]
                + stats["boundary_rounds"] * 4 * (row * n + 8 * S * Ps))
    return io + rounds + boundary + row * stats["unplaced_at_exit"]


def wall_ms(fn, reps=5):
    """Median host-clock time of fn() ending in a synchronize, after one
    warm-up call, in ms."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def compare_loop(tag, pd, costs, prices0, sched, patience, max_rounds=500000,
                 assigned0=None, owner0=None, smi_line=""):
    """One auction solve by ``auction_loop`` and by its plain loop on the card."""
    import importlib

    import torch

    from same_tpu_torch.solver.auction import natural_stop_args

    tal = importlib.import_module("same_tpu_torch.kernels.auction_loop")
    dev = costs.device
    n, C = costs.shape
    S, Ps = pd.slot_rows.shape
    obj = natural_stop_args(n, float(sched[-1]), patience)
    args = (costs, pd.slots, pd.valid, pd.nm_cost, prices0, sched, max_rounds)
    kw = dict(assigned0=assigned0, owner0=owner0, slot_rows=pd.slot_rows,
              slot_cols=pd.slot_cols, obj_patience=obj[0], obj_tol=obj[1],
              obj_band=obj[2])
    trace_k = torch.zeros((max_rounds, 2), dtype=torch.float32, device=dev)
    inputs = [t for t in (prices0, assigned0, owner0) if t is not None]
    before = [t.clone() for t in inputs]
    k = tal.auction_loop(*args, trace=trace_k, **kw)
    stats = dict(tal.auction_loop.last_stats)
    trace_p = []
    step = tal._control_step

    def spy(ctl, moved, cur_obj, *a):
        trace_p.append((moved, cur_obj))
        return step(ctl, moved, cur_obj, *a)

    tal._control_step = spy
    try:
        p = tal.auction_loop_plain(*args, **kw)
    finally:
        tal._control_step = step
    torch.cuda.synchronize()
    for t, b in zip(inputs, before):
        require_equal(f"auction_loop {tag}: an input was written", t, b)
    same = (k.rounds, k.phase, k.polish) == (p.rounds, p.phase, p.polish) and all(
        first_diff(getattr(k, f), getattr(p, f)) is None for f in ("choice", "owner", "prices")
    )
    err = float((k.prices - p.prices).abs().max())
    if same:
        verdict = "identical, prices bit-equal"
    else:
        tk = trace_k[: k.rounds].cpu().numpy()
        r = next(
            (i for i in range(min(len(tk), len(trace_p)))
             if (tk[i, 0] != 0) != trace_p[i][0]
             or np.float32(tk[i, 1]).view(np.int32)
             != np.float32(trace_p[i][1]).view(np.int32)),
            None,
        )
        log(f"[phase 2] auction_loop {tag}: kernel rounds/phase/polish "
            f"{k.rounds}/{k.phase}/{k.polish}, plain {p.rounds}/{p.phase}/{p.polish}")
        if r is None:
            raise SmokeFailure(
                f"auction_loop {tag}: results differ although every round's control "
                f"inputs agree (first output difference: choice "
                f"{first_diff(k.choice, p.choice)}, owner {first_diff(k.owner, p.owner)}, "
                f"prices {first_diff(k.prices, p.prices)})")
        obj_k, obj_p = np.float32(tk[r, 1]), np.float32(trace_p[r][1])
        rel = abs(float(obj_k) - float(obj_p)) / max(abs(float(obj_p)), 1e-30)
        log(f"[phase 2] auction_loop {tag}: control inputs diverge first at round {r}: "
            f"moved {bool(tk[r, 0])} vs {trace_p[r][0]}, cur_obj {float(obj_k)!r} (kernel, "
            f"fixed-order sum) vs {float(obj_p)!r} (torch sum), relative {rel:.3g}")
        rounding_only = (
            patience > 0 and (tk[r, 0] != 0) == trace_p[r][0]
            and np.isfinite(obj_k) and np.isfinite(obj_p) and rel <= 1e-6
        )
        if not rounding_only:
            for f in ("choice", "owner", "prices"):
                require_equal(f"auction_loop {tag} {f}", getattr(k, f), getattr(p, f))
            raise SmokeFailure(f"auction_loop {tag}: rounds/phase/polish differ")
        verdict = f"diverged at round {r} by the objective sum's rounding alone"
    t_k = wall_ms(lambda: tal.auction_loop(*args, **kw))
    t_p = wall_ms(lambda: tal.auction_loop_plain(*args, **kw))
    nbytes = loop_bytes(n, C, S, Ps, stats, tensor_bytes(*inputs))
    b_ms = bound_ms(nbytes)
    unplaced = int((k.choice == C).sum())
    log(f"[phase 2] auction_loop {tag}: [n, C] = [{n}, {C}], S = {S}, patience {patience}; "
        f"{verdict}; {k.rounds} rounds ({stats['boundary_rounds']} boundary, "
        f"{stats['active_bidder_rounds']} active bidder-rounds, "
        f"{stats['resolved_slot_rounds']} resolved slot-rounds), phase {k.phase}, "
        f"polish {k.polish}, {stats['unplaced_at_exit']} unplaced at the loop's end, "
        f"{unplaced} on no-match, grid {stats['grid']} blocks; "
        f"kernel {t_k:.3f} ms = {1e3 * t_k / max(k.rounds, 1):.2f} us/round, "
        f"plain {t_p:.3f} ms = {1e3 * t_p / max(p.rounds, 1):.2f} us/round (median of 5); "
        f"bound {nbytes / 1e6:.2f} MB = {b_ms:.4f} ms; {smi_line}")
    return k, {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms,
               "rounds": k.rounds, "unplaced_at_exit": stats["unplaced_at_exit"]}


def random_problem(nq, m, seed=3):
    """``nq`` bidders with 8 random candidates each among ``m`` unit slots,
    costs uniform in [0, 100), no-match cost 150."""
    from same_tpu_torch.models.assignment import build_assignment_problem

    rng = np.random.default_rng(seed)
    cand = np.stack([rng.choice(m, 8, replace=False) for _ in range(nq)])
    pairs = np.stack([np.repeat(np.arange(nq), 8), cand.ravel()], 1)
    return build_assignment_problem(
        pairs, rng.uniform(0, 100, len(pairs)), nq, m, np.ones(m, int), 100.0,
        np.full(nq, 150.0))


def phase2_loop(pw, device, smi_line):
    """auction_loop against its plain loop: cases (a)-(d)."""
    import torch

    from same_tpu_torch.models.assignment import to_device
    from same_tpu_torch.solver.auction import (
        SCHEDULE_LEN, default_eps_schedule, warm_eps_schedule,
    )

    prob = pw.problem
    pd = to_device(prob, device)
    eps = pw.eps_solver
    # solve_assignment's schedule for a warm price start, padded.
    sched = np.asarray([eps * 64, eps * 8, eps], np.float32)
    sched = np.concatenate([sched, np.full(SCHEDULE_LEN - 3, sched[-1], np.float32)])
    prices0 = torch.as_tensor(pw.prices0, dtype=torch.float32).to(device)
    out = {}
    res_a, out["a"] = compare_loop(
        "(a) LUAD window, cold", pd, pd.costs, prices0, sched, 128, smi_line=smi_line)

    rng = np.random.default_rng(1)
    n, C = prob.costs.shape
    extra = np.zeros((n, C), np.float32)
    extra[rng.random((n, C)) < 0.01] = 75.0
    finite = prob.costs[prob.valid]
    cost_scale = max(float(np.max(prob.nm_cost, initial=0.0)),
                     float(finite.max() - finite.min()))
    _, out["b"] = compare_loop(
        "(b) LUAD window, warm + 75.0 surcharge", pd,
        pd.costs + torch.as_tensor(extra).to(device), res_a.prices,
        warm_eps_schedule(eps, 75.0, cost_scale), 128,
        assigned0=res_a.choice, owner0=res_a.owner, smi_line=smi_line)

    small = small_window_problem()[0]
    pds = to_device(small, device)
    _, out["c_small"] = compare_loop(
        "(c) 144-point window", pds, pds.costs,
        torch.zeros(small.n_slots + 1, dtype=torch.float32, device=device),
        default_eps_schedule(small, 1e-3), 0, smi_line=smi_line)

    # 2,048 bidders with 8 random candidates each among 3,072 unit slots:
    # about 600 rounds to the fixed point.
    rand = random_problem(2048, 3072)
    pdr = to_device(rand, device)
    _, out["c_random"] = compare_loop(
        "(c) random 2048 bidders", pdr, pdr.costs,
        torch.zeros(rand.n_slots + 1, dtype=torch.float32, device=device),
        default_eps_schedule(rand, 0.05), 0, max_rounds=20000, smi_line=smi_line)

    _, out["d"] = compare_loop(
        "(d) LUAD window, cut at 50 rounds", pd, pd.costs, prices0, sched, 0,
        max_rounds=50, smi_line=smi_line)
    require(out["d"]["unplaced_at_exit"] > 0,
            "case (d) left no bidder unplaced: the placement passes went untested")
    return out


# ----------------------------------------------------------------------------
# Phase 2, continued: the rest of a tear round (K7, K8), K9 and K10
# ----------------------------------------------------------------------------

def timed_reset(reset, fn, reps=30, warmup=2):
    """Median CUDA-event time of fn() in ms, each call after reset(), whose
    work is enqueued before the start event and so not timed."""
    import torch

    times = []
    for i in range(warmup + reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def scalars_f64(costs, nm, choice, cand_ref, m, flipped, checked, tw, tri_mask, src):
    """The six values of one window's stop rule on the host: the sums in
    float64, the counts exact (numpy arrays of one window)."""
    n, C = costs.shape
    col = np.clip(choice, 0, C - 1)
    match = choice < C
    rows = np.arange(n)
    base = np.where(match, costs[rows, col].astype(np.float64), nm.astype(np.float64)).sum()
    refs = np.clip(cand_ref[rows, col][match], 0, m - 1)
    over = float(len(refs) - len(np.unique(refs)))
    tw = tw.astype(np.float64)
    return np.array([base, over, tw[flipped].sum(), tw[tri_mask & (src != 0)].sum(),
                     checked.sum(), flipped.sum()], np.float64)


def check_scalars(tag, got, want):
    """K7's row against the host's: counts exact, sums within 1e-6 relative."""
    got = np.asarray(got, np.float64)
    for k in (1, 4, 5):
        require(got[k] == want[k], f"K7 {tag}: value {k} is {got[k]}, exactly {want[k]}")
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in (0, 2, 3))
    require(rel <= 1e-6, f"K7 {tag}: a float sum off the float64 sum by {rel:.3g} relative")
    return rel


def k7_bytes(choice, C, flipped, tri_mask, src):
    """Bytes K7 must move for one window, from this run's data (numpy): per
    row its choice, then the chosen cost and ref of a matched row or the
    no-match cost of an unmatched one; per triangle its flipped, checked and
    mask flags, the source sign of a masked one and the weight of one that is
    flipped or checkable; the window's ref count and its six outputs."""
    matched = int((choice < C).sum())
    n = len(choice)
    weighed = flipped | (tri_mask & (src != 0))
    return (4 * n + 8 * matched + 4 * (n - matched) + 3 * len(flipped)
            + 4 * int(tri_mask.sum()) + 4 * int(weighed.sum()) + 4 + 24)


def k8_bytes(tris, flipped, cnt_before, cnt_after, choice, C, vmove, L):
    """Bytes K8 must move for one window, from this run's data (numpy): every
    triangle's flipped flag; for each flipped triangle its vertices, its
    count and the filled slots of its memory (a slot at or past the count
    holds -2 and cannot match); the choice of each distinct vertex of the
    flipped triangles and the matched pair of those matched; for each cut
    its move and surcharge, the stored triple and the new count; each
    distinct (vertex, column) cell surcharged, read and written once; the
    control words and the cuts added."""
    from same_tpu_torch.kernels.tear_round import surcharged_cells

    f = np.flatnonzero(flipped)
    verts = np.unique(tris[f])
    matched = int((choice[verts] < C).sum())
    new = np.flatnonzero(cnt_after != cnt_before)
    cells = np.unique(surcharged_cells(tris, vmove, choice, new, C, L), axis=0)
    return (len(flipped) + 16 * len(f) + 12 * int(cnt_before[f].sum()) + 4 * len(verts)
            + 4 * matched + 21 * len(new) + 8 * len(cells) + 16 + 4)


def compare_cuts(tag, state_k, state_p, added_k, added_p):
    """K8's outputs bit-equal to the plain version's."""
    for name, a, b in zip(("cut_mem", "cut_cnt", "extra"), state_k, state_p):
        require_equal(f"K8 {tag} {name}", a, b)
    require_equal(f"K8 {tag} added", added_k, added_p.to(added_k.device))


def run_cuts_twice(tag, args, state, register, cuts_added, **kw):
    """K8 and its plain version from the same state, two rounds each (the
    second finds its cuts in memory); returns the cuts added a round, the
    kernel's end state and the largest difference from the plain version."""
    import torch

    from same_tpu_torch.kernels.tear_round import register_cuts, register_cuts_plain

    sk = [t.clone() for t in state]
    sp = [t.clone() for t in state]
    added, err = [], 0.0
    for rnd in range(2):
        ak = register_cuts(*args, register, cuts_added, *sk, **kw)
        ap = register_cuts_plain(*args, register, cuts_added, *sp, **kw)
        torch.cuda.synchronize()
        compare_cuts(f"{tag} round {rnd}", sk, sp, ak, ap)
        err = max(err, max_abs_diff(list(zip(sk, sp)) + [(ak, ap)]))
        added.append(ak.tolist())
    return added, sk, err


def phase2_tear_round(pw, res, device, smi_line):
    """K7 and K8 at the LUAD window's round-0 state against their plain
    versions, and K8 on synthetic windows that exercise its corners."""
    import torch

    from same_tpu_torch.kernels.tear_metrics import tear_metrics
    from same_tpu_torch.kernels.tear_round import (
        register_cuts, register_cuts_plain, synthetic_round_state, tear_scalars,
        tear_scalars_plain,
    )
    from same_tpu_torch.models.assignment import to_device
    from same_tpu_torch.solver.tearing_device import _cut_surcharge, _knobs, _score_and_stop

    prob = pw.problem
    pd = to_device(prob, device)
    n, C = prob.costs.shape
    T, K, L = len(pw.tris), 6, int(prob.n_slot_copies)

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    tris, src = up(pw.tris, torch.int32), up(pw.source_signs, torch.int32)
    ref_xy, tw = up(pw.ref_coords, torch.float32), up(pw.tri_weights, torch.float32)
    tri_mask = torch.ones(T, dtype=torch.bool, device=device)
    m = ref_xy.shape[0]
    # Round 0: the first auction solve, K2 at no surcharge.
    checked, flipped, vmove = tear_metrics(
        pd.costs, torch.zeros_like(pd.costs), pd.slots, pd.valid, pd.nm_cost, pd.pair_idx,
        pd.cand_ref, tris, tri_mask, src, ref_xy, res.prices, res.choice)
    k7_args = (pd.costs[None], pd.nm_cost[None], res.choice[None], pd.cand_ref[None],
               ref_xy[None], torch.tensor([m], dtype=torch.int32, device=device),
               flipped[None], checked[None], tw[None], tri_mask[None], src[None])
    got = tear_scalars(*k7_args)
    plain = tear_scalars_plain(*k7_args)
    torch.cuda.synchronize()
    require_equal("K7 LUAD round 0", got, plain)
    host = [t.cpu().numpy() for t in (pd.costs, pd.nm_cost, res.choice, pd.cand_ref)]
    want = scalars_f64(*host, m, *(t.cpu().numpy() for t in (flipped, checked, tw, tri_mask, src)))
    rel = check_scalars("LUAD round 0", got[0].cpu().numpy(), want)
    kn = _knobs(OPTIM["delaunay_penalty"], SOLVER["lazy_allowed_flip_fraction"],
                OPTIM["penalty_coeff"], False, 6, SOLVER["tpu_tear_plateau_tol"], n,
                pw.eps_solver, 128, SOLVER["mip_gap"])
    decide = [_score_and_stop(row, 0, kn, np.float32(np.inf), 0, 0, 0, 1 << 30)
              for row in (got[0].cpu().numpy(), plain[0].cpu().numpy())]
    require(decide[0] == decide[1], f"K7: stop decisions {decide[0]} vs plain {decide[1]}")
    k7_err = float((got.double() - torch.as_tensor(want, device=device)).abs().max())
    t7 = median_ms(lambda: tear_scalars(*k7_args))
    t7_p = median_ms(lambda: tear_scalars_plain(*k7_args), reps=10, warmup=1)
    n7 = k7_bytes(res.choice.cpu().numpy(), C,
                  *(t.cpu().numpy() for t in (flipped, tri_mask, src)))
    b7 = bound_ms(n7)
    log(f"[phase 2] K7 LUAD round 0: [n, C] = [{n}, {C}], m = {m}, T = {T}; bit-equal to "
        f"the plain version, counts exact, sums within {rel:.3g} of float64 (max abs "
        f"{k7_err:.4g}), stop decision {decide[0][3]} both; values {got[0].tolist()}; "
        f"kernel {t7:.4f} ms (median of 60), plain {t7_p:.3f} ms (median of 10); bound "
        f"{n7 / 1e6:.4f} MB = {b7 * 1e3:.4f} us; {smi_line}")

    surcharge = _cut_surcharge(tw, kn)
    args = (tris[None], surcharge[None], res.choice[None], pd.pair_idx[None], flipped[None],
            vmove[None])
    kw = dict(L=L, K=K, max_cuts_per_round=1000, max_cuts_total=1 << 30)
    state = (torch.full((1, T, K, 3), -2, dtype=torch.int32, device=device),
             torch.zeros((1, T), dtype=torch.int32, device=device),
             torch.zeros((1, n, C), dtype=torch.float32, device=device))
    one, zero = np.ones(1, bool), np.zeros(1, np.int64)
    added, _, k8_err = run_cuts_twice("LUAD round 0", args, state, one, zero, **kw)
    # The second round from the first's end state adds only the triangles
    # the per-round cap held back.
    first, second = added[0][0], added[1][0]
    cap = kw["max_cuts_per_round"]
    require(0 < first <= cap and (first == cap or second == 0), f"K8 LUAD: cuts added {added}")
    work = [t.clone() for t in state]

    def reset():
        for w_, s_ in zip(work, state):
            w_.copy_(s_)

    t8 = timed_reset(reset, lambda: register_cuts(*args, one, zero, *work, **kw))
    t8_p = timed_reset(reset, lambda: register_cuts_plain(*args, one, zero, *work, **kw),
                       reps=5, warmup=1)
    # After timed_reset, work holds the state one launch left from state.
    n8 = k8_bytes(np.asarray(pw.tris), flipped.cpu().numpy(), state[1][0].cpu().numpy(),
                  work[1][0].cpu().numpy(), res.choice.cpu().numpy(), C,
                  vmove.cpu().numpy(), L)
    b8 = bound_ms(n8)
    log(f"[phase 2] K8 LUAD round 0: L = {L}, K = {K}, {int(flipped.sum())} flipped, "
        f"{added[0][0]} cuts (cap {kw['max_cuts_per_round']} a round), then {added[1][0]} "
        f"from the first's end state; cut_mem, cut_cnt, "
        f"extra, added bit-equal to the plain version in both rounds; kernel {t8:.4f} ms "
        f"(median of 30), plain {t8_p:.3f} ms (median of 5); bound {n8 / 1e6:.4f} MB = "
        f"{b8 * 1e3:.4f} us; {smi_line}")

    # Synthetic windows: dp = 0.1 surcharges, about ten cuts a vertex, C = 7
    # with L = 3 (a block clamped at C - 1), full and matching memories; the
    # caps free, then binding (per round in window 0, in total in window 1).
    rng = np.random.default_rng(5)
    keys = ("choice", "pair_idx", "tris", "surcharge", "flipped", "vmove", "cut_mem",
            "cut_cnt", "extra")
    ws = [{k: w[k] for k in keys} for w in (synthetic_round_state(rng) for _ in range(3))]
    for label, reg, done, caps in (
        ("no cap", [True, True, False], [0, 5, 0], (1000, 1 << 30)),
        ("both caps", [True, True, True], [0, 18, 3], (4, 20)),
    ):
        st = {k: up(np.stack([w[k] for w in ws]), None) for k in ws[0]}
        s_args = (st["tris"], st["surcharge"], st["choice"], st["pair_idx"], st["flipped"],
                  st["vmove"])
        added, after, err = run_cuts_twice(
            f"synthetic, {label}", s_args, (st["cut_mem"], st["cut_cnt"], st["extra"]),
            np.asarray(reg), np.asarray(done), L=3, K=2, max_cuts_per_round=caps[0],
            max_cuts_total=caps[1])
        hits = cut_targets(ws, after[1].cpu().numpy(), L=3)
        require(hits > 0, f"K8 synthetic, {label}: no (vertex, column) cell got two surcharges")
        k8_err = max(k8_err, err)
        if label == "both caps":
            require(added[0] == [4, 2, 4], f"K8 synthetic: caps gave {added[0]}, not [4, 2, 4]")
        log(f"[phase 2] K8 synthetic [3, 40, 7], {label}: cuts added {added[0]} then "
            f"{added[1]}; {hits} (vertex, column) cells surcharged more than once; "
            f"bit-equal to the plain version")
    return {
        "k7": {"err": k7_err, "ms": t7, "plain_ms": t7_p, "bound_ms": b7},
        "k8": {"err": k8_err, "ms": t8, "plain_ms": t8_p, "bound_ms": b8},
    }


def cut_targets(ws, cnt_after, L):
    """(vertex, column) cells of the synthetic windows that got more than one
    surcharge in the first round."""
    from same_tpu_torch.kernels.tear_round import surcharged_cells

    hits = 0
    for b, w in enumerate(ws):
        new = np.flatnonzero(cnt_after[b] != w["cut_cnt"])
        cells = surcharged_cells(w["tris"], w["vmove"], w["choice"], new,
                                 w["extra"].shape[1], L)
        _, counts = np.unique(cells, axis=0, return_counts=True)
        hits += int((counts > 1).sum())
    return hits


def phase2_bid_compute(device, smi_line):
    """K9 at the microbenchmark's instance, C = 8 and 24, against its plain
    version."""
    import torch

    from same_tpu_torch.kernels.bid_compute import bid_compute, bid_compute_plain
    from same_tpu_torch.microbench import instance

    out = {}
    for C in (8, 24):
        x = instance(12288, C, device)
        args = (x["costs"], x["prices"][x["slots"].long()], x["valid"], x["nm"])
        ck, ik = bid_compute(*args)
        cp, ip = bid_compute_plain(*args)
        torch.cuda.synchronize()
        require_equal(f"K9 C={C} choice", ck, cp)
        require_equal(f"K9 C={C} incr", ik, ip)
        err = float((ik - ip).abs().max())
        t_k = median_ms(lambda: bid_compute(*args))
        t_p = median_ms(lambda: bid_compute_plain(*args))
        n = args[0].shape[0]
        nbytes = tensor_bytes(*args, ck, ik)
        b_ms = bound_ms(nbytes)
        log(f"[phase 2] K9 [{n}, {C}]: choice and incr bit-equal to the plain version "
            f"({int((ck == C).sum())} rows on no-match); kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms (median of 60); bound {nbytes / 1e6:.3f} MB = {b_ms * 1e3:.3f} us; "
            f"{smi_line}")
        out[C] = {"err": err, "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms}
    return out


def phase2_sinkhorn_dense(device, smi_line):
    """K10 through the public op at [4096, 4096], eps 0.05, 200 iterations,
    against the plain version in float32 and in float64 on the card."""
    import torch

    from same_tpu_torch.kernels.sinkhorn_dense import sinkhorn_dense, sinkhorn_dense_plain
    from same_tpu_torch.ops import sinkhorn as ops_sinkhorn

    n = m = 4096
    eps, iters = 0.05, 200
    rng = np.random.default_rng(11)
    cost_np = rng.uniform(0, 5, (n, m)).astype(np.float32)
    a_np, b_np = np.full(n, 1.0 / n, np.float32), np.full(m, 1.0 / m, np.float32)
    # The entry point, no device given: the card, one K10 call.
    sinkhorn_dense.launches = 0
    plan, f, g = ops_sinkhorn.sinkhorn_dense(cost_np, a_np, b_np, eps=eps, n_iters=iters)
    torch.cuda.synchronize()
    launches = sinkhorn_dense.launches
    require(launches == 1 and plan.device.type == "cuda",
            f"K10: the op launched {launches} times on {plan.device}")
    cost, a, b = (torch.as_tensor(x).to(device) for x in (cost_np, a_np, b_np))
    p32 = sinkhorn_dense_plain(cost, a, b, eps, iters)
    p64 = sinkhorn_dense_plain(cost.double(), a.double(), b.double(), eps, iters)
    torch.cuda.synchronize()
    for name, t in (("plan", plan), ("f", f), ("g", g)):
        require(bool(torch.isfinite(t).all()), f"K10: {name} is not finite")

    def err(x, ref):
        return float((x.double() - ref).abs().max())

    e_k = max(err(f, p64[1]), err(g, p64[2]))
    e_p = max(err(p32[1], p64[1]), err(p32[2], p64[2]))
    require(e_k <= 2 * e_p, f"K10: error on f, g against float64 {e_k:.3g} is more than "
            f"twice the float32 plain version's {e_p:.3g}")
    plan_err = err(plan, p64[0])
    # The last update is g's: the columns meet their marginals up to rounding.
    col = float(((plan.double().sum(0) - b.double()) / b.double()).abs().max())
    row = float(((plan.double().sum(1) - a.double()) / a.double()).abs().max())
    require(col <= 1e-4, f"K10: a plan column misses its marginal by {col:.3g} relative")
    kdiff = max(err(f, p32[1]), err(g, p32[2]))
    t_k = median_ms(lambda: sinkhorn_dense(cost, a, b, eps, iters), reps=5, warmup=1)
    t_p = median_ms(lambda: sinkhorn_dense_plain(cost, a, b, eps, iters), reps=3, warmup=1)
    z_row = (p32[2][None, :] - cost) / torch.tensor(eps, device=device)
    z_col = (p32[1][:, None] - cost) / torch.tensor(eps, device=device)
    t_lib = iters * median_ms(lambda: (torch.logsumexp(z_row, 1), torch.logsumexp(z_col, 0)),
                              reps=20)
    entries = n * m
    flops = 12.0 * entries * iters + 4.0 * entries
    nbytes = tensor_bytes(cost, a, b, plan, f, g)
    b_bytes, b_ops = bound_ms(nbytes), flops / F32_FLOP_PER_S * 1e3
    log(f"[phase 2] K10 [{n}, {m}], eps {eps}, {iters} iterations, through "
        f"ops.sinkhorn.sinkhorn_dense on the card ({launches} call): max error on f, g against "
        f"float64 {e_k:.3g}, float32 plain version's {e_p:.3g} (allowed 2x); kernel vs float32 "
        f"plain {kdiff:.3g}; plan error {plan_err:.3g}; marginals within {col:.3g} (columns), "
        f"{row:.3g} (rows) relative; kernel "
        f"{t_k:.3f} ms (median of 5), plain {t_p:.3f} ms (median of 3), two torch.logsumexp "
        f"x {iters} {t_lib:.3f} ms; bound {flops / 1e9:.2f} GFLOP / 67 TFLOP/s = {b_ops:.4f} ms "
        f"(operations; bytes {nbytes / 1e6:.1f} MB = {b_bytes:.4f} ms; the cost and its "
        f"transpose read each iteration: {iters * 2 * 4 * entries / HBM_BYTES_PER_S * 1e3:.2f} "
        f"ms); {smi_line}")
    return {"err": e_k, "plain_err": e_p, "ms": t_k, "plain_ms": t_p, "library_ms": t_lib,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "operations" if b_ops >= b_bytes else "bytes", "launches": launches}


# ----------------------------------------------------------------------------
# Phase 7: the microbenchmark
# ----------------------------------------------------------------------------

def phase7(smi_line):
    """``same_tpu_torch.microbench`` at its defaults, K1's and K9's counts
    from 0."""
    from same_tpu_torch import microbench
    from same_tpu_torch.kernels import auction_bid, bid_compute

    for fn in (auction_bid, bid_compute):
        fn.launches = 0
    log("[phase 7] python -m same_tpu_torch.microbench (defaults):")
    results = microbench.main([])
    launches = {"auction_bid": auction_bid.launches, "bid_compute": bid_compute.launches}
    require(launches["bid_compute"] == 201 and launches["auction_bid"] == 201,
            f"microbenchmark: launches {launches}, expected 201 each (warm-up + 200)")
    log(f"[phase 7] launches {json.dumps(launches)}; {smi_line}")
    return results, launches


# ----------------------------------------------------------------------------
# Phase 3: the slice
# ----------------------------------------------------------------------------

def luad_window(cells):
    from bench import make_instance
    from same_tpu_torch import greedy_triangle_collapse

    t0 = time.time()
    ref_df, qry_df, types = make_instance(n_cells=cells)
    kw = dict(original_idx_col="Cell_Num_Old", max_metacell_size=3, r_max=250,
              min_angle_deg=15, return_object=True, verbose=False)
    mc_align = greedy_triangle_collapse(qry_df, **kw)
    mc_ref = greedy_triangle_collapse(ref_df, **kw)
    log(f"[setup] window: {len(ref_df)} / {len(qry_df)} cells -> "
        f"{len(mc_ref.metacell_df)} / {len(mc_align.metacell_df)} metacells "
        f"in {time.time() - t0:.1f}s")
    return mc_ref, mc_align, types


def slice_run(mc_ref, mc_align, types, label, solver, check_anchor, obj_lb, smi_line,
              split=False):
    """One ``run_same`` of the window with the kernels' counts from 0; with
    ``split``, the split of its tear rounds is printed and returned."""
    import contextlib

    import torch

    from same_tpu_torch import run_same
    from same_tpu_torch.kernels import (
        auction_bid, auction_loop, register_cuts, tear_metrics, tear_scalars,
    )

    kernels = {"auction_loop": auction_loop, "auction_bid": auction_bid,
               "tear_metrics": tear_metrics, "tear_scalars": tear_scalars,
               "register_cuts": register_cuts}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with RoundSplit() if split else contextlib.nullcontext() as spy:
        matches, var_out = run_same(
            ref_df=mc_ref.metacell_df, aligned_df=mc_align, commonCT=types,
            optim_params=OPTIM, solver_params=solver, verbose=False,
        )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    tpu = var_out["tpu"]
    stage = {k: round(float(v), 3) for k, v in tpu["stage_times"].items()}
    summary = {
        "matches": int(len(matches)),
        "flip_fraction": float(tpu["flip_fraction"]),
        "objective": float(tpu["objective"]),
        "tear_rounds": int(tpu["tear_rounds"]),
        "auction_rounds_total": int(tpu["auction_rounds_total"] or 0),
        "device_time_s": float(tpu["device_time"] or 0.0),
        "us_per_bidding_round": 1e6 * float(tpu["device_time"] or 0.0)
        / max(int(tpu["auction_rounds_total"] or 0), 1),
        "wall_s": wall,
        "stage_times_s": stage,
        "launches": launches,
        "repair": {k: v for k, v in tpu["repair_stats"].items()
                   if isinstance(v, (int, float, bool, str))},
    }
    if split:
        summary["round_split_ms"] = spy.split()
        log_split(f"[phase 3] {label}:", summary["round_split_ms"], smi_line)
    log(f"[phase 3] {label}: " + json.dumps(summary))

    require(launches["auction_loop"] > 0, f"{label}: auction_loop was never launched by run_same")
    # One persistent launch per auction solve: one solve per tear round.
    rounds = summary["tear_rounds"]
    require(launches["auction_loop"] == rounds,
            f"{label}: auction_loop launched {launches['auction_loop']} times for "
            f"{rounds} auction solves")
    # K7 once a tear round; K8 once a round that registers, which is every
    # round but the one the stop rule ends.
    require(launches["tear_scalars"] == rounds,
            f"{label}: K7 launched {launches['tear_scalars']} times for {rounds} tear rounds")
    require(rounds - 1 <= launches["register_cuts"] <= rounds and launches["register_cuts"] > 0,
            f"{label}: K8 launched {launches['register_cuts']} times in {rounds} tear rounds")
    require(launches["auction_bid"] == 0,
            f"{label}: the single-round K1 ran on the main path")
    require(launches["tear_metrics"] > 0, f"{label}: K2 tear_metrics was never launched by run_same")
    # The repo's own output checks: the output contract and a valid matching.
    for col in ("aligned_idx", "ref_idx", "triangle_violation", "Ref_metacell_id"):
        require(col in matches.columns, f"{label}: output column {col} missing")
    require(matches["aligned_idx"].is_unique, f"{label}: an aligned point matched twice")
    require(np.isfinite(summary["objective"]), f"{label}: objective is not finite")
    require(0.0 <= summary["flip_fraction"] <= 1.0, f"{label}: flip fraction out of range")
    require(summary["objective"] >= obj_lb,
            f"{label}: objective {summary['objective']} below the window's lower bound {obj_lb}")
    if not solver.get("tpu_speculative_repair", True):
        require("repair_workers" in summary["repair"]
                and not summary["repair"].get("speculative_used"),
                f"{label}: the repair after separation did not run")
    if check_anchor is not None:
        with open(os.path.join(HERE, ANCHOR_FILE)) as f:
            ref = json.load(f)["parsed"]
        m_ok = abs(summary["matches"] - ref["matches"]) <= 0.01 * ref["matches"]
        # The objective may not be worse than the record by more than the
        # window's mip_gap (5 %). A lower objective is a better solution of
        # the same MIP: the HiGHS repair after separation is wall-clock
        # budgeted, so its landing point varies with the host (ROADMAP C4),
        # and the rigorous lower bound above guards the other side.
        o_ok = summary["objective"] <= 1.05 * ref["objective"]
        f_ok = abs(summary["flip_fraction"] - ref["flip_fraction"]) <= 0.01
        log(f"[phase 3] {label} vs JAX record ({ANCHOR_FILE}): matches {summary['matches']} "
            f"vs {ref['matches']} (1 %: {m_ok}); objective {summary['objective']:.1f} vs "
            f"{ref['objective']} (at most 5 % above: {o_ok}; lower bound {obj_lb:.1f}); "
            f"flip fraction {summary['flip_fraction']:.4f} vs {ref['flip_fraction']} "
            f"(0.01: {f_ok}); auction rounds {summary['auction_rounds_total']} vs "
            f"{ref['auction_rounds_total']}; held to it: {check_anchor}")
        if check_anchor:
            require(m_ok and o_ok and f_ok,
                    f"{label}: slice result outside the JAX record's bounds")
    return summary


def phase3(mc_ref, mc_align, types, full, obj_lb, smi_line):
    """The window in each of SLICE_RUNS (only the first unless ``full``);
    returns the first, the main path's, summary. The first two print the
    split of their tear rounds: the main path's runs beside the speculative
    repair thread, the second's alone."""
    runs = SLICE_RUNS if full else SLICE_RUNS[:1]
    return [slice_run(mc_ref, mc_align, types, label, solver,
                      held if full else None, obj_lb, smi_line, split=i < 2)
            for i, (label, solver, held) in enumerate(runs)][0]


# ----------------------------------------------------------------------------
# Phase 4: the window grid
# ----------------------------------------------------------------------------

GRID_TYPES = ["B cell", "Epithelial", "Mesenchymal", "Myeloid", "T cell"]


def make_tissue(n_cells, extent, seed=3, query_keep=0.94):
    """LUAD-like tissue: the generator of examples/bench_grid.py (numpy and
    pandas only), kept here so that the smoke imports nothing of examples/."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, extent, (n_cells, 2))
    centers = rng.uniform(0, extent, (len(GRID_TYPES) * 24, 2))
    center_type = rng.integers(0, len(GRID_TYPES), len(centers))
    types = np.empty(n_cells, np.int64)
    for s in range(0, n_cells, 20000):
        d = ((xy[s:s + 20000, None, :] - centers[None, :, :]) ** 2).sum(-1)
        types[s:s + 20000] = center_type[np.argmin(d, axis=1)]
    probs = np.full((n_cells, len(GRID_TYPES)), 2.0)
    probs[np.arange(n_cells), types] = 86.0
    probs += rng.uniform(0, 2, probs.shape)
    probs = probs / probs.sum(1, keepdims=True) * 100.0

    def frame(jseed, keep_frac=1.0):
        r = np.random.default_rng(jseed)
        keep = r.random(n_cells) < keep_frac
        df = pd.DataFrame(
            xy[keep] + r.normal(0, 15.0, (int(keep.sum()), 2)), columns=["X", "Y"])
        df["cell_type"] = np.asarray(GRID_TYPES)[types[keep]]
        for k, nm in enumerate(GRID_TYPES):
            df[nm] = probs[keep, k]
        df["Cell_Num_Old"] = np.arange(len(df))
        return df

    return frame(1), frame(2, keep_frac=query_keep), list(GRID_TYPES)


def thread_launches(fn):
    """Launches of kernel wrapper ``fn`` made by the calling thread so far."""
    import threading

    return fn.__dict__.get("launches_by_thread", {}).get(threading.get_ident(), 0)


class RoundSplit:
    """Where a tear round's time goes, on the card's timeline.

    For the ``with`` block, wraps the kernels that ``solver.tearing_device``
    calls (the auction, K2/K6, K7, K8) so that each call records a CUDA event
    before and after it. Between two calls the card waits on the host: after
    K7 for the read of the six values and the stop rule, after K8 for the
    read of the cuts added and the next round's set-up. :meth:`split`
    returns the mean ms a tear round spends in each part.
    """

    STAGES = {"auction_loop": "auction", "auction_loop_batch": "auction",
              "tear_metrics": "K2/K6", "tear_metrics_batch": "K2/K6",
              "tear_scalars": "K7", "register_cuts": "K8"}
    GAPS = {"K7": "read of the six values + stop rule",
            "K8": "read of the cuts added + next round's set-up"}

    def __enter__(self):
        from same_tpu_torch.solver import tearing_device

        self.td = tearing_device
        self.orig = {name: getattr(tearing_device, name) for name in self.STAGES}
        self.marks = []
        for name, fn in self.orig.items():
            setattr(tearing_device, name, self.wrap(self.STAGES[name], fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.td, name, fn)
        return False

    def wrap(self, stage, fn):
        import torch

        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.marks.append((stage, start, end))
            return out

        return call

    def split(self):
        import torch

        torch.cuda.synchronize()
        rounds = sum(stage == "K7" for stage, _s, _e in self.marks)
        parts = {}
        for i, (stage, start, end) in enumerate(self.marks):
            parts[stage] = parts.get(stage, 0.0) + start.elapsed_time(end)
            if i + 1 < len(self.marks):
                gap = self.GAPS.get(stage, "other host work between kernels")
                parts[gap] = parts.get(gap, 0.0) + end.elapsed_time(self.marks[i + 1][1])
        total = sum(parts.values())
        out = {k: v / max(rounds, 1) for k, v in parts.items()}
        out["round"] = total / max(rounds, 1)
        out["rounds"] = rounds
        return out


def log_split(tag, split, smi_line):
    parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items() if k not in ("round", "rounds"))
    log(f"{tag} a tear round on the card's timeline, mean of {split['rounds']}: "
        f"{split['round']:.3f} ms = {parts} (ms; CUDA events); {smi_line}")


class GridSpy:
    """Record what each window of a ``sliding_window_matching`` run did.

    Wraps the three stages in ``same_tpu_torch.core`` and
    ``solver.tearing._finish_solve`` for the length of the ``with`` block. A
    window runs its stages on one host thread, so the kernels' per-thread
    launch counts before and after a stage are that window's. ``records``
    holds one dict a window, in the order the windows were prepared.
    """

    STAGES = ("prepare_window", "solve_prepared", "finalize_window")

    def __init__(self):
        import threading

        self.records = []
        self.lock = threading.Lock()
        self.local = threading.local()
        self.by_pw = {}

    def __enter__(self):
        from same_tpu_torch import core
        from same_tpu_torch.solver import tearing

        self.core, self.tearing = core, tearing
        self.orig = {name: getattr(core, name) for name in self.STAGES}
        self.orig_finish = tearing._finish_solve
        core.prepare_window = self.prepare
        core.solve_prepared = self.solve
        core.finalize_window = self.finalize
        tearing._finish_solve = self.finish
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.core, name, fn)
        self.tearing._finish_solve = self.orig_finish
        return False

    def counted(self, names, fn, *a, **k):
        """fn(*a, **k) and the calling thread's launches of ``names`` in it."""
        from same_tpu_torch import kernels

        before = {name: thread_launches(getattr(kernels, name)) for name in names}
        out = fn(*a, **k)
        return out, {name: thread_launches(getattr(kernels, name)) - before[name]
                     for name in names}

    def prepare(self, *a, **k):
        t0 = time.time()
        pw, launches = self.counted(("radius_knn", "sinkhorn_sparse"),
                                    self.orig["prepare_window"], *a, **k)
        slot_ref = pw.problem.slot_ref
        rec = {
            "t0": t0, "n_ref_in": len(a[0]), "n_mov_in": len(a[1]),
            "n": int(pw.problem.n_aligned), "n_ref": int(pw.problem.n_ref),
            "shape": list(pw.problem.costs.shape), "T": int(len(pw.tris)),
            "obj_lb": float(pw.obj_lb), "launches": launches, "solves": [],
            "capacity": np.bincount(slot_ref[slot_ref >= 0], minlength=pw.problem.n_ref),
            "warm_start": pw.warm_info.get("method"),
        }
        with self.lock:
            self.records.append(rec)
            self.by_pw[id(pw)] = rec
        return pw

    def solve(self, pw, *a, **k):
        rec = self.by_pw[id(pw)]
        self.local.rec = rec
        t0 = time.time()
        res, launches = self.counted(
            ("auction_loop", "tear_metrics", "tear_scalars", "register_cuts"),
            self.orig["solve_prepared"], pw, *a, **k)
        self.local.rec = None
        rec["launches"].update(launches)
        used = np.bincount(res.match_ref[res.match_ref >= 0], minlength=rec["n_ref"])
        rec.update(
            solve_s=time.time() - t0, objective=float(res.objective),
            matches=int((res.match_ref >= 0).sum()), tear_rounds=int(res.tear_rounds),
            flip_fraction=float(res.flip_fraction),
            auction_rounds=int(res.info.get("auction_rounds_total") or 0),
            device_time=float(res.info.get("device_time") or 0.0),
            separation=float(res.info.get("separation_time") or 0.0),
            repair=float(res.info.get("repair_time") or 0.0),
            over_capacity=int((used > rec["capacity"]).sum()),
        )
        return res

    def finish(self, *a, **k):
        rec = getattr(self.local, "rec", None)
        if rec is not None:
            # Incumbents before repair: per tear round, the auction's rounds
            # and the number of matches.
            rec["solves"].append([(int(inc[5]), int((np.asarray(inc[0]) >= 0).sum()))
                                  for inc in a[10]])
        return self.orig_finish(*a, **k)

    def finalize(self, pw, *a, **k):
        out = self.orig["finalize_window"](pw, *a, **k)
        self.by_pw[id(pw)]["wall"] = time.time() - self.by_pw[id(pw)]["t0"]
        return out


def grid_run(mc_ref, mc_align, label, solver, device_knn):
    """One ``sliding_window_matching`` of the tissue with the kernels' counts
    from 0; returns (matches, merged, per-window records, grid wall)."""
    import torch

    from same_tpu_torch import (
        kernels, merge_window_matches_unique_ref, sliding_window_matching,
    )

    fns = {name: getattr(kernels, name) for name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    old_env = os.environ.get("SAME_TPU_KNN")
    if device_knn:
        os.environ["SAME_TPU_KNN"] = "tpu"
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        with GridSpy() as spy:
            matches = sliding_window_matching(
                mc_ref, mc_align, optim_params=GRID_OPTIM, solver_params=solver,
                verbose=False,
            )
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        if old_env is None:
            os.environ.pop("SAME_TPU_KNN", None)
        else:
            os.environ["SAME_TPU_KNN"] = old_env
    merged = merge_window_matches_unique_ref([matches], cell_id_col="metacell_id")
    launches = {name: fn.launches for name, fn in fns.items()}
    recs = spy.records
    wids = [int(w) for w in matches["window_id"].unique()]
    log(f"[phase 4] {label}: grid wall {wall:.2f}s, {len(recs)} windows {wids}, "
        f"{len(matches)} rows, {len(merged)} after the merge; repair budget "
        f"{GRID_REPAIR_BUDGET_S:g}s a window; launches {json.dumps(launches)}")
    for rec in recs:
        log(f"[phase 4]   n {rec['n']} (in {rec['n_mov_in']} / {rec['n_ref_in']} ref), "
            f"[n_pad, C] {rec['shape']}, T {rec['T']}: tear rounds {rec['tear_rounds']}, "
            f"auction rounds {rec['auction_rounds']}, matches {rec['matches']}, flip "
            f"{rec['flip_fraction']:.4f}, objective {rec['objective']:.1f} (lower bound "
            f"{rec['obj_lb']:.1f}); device_time {rec['device_time']:.3f}s, separation "
            f"{rec['separation']:.2f}s, repair {rec['repair']:.2f}s (budget "
            f"{GRID_REPAIR_BUDGET_S:g}s), wall {rec['wall']:.2f}s; warm start "
            f"{rec['warm_start']}; launches {json.dumps(rec['launches'])}")

    require(4 <= len(recs) <= 6, f"{label}: {len(recs)} solvable windows, expected 4 to 6")
    require(len(wids) == len(recs), f"{label}: {len(wids)} window ids for {len(recs)} windows")
    require(launches["auction_bid"] == 0, f"{label}: the single-round K1 ran in the grid")
    for name in ("auction_loop_batch", "tear_metrics_batch"):
        require(launches[name] == 0, f"{label}: the batched {name} ran without a mesh")
    for name in ("auction_loop", "tear_metrics", "tear_scalars", "register_cuts"):
        require(launches[name] == sum(r["launches"][name] for r in recs),
                f"{label}: {name} launches outside the windows' solves")
    for i, rec in enumerate(recs):
        what = f"{label}, window {i}"
        require(512 <= rec["n"] <= 6144,
                f"{what}: n = {rec['n']} is outside the fused loop without speculation")
        solves = sum(len(s) for s in rec["solves"])
        require(rec["launches"]["auction_loop"] == solves > 0,
                f"{what}: auction_loop launched {rec['launches']['auction_loop']} times "
                f"for {solves} auction solves")
        require(rec["launches"]["tear_metrics"] > 0, f"{what}: K2 never ran")
        require(rec["launches"]["tear_scalars"] == solves,
                f"{what}: K7 launched {rec['launches']['tear_scalars']} times for {solves} "
                f"tear rounds")
        k8 = rec["launches"]["register_cuts"]
        require(solves - len(rec["solves"]) <= k8 <= solves and k8 > 0,
                f"{what}: K8 launched {k8} times in {solves} tear rounds")
        want = 1 if device_knn else 0
        require(rec["launches"]["radius_knn"] == want,
                f"{what}: K3 launched {rec['launches']['radius_knn']} times, expected {want}")
        require(rec["launches"]["sinkhorn_sparse"] == want,
                f"{what}: K4 launched {rec['launches']['sinkhorn_sparse']} times, expected {want}")
        require(rec["warm_start"] == ("sinkhorn" if device_knn else "greedy-auto"),
                f"{what}: warm start {rec['warm_start']}")
        require(rec["over_capacity"] == 0, f"{what}: {rec['over_capacity']} refs over capacity")
        require(np.isfinite(rec["objective"]) and rec["objective"] >= rec["obj_lb"],
                f"{what}: objective {rec['objective']} against lower bound {rec['obj_lb']}")
        require(0 < rec["matches"] <= rec["n"] and 0.0 <= rec["flip_fraction"] <= 1.0,
                f"{what}: {rec['matches']} matches, flip fraction {rec['flip_fraction']}")
    for col in ("Aligned_metacell_id", "Ref_metacell_id"):
        require(merged[col].is_unique, f"{label}: {col} repeats in the merged frame")
    require(len(merged) >= 0.9 * matches["Aligned_metacell_id"].nunique(),
            f"{label}: the merge kept {len(merged)} of {len(matches)} rows")
    return {"matches": matches, "merged": merged, "records": recs, "wall": wall,
            "window_ids": wids, "launches": launches}


def grid_tissue(smi_line):
    """Phase 4's tissue collapsed to metacells: (mc_ref, mc_align)."""
    from same_tpu_torch import greedy_triangle_collapse

    t0 = time.time()
    ref_df, qry_df, _types = make_tissue(GRID_CELLS, GRID_EXTENT)
    kw = dict(original_idx_col="Cell_Num_Old", max_metacell_size=3, r_max=250,
              min_angle_deg=15, return_object=True, verbose=False)
    mc_align = greedy_triangle_collapse(qry_df, **kw)
    mc_ref = greedy_triangle_collapse(ref_df, **kw)
    log(f"[phase 4] tissue: {len(ref_df)} / {len(qry_df)} cells over {GRID_EXTENT:g} units -> "
        f"{len(mc_ref.metacell_df)} / {len(mc_align.metacell_df)} metacells in "
        f"{time.time() - t0:.1f}s; window {GRID_OPTIM['window_size']}, overlap "
        f"{GRID_OPTIM['overlap']}, dp {GRID_OPTIM['delaunay_penalty']:g}; {smi_line}")
    return mc_ref, mc_align


def phase4(mc_ref, mc_align):
    """The tissue through the window grid three ways (GRID_RUNS)."""
    runs = [grid_run(mc_ref, mc_align, label, solver, device_knn)
            for label, solver, device_knn in GRID_RUNS]
    seq, pipe, dev = runs

    def sizes(run):
        return sorted((r["n_mov_in"], r["n_ref_in"]) for r in run["records"])

    for other, label in ((pipe, GRID_RUNS[1][0]), (dev, GRID_RUNS[2][0])):
        require(sorted(other["window_ids"]) == sorted(seq["window_ids"]),
                f"{label}: window ids {other['window_ids']} vs {seq['window_ids']}")
        require(sizes(other) == sizes(seq), f"{label}: another window decomposition")
    # Windows are prepared under a lock by two threads, so the pipelined
    # run's order may differ: pair the windows by their input sizes.
    by_size = {(r["n_mov_in"], r["n_ref_in"]): r for r in pipe["records"]}
    for i, a in enumerate(seq["records"]):
        b = by_size[(a["n_mov_in"], a["n_ref_in"])]
        require(a["solves"] == b["solves"],
                f"window {i}: the pipelined run's incumbents before repair differ from "
                f"the sequential run's")
        require(abs(a["matches"] - b["matches"]) <= 0.01 * a["matches"],
                f"window {i}: {b['matches']} matches pipelined, {a['matches']} sequential")
        log(f"[phase 4] window {i} (n {a['n']}): device_time sequential "
            f"{a['device_time']:.3f}s, pipelined {b['device_time']:.3f}s; separation "
            f"{a['separation']:.2f}s / {b['separation']:.2f}s; identical incumbents before "
            f"repair over {sum(len(s) for s in a['solves'])} tear rounds")
    for i, (a, c) in enumerate(zip(seq["records"], dev["records"])):
        require(abs(a["matches"] - c["matches"]) <= 0.01 * a["matches"],
                f"window {i}: {c['matches']} matches with the device kNN, {a['matches']} "
                f"with the cKDTree")
    log(f"[phase 4] grid wall: sequential {seq['wall']:.2f}s, pipelined {pipe['wall']:.2f}s, "
        f"Sinkhorn start + device kNN {dev['wall']:.2f}s (repair budget "
        f"{GRID_REPAIR_BUDGET_S:g}s a window)")
    return runs


# ----------------------------------------------------------------------------
# Phase 6: the batched window solve (sliding_window_matching(mesh=...))
# ----------------------------------------------------------------------------

class MeshSpy:
    """Record what the batched path did: the prepared windows and results of
    ``parallel.solve_windows_sharded`` and each ``run_tearing_device_batch``
    call (its arguments and per-window data), for the ``with`` block."""

    def __enter__(self):
        from same_tpu_torch import parallel
        from same_tpu_torch.solver import tearing_device

        self.parallel, self.td = parallel, tearing_device
        self.orig_sharded = parallel.solve_windows_sharded
        self.orig_batch = tearing_device.run_tearing_device_batch
        self.prepared, self.results, self.batches = [], [], []

        def sharded(prepared, *a, **k):
            self.prepared = list(prepared)
            self.results = self.orig_sharded(prepared, *a, **k)
            return self.results

        def batch(*a, **k):
            out = self.orig_batch(*a, **k)
            self.batches.append({"args": a, "kwargs": k, "datas": out})
            return out

        parallel.solve_windows_sharded = sharded
        tearing_device.run_tearing_device_batch = batch
        return self

    def __exit__(self, *exc):
        self.parallel.solve_windows_sharded = self.orig_sharded
        self.td.run_tearing_device_batch = self.orig_batch
        return False


def mesh_grid_run(mc_ref, mc_align, seq, smi_line):
    """(f) The tissue through ``sliding_window_matching(mesh=make_mesh())``,
    the kernels' counts from 0, held against phase 4's sequential run; the
    split of its batched tear rounds."""
    import torch

    from same_tpu_torch import kernels, merge_window_matches_unique_ref
    from same_tpu_torch import sliding_window_matching
    from same_tpu_torch.kernels.auction_loop import batch_capacity
    from same_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    require(len(mesh) == 1, f"make_mesh() gave {len(mesh)} devices; the smoke needs one card")
    fns = {name: getattr(kernels, name) for name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with MeshSpy() as spy, RoundSplit() as timeline:
        matches = sliding_window_matching(
            mc_ref, mc_align, optim_params=GRID_OPTIM,
            solver_params=dict(GRID_SOLVER, tpu_pipeline_windows=1), mesh=mesh,
            verbose=False,
        )
    torch.cuda.synchronize()
    wall = time.time() - t0
    split = timeline.split()
    log_split("[phase 6] (f) batched:", split, smi_line)
    launches = {name: fn.launches for name, fn in fns.items()}
    merged = merge_window_matches_unique_ref([matches], cell_id_col="metacell_id")
    wids = [int(w) for w in matches["window_id"].unique()]
    pws, results = spy.prepared, spy.results
    buckets = [(len(b["datas"]), list(b["args"][0][0].costs.shape), b["args"][0][0].n_slots)
               for b in spy.batches]
    log(f"[phase 6] (f) mesh grid: wall {wall:.2f}s, {len(pws)} windows {wids}, batches "
        f"(windows, [n_pad, C], S) {buckets}, {len(matches)} rows, {len(merged)} after the "
        f"merge; launches {json.dumps(launches)}")

    # Launch counts: one K5 call and one K6 launch a tear round of each
    # batch, K5 in as many launches as co-residency needs; no solo solve
    # except an eps-retry re-solve.
    k5_calls = sum(max(d["rounds_used"] for d in b["datas"]) for b in spy.batches)
    k5_want = 0
    for b in spy.batches:
        p0 = b["args"][0][0]
        per_launch, _g = batch_capacity(p0.costs.shape[0], p0.n_slots, mesh[0])
        for r in range(max(d["rounds_used"] for d in b["datas"])):
            running = sum(d["rounds_used"] > r for d in b["datas"])
            k5_want += -(-running // per_launch)
    retries = [i for i, res in enumerate(results) if "eps_retry" in res.info]
    log(f"[phase 6] (f) batch tear rounds {k5_calls}; K5 launches {launches['auction_loop_batch']} "
        f"(expected {k5_want}), K6 launches {launches['tear_metrics_batch']}; eps-retry "
        f"re-solves {retries}, solo auction_loop launches {launches['auction_loop']}")
    require(launches["auction_loop_batch"] == k5_want > 0,
            f"mesh grid: K5 launched {launches['auction_loop_batch']} times, expected {k5_want}")
    require(launches["tear_metrics_batch"] == k5_calls,
            f"mesh grid: K6 launched {launches['tear_metrics_batch']} times for {k5_calls} rounds")
    # K7 once a batched round, K8 once a round in which a window registered
    # (each batch's rounds but perhaps its last); an eps retry's solo loop
    # adds its own.
    k7, k8 = launches["tear_scalars"], launches["register_cuts"]
    log(f"[phase 6] (f) K7 launches {k7}, K8 launches {k8} in {k5_calls} batched rounds of "
        f"{len(spy.batches)} batches")
    if retries:
        require(k7 >= k5_calls, f"mesh grid: K7 launched {k7} times for {k5_calls} rounds")
    else:
        require(k7 == k5_calls, f"mesh grid: K7 launched {k7} times for {k5_calls} rounds")
        require(k5_calls - len(spy.batches) <= k8 <= k5_calls and k8 > 0,
                f"mesh grid: K8 launched {k8} times in {k5_calls} batched rounds")
    require(launches["tear_metrics"] == 0 or retries, "mesh grid: the solo K2 ran during separation")
    require(launches["auction_loop"] == 0 or retries,
            "mesh grid: a solo auction_loop ran during separation without an eps retry")
    require(launches["auction_bid"] == 0, "mesh grid: the single-round K1 ran")

    # Against phase 4's sequential run.
    require(sorted(wids) == sorted(seq["window_ids"]),
            f"mesh grid: window ids {wids} vs sequential {seq['window_ids']}")
    pairs = set(zip(merged["Aligned_metacell_id"], merged["Ref_metacell_id"]))
    pairs_seq = set(zip(seq["merged"]["Aligned_metacell_id"], seq["merged"]["Ref_metacell_id"]))
    denom = max(len(pairs), len(pairs_seq), 1)
    agree = len(pairs & pairs_seq) / denom
    log(f"[phase 6] (f) merged matches {len(merged)} vs sequential {len(seq['merged'])}; "
        f"merged-pair agreement {agree:.4f} (gate 0.90)")
    require(abs(len(merged) - len(seq["merged"])) <= 0.01 * denom + 2,
            f"mesh grid: {len(merged)} merged matches vs {len(seq['merged'])} sequential")
    require(agree >= 0.90, f"mesh grid: merged-pair agreement {agree:.4f} < 0.90")
    for col in ("Aligned_metacell_id", "Ref_metacell_id"):
        require(merged[col].is_unique, f"mesh grid: {col} repeats in the merged frame")

    seq_by_size = {(r["n_mov_in"], r["n_ref_in"]): r for r in seq["records"]}
    recs = []
    for i, (pw, res) in enumerate(zip(pws, results)):
        slot_ref = pw.problem.slot_ref
        cap = np.bincount(slot_ref[slot_ref >= 0], minlength=pw.problem.n_ref)
        used = np.bincount(res.match_ref[res.match_ref >= 0], minlength=pw.problem.n_ref)
        n = int(pw.problem.n_aligned)
        matched = int((res.match_ref >= 0).sum())
        rec = {
            "n": n, "shape": list(pw.problem.costs.shape), "T": int(len(pw.tris)),
            "tear_rounds": int(res.tear_rounds), "matches": matched,
            "objective": float(res.objective), "obj_lb": float(pw.obj_lb),
            "flip_fraction": float(res.flip_fraction),
            "device_time": float(pw.stage_times.get("device_time", 0.0)),
            "repair": float(res.info.get("repair_time") or 0.0),
        }
        recs.append(rec)
        s = seq_by_size.get((len(pw.aligned_df), len(pw.ref_df)))
        log(f"[phase 6] (f)   window {i}: n {n}, [n_pad, C] {rec['shape']}, T {rec['T']}: tear "
            f"rounds {rec['tear_rounds']}, matches {matched}, flip {rec['flip_fraction']:.4f}, "
            f"objective {rec['objective']:.1f} (lower bound {rec['obj_lb']:.1f}); batch "
            f"device_time share {rec['device_time']:.3f}s, repair {rec['repair']:.2f}s"
            + ("" if s is None else f"; sequential: tear rounds {s['tear_rounds']}, matches "
               f"{s['matches']}, device_time {s['device_time']:.3f}s, repair {s['repair']:.2f}s"))
        what = f"mesh grid, window {i}"
        require(int((used > cap).sum()) == 0, f"{what}: refs over capacity")
        require(np.isfinite(rec["objective"]) and rec["objective"] >= rec["obj_lb"],
                f"{what}: objective {rec['objective']} against lower bound {rec['obj_lb']}")
        require(0 < matched <= n and 0.0 <= rec["flip_fraction"] <= 1.0,
                f"{what}: {matched} matches, flip fraction {rec['flip_fraction']}")
    batch_dev = sum(b["datas"][0]["device_time"] * len(b["datas"]) for b in spy.batches)
    seq_dev = sum(r["device_time"] for r in seq["records"])
    seq_rep = sum(r["repair"] for r in seq["records"])
    log(f"[phase 6] (f) grid wall: mesh {wall:.2f}s vs sequential {seq['wall']:.2f}s; "
        f"separation device_time: batch {batch_dev:.3f}s vs sequential sum {seq_dev:.3f}s; "
        f"repair sum {sum(r['repair'] for r in recs):.2f}s vs {seq_rep:.2f}s")
    return {"wall": wall, "launches": launches, "spy": spy, "records": recs,
            "batch_device_time": batch_dev, "agreement": agree, "round_split_ms": split}


def stacked(pws, device):
    """The prepared windows' problems stacked on a leading axis, on ``device``."""
    import torch

    from same_tpu_torch.parallel import stack_problems

    costs, slots, valid, nm, slot_rows, slot_cols = stack_problems([p.problem for p in pws])

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    return {
        "costs": up(costs, torch.float32), "slots": up(slots, torch.int32),
        "valid": up(valid, torch.bool), "nm": up(nm, torch.float32),
        "slot_rows": up(slot_rows, torch.int32), "slot_cols": up(slot_cols, torch.int32),
        "pair_idx": up(np.stack([p.problem.pair_idx for p in pws]), torch.int32),
        "cand_ref": up(np.stack([p.problem.cand_ref for p in pws]), torch.int32),
    }


def copies_of(pd, copies):
    """``copies`` copies of one problem on the card, stacked as K5 takes them."""
    return {"costs": pd.costs.expand(copies, -1, -1).contiguous(),
            "slots": pd.slots.expand(copies, -1, -1).contiguous(),
            "valid": pd.valid.expand(copies, -1, -1).contiguous(),
            "nm": pd.nm_cost.expand(copies, -1).contiguous(),
            "slot_rows": pd.slot_rows.expand(copies, -1, -1).contiguous(),
            "slot_cols": pd.slot_cols.expand(copies, -1, -1).contiguous()}


def max_abs_diff(pairs):
    """Largest absolute difference over (a, b) tensor pairs, as a float."""
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def require_same_batch(tag, k, p, windows):
    """Two ``auction_loop_batch`` results agree on the listed windows: choice,
    prices and owners bit-equal, rounds, phase and polish identical."""
    for b in windows:
        require((k.rounds[b], k.phase[b], k.polish[b]) == (p.rounds[b], p.phase[b], p.polish[b]),
                f"K5 {tag} window {b}: rounds/phase/polish {k.rounds[b]}/{k.phase[b]}/"
                f"{k.polish[b]} vs {p.rounds[b]}/{p.phase[b]}/{p.polish[b]}")
        for f in ("choice", "prices", "owner"):
            require_equal(f"K5 {tag} window {b} {f}", getattr(k, f)[b], getattr(p, f)[b])


def compare_batch_to_solo(tag, st, prices0, sched, budget, patience, tol, windows=None):
    """K5 on a stack against one solo ``auction_loop`` launch a window (and
    nothing else): choice, prices and owners bit-equal, rounds, phase and
    polish identical. Returns (K5 result, its counters, solo results)."""
    import importlib

    import torch

    tal = importlib.import_module("same_tpu_torch.kernels.auction_loop")
    B = st["costs"].shape[0]
    k = tal.auction_loop_batch(
        st["costs"], st["slots"], st["valid"], st["nm"], prices0, sched, budget,
        slot_rows=st["slot_rows"], slot_cols=st["slot_cols"], obj_patience=patience,
        obj_tol=tol, windows=windows)
    stats = dict(tal.auction_loop_batch.last_stats)
    solo = []
    for b in range(B) if windows is None else windows:
        s = tal.auction_loop(
            st["costs"][b], st["slots"][b], st["valid"][b], st["nm"][b], prices0[b],
            sched[b], budget, slot_rows=st["slot_rows"][b], slot_cols=st["slot_cols"][b],
            obj_patience=patience, obj_tol=tol[b] if np.ndim(tol) else tol)
        torch.cuda.synchronize()
        require((k.rounds[b], k.phase[b], k.polish[b]) == (s.rounds, s.phase, s.polish),
                f"K5 {tag} window {b}: rounds/phase/polish {k.rounds[b]}/{k.phase[b]}/"
                f"{k.polish[b]} vs solo {s.rounds}/{s.phase}/{s.polish}")
        for f in ("choice", "prices", "owner"):
            require_equal(f"K5 {tag} window {b} {f}", getattr(k, f)[b], getattr(s, f))
        solo.append(s)
    return k, stats, solo


def phase6(mc_ref, mc_align, seq, luad_pw, device, smi_line):
    """The batched window solve: K5 and K6 against their solo kernels and
    plain versions, the batched tear loop against the solo loops, and the
    tissue through ``sliding_window_matching(mesh=make_mesh())``."""
    import torch

    from same_tpu_torch.kernels import auction_loop, tear_metrics
    from same_tpu_torch.kernels.auction_loop import (
        auction_loop_batch, auction_loop_batch_plain, batch_capacity,
    )
    from same_tpu_torch.kernels.tear_metrics import (
        tear_metrics_batch, tear_metrics_batch_plain,
    )
    from same_tpu_torch.models.assignment import to_device
    from same_tpu_torch.solver.auction import default_eps_schedule, natural_stop_args
    from same_tpu_torch.solver.tearing_device import round_budget, run_tearing_device

    mesh = mesh_grid_run(mc_ref, mc_align, seq, smi_line)
    spy = mesh["spy"]
    out = {"mesh": mesh}

    # (a) K5 on the largest bucket's windows, cold on the full schedule at
    # the batch's budget, against one solo launch a window and against its
    # plain version.
    batch = max(spy.batches, key=lambda b: len(b["datas"]))
    pws = [next(p for p in spy.prepared if p.problem is prob) for prob in batch["args"][0]]
    B = len(pws)
    n_pad, C = pws[0].problem.costs.shape
    S = pws[0].problem.n_slots
    st = stacked(pws, device)
    budget = round_budget(n_pad, C, B)
    sched = np.stack([default_eps_schedule(p.problem, p.eps_solver) for p in pws])
    stop = [natural_stop_args(n_pad, p.eps_solver, 128) for p in pws]
    tol = np.asarray([s[1] for s in stop], np.float32)
    zeros = torch.zeros((B, S + 1), dtype=torch.float32, device=device)
    k, stats, solo = compare_batch_to_solo("(a)", st, zeros, sched, budget, 128, tol)
    per_launch, g = batch_capacity(n_pad, S, device)
    args = (st["costs"], st["slots"], st["valid"], st["nm"], zeros, sched, budget)
    kw = dict(slot_rows=st["slot_rows"], slot_cols=st["slot_cols"], obj_patience=128,
              obj_tol=tol)
    # The plain version on the same inputs, once: held to K5, then its time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pk = auction_loop_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    t_p = (time.perf_counter() - t0) * 1e3
    require_same_batch("(a) vs plain", k, pk, range(B))
    outs = ("choice", "prices", "owner")
    err = max_abs_diff([(getattr(k, f)[b], getattr(s, f)) for b, s in enumerate(solo) for f in outs]
                       + [(getattr(k, f), getattr(pk, f)) for f in outs])
    t_k = wall_ms(lambda: auction_loop_batch(*args, **kw))
    t_solo = wall_ms(lambda: [
        auction_loop(
            st["costs"][b], st["slots"][b], st["valid"][b], st["nm"][b], zeros[b], sched[b],
            budget, slot_rows=st["slot_rows"][b], slot_cols=st["slot_cols"][b],
            obj_patience=128, obj_tol=tol[b]) for b in range(B)])
    Ps = st["slot_rows"].shape[2]
    nbytes = sum(
        loop_bytes(n_pad, C, S, Ps, {key: (v[b] if isinstance(v, list) else v)
                                     for key, v in stats.items()}, 4 * (S + 1))
        for b in range(B))
    b_ms = bound_ms(nbytes)
    log(f"[phase 6] (a) K5 on {B} windows of [{n_pad}, {C}], S = {S} (grid {g} blocks a "
        f"window, {per_launch} windows a launch), cold, full schedule, budget {budget}: "
        f"bit-equal to {B} solo launches and to the plain version (max abs err {err}); rounds "
        f"{k.rounds.tolist()}; K5 {t_k:.3f} ms, {B} solo launches {t_solo:.3f} ms, plain "
        f"{t_p:.1f} ms (median of 5, 5; one call); bound {nbytes / 1e6:.2f} MB = {b_ms:.4f} ms "
        f"(B x the per-window counters); {smi_line}")
    out["k5"] = {"err": err, "ms": t_k, "solo_ms": t_solo, "plain_ms": t_p, "bound_ms": b_ms,
                 "windows": B, "rounds": k.rounds.tolist(), "grid": g,
                 "windows_per_launch": per_launch}

    # (b) K5 against its plain version on three 144-point windows.
    smalls = [small_window_problem(seed)[0] for seed in (7, 8, 9)]
    shapes = {(p.costs.shape, p.n_slots) for p in smalls}
    require(len(shapes) == 1, f"(b): the small windows span buckets {shapes}")
    sp = [to_device(p, device) for p in smalls]
    sst = {f: torch.stack([getattr(p, f) for p in sp]) for f in (
        "costs", "slots", "valid", "nm_cost", "slot_rows", "slot_cols")}
    ssched = np.stack([default_eps_schedule(p, 1e-3) for p in smalls])
    s_zeros = torch.zeros((3, smalls[0].n_slots + 1), dtype=torch.float32, device=device)
    for patience in (0, 128):
        sargs = (sst["costs"], sst["slots"], sst["valid"], sst["nm_cost"], s_zeros, ssched, 20000)
        skw = dict(slot_rows=sst["slot_rows"], slot_cols=sst["slot_cols"],
                   obj_patience=patience,
                   obj_tol=natural_stop_args(smalls[0].costs.shape[0], 1e-3, patience)[1])
        kk = auction_loop_batch(*sargs, **skw)
        pp = auction_loop_batch_plain(*sargs, **skw)
        torch.cuda.synchronize()
        require_same_batch(f"(b) patience {patience} vs plain", kk, pp, range(3))
        log(f"[phase 6] (b) K5 on three 144-point windows [{smalls[0].costs.shape[0]}, "
            f"{smalls[0].costs.shape[1]}], patience {patience}: bit-equal to the plain version, "
            f"rounds {kk.rounds.tolist()}")

    # (c) More windows than one launch holds: copies of the LUAD window.
    lp = to_device(luad_pw.problem, device)
    ln, lC = luad_pw.problem.costs.shape
    lS = luad_pw.problem.n_slots
    l_per_launch, lg = batch_capacity(ln, lS, device)
    copies = max(10, l_per_launch + 1)
    eps = luad_pw.eps_solver
    lsched = np.asarray([eps * 64, eps * 8, eps], np.float32)
    lsched = np.tile(np.concatenate([lsched, np.full(13, lsched[-1], np.float32)]), (copies, 1))
    lstop = natural_stop_args(ln, float(lsched[0, -1]), 128)
    lprices = torch.as_tensor(luad_pw.prices0, dtype=torch.float32).to(device)
    lst = copies_of(lp, copies)
    before = auction_loop_batch.launches
    kc = auction_loop_batch(lst["costs"], lst["slots"], lst["valid"], lst["nm"],
                            lprices.expand(copies, -1).contiguous(), lsched, 500000,
                            slot_rows=lst["slot_rows"], slot_cols=lst["slot_cols"],
                            obj_patience=lstop[0], obj_tol=lstop[1])
    n_launches = auction_loop_batch.launches - before
    one = auction_loop(
        lp.costs, lp.slots, lp.valid, lp.nm_cost, lprices, lsched[0], 500000,
        slot_rows=lp.slot_rows, slot_cols=lp.slot_cols, obj_patience=lstop[0],
        obj_tol=lstop[1])
    torch.cuda.synchronize()
    for b in range(copies):
        require((kc.rounds[b], kc.phase[b], kc.polish[b]) == (one.rounds, one.phase, one.polish),
                f"K5 (c) copy {b}: rounds/phase/polish differ from the solo launch")
        for f in ("choice", "prices", "owner"):
            require_equal(f"K5 (c) copy {b} {f}", getattr(kc, f)[b], getattr(one, f))
    require(n_launches == -(-copies // l_per_launch) >= 2,
            f"K5 (c): {n_launches} launches for {copies} windows at {l_per_launch} a launch")
    log(f"[phase 6] (c) K5 on {copies} copies of the LUAD window ([{ln}, {lC}], S = {lS}, grid "
        f"{lg} blocks a window, {l_per_launch} windows a launch): {n_launches} launches, every "
        f"copy bit-equal to the solo launch ({one.rounds} rounds)")
    # A window wider than the batch kernel's co-resident grid: both paths
    # cap g there, so K5 still runs it, bit-equal to the solo launch.
    wide_p = random_problem(2048, 72000)
    wide = to_device(wide_p, device)
    wn, wS = wide_p.costs.shape[0], wide_p.n_slots
    w_per_launch, wg = batch_capacity(wn, wS, device)
    kwide, _stats, _solo = compare_batch_to_solo(
        "(c) wide", copies_of(wide, 2),
        torch.zeros((2, wS + 1), dtype=torch.float32, device=device),
        np.tile(default_eps_schedule(wide_p, 0.05), (2, 1)), 20000, 0, 0.0)
    log(f"[phase 6] (c) K5 on 2 copies of a window of {wn} bidders among S = {wS} slots "
        f"(widest phase {-(-(wS + 1) // 256)} blocks, grid {wg}, {w_per_launch} a launch): "
        f"bit-equal to the solo launch ({kwide.rounds.tolist()} rounds)")

    # (d) K6 on the bucket's windows against solo K2 launches and its plain
    # version, at (a)'s end state and a sparse 75.0 surcharge.
    T_list = [len(p.tris) for p in pws]
    T_pad = -(-max(T_list) // 128) * 128
    m = max(len(p.ref_coords) for p in pws)
    tris = np.zeros((B, T_pad, 3), np.int32)
    src = np.zeros((B, T_pad), np.int32)
    ref_xy = np.zeros((B, m, 2), np.float32)
    for b, p in enumerate(pws):
        tris[b, :T_list[b]] = p.tris
        src[b, :T_list[b]] = p.source_signs
        ref_xy[b, :len(p.ref_coords)] = p.ref_coords
    rng = np.random.default_rng(1)
    extra = np.zeros((B, n_pad, C), np.float32)
    extra[rng.random((B, n_pad, C)) < 0.01] = 75.0

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    tri_mask = up(np.arange(T_pad)[None, :] < np.asarray(T_list)[:, None], torch.bool)
    k6_args = (st["costs"], up(extra, torch.float32), st["slots"], st["valid"], st["nm"],
               st["pair_idx"], st["cand_ref"], up(tris, torch.int32), tri_mask,
               up(src, torch.int32), up(ref_xy, torch.float32), k.prices, k.choice)
    got = tear_metrics_batch(*k6_args)
    plain = tear_metrics_batch_plain(*k6_args)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("checked", "flipped", "vmove"), got, plain):
        require_equal(f"K6 (d) {name} vs plain", a, b_)
    pairs6 = list(zip(got, plain))
    for b in range(B):
        T = T_list[b]
        one_k2 = tear_metrics(*(x[b] for x in k6_args[:7]), k6_args[7][b, :T],
                              k6_args[8][b, :T], k6_args[9][b, :T],
                              up(pws[b].ref_coords, torch.float32), k.prices[b], k.choice[b])
        torch.cuda.synchronize()
        for name, a, b_ in zip(("checked", "flipped", "vmove"), got, one_k2):
            require_equal(f"K6 (d) window {b} {name} vs K2", a[b, :T], b_)
            pairs6.append((a[b, :T], b_))
        require(not bool(got[0][b, T:].any()), f"K6 (d) window {b}: a padded triangle checked")
    t6 = median_ms(lambda: tear_metrics_batch(*k6_args))
    t6_p = median_ms(lambda: tear_metrics_batch_plain(*k6_args), reps=10, warmup=1)
    n6 = tensor_bytes(*k6_args, *got)
    b6 = bound_ms(n6)
    err6 = max_abs_diff(pairs6)
    log(f"[phase 6] (d) K6 on {B} windows, T = {T_list} padded to {T_pad}: bit-equal to "
        f"{B} solo K2 launches and to the plain version (max abs err {err6}); {int(got[0].sum())} checked, "
        f"{int(got[1].sum())} flipped; kernel {t6:.4f} ms (median of 60), plain {t6_p:.3f} ms "
        f"(median of 10); bound {n6 / 1e6:.3f} MB = {b6 * 1e3:.3f} us; {smi_line}")
    out["k6"] = {"err": err6, "ms": t6, "plain_ms": t6_p, "bound_ms": b6}
    out.update(batch_tear_round(pws, k6_args, got, k.choice, T_list, T_pad, device, smi_line))

    # (e) Each batch of the mesh run against solo loops given its budget.
    n_solo = 0
    for bt in spy.batches:
        problems, tris_l, tw_l, src_l, ref_l = bt["args"]
        kw6 = bt["kwargs"]
        for b, data in enumerate(bt["datas"]):
            require(not data["time_limit_reached"], "(e): the batch hit its deadline")
            solo_d = run_tearing_device(
                problems[b], tris_l[b], tw_l[b], src_l[b], ref_l[b],
                kw6["delaunay_penalties"][b], kw6["allowed_flip_fractions"][b],
                penalty_coeff=kw6["penalty_coeffs"][b], max_cuts=kw6["max_cuts"],
                max_cuts_per_round=kw6["max_cuts_per_round"],
                max_tear_rounds=kw6["max_tear_rounds"], eps_final=kw6["eps_finals"][b],
                eps_scaling=kw6["eps_scaling"], hard=kw6["hards"][b],
                prices0=kw6["prices0_list"][b], plateau_patience=kw6["plateau_patiences"][b],
                plateau_tol=kw6["plateau_tols"][b], obj_patience=kw6["obj_patience"],
                mip_gap=kw6["mip_gaps"][b], device=device, max_rounds=data["max_rounds"],
                schedule_len=data["schedule_len"],
            )
            require(solo_d["rounds_used"] == data["rounds_used"],
                    f"(e) window {b}: {data['rounds_used']} tear rounds batched, "
                    f"{solo_d['rounds_used']} solo")
            for key in ("choices", "flipped", "checked", "auction_rounds"):
                require(np.array_equal(solo_d[key], data[key]),
                        f"(e) window {b}: {key} differ between the batch and the solo loop")
            for key in ("cuts_added", "cut_tris"):
                require(solo_d[key] == data[key], f"(e) window {b}: {key} differ")
            require([list(v) for v in solo_d["cut_pairs"]] == [list(v) for v in data["cut_pairs"]],
                    f"(e) window {b}: cut registries differ")
            n_solo += 1
    log(f"[phase 6] (e) run_tearing_device_batch == run_tearing_device given the batch's "
        f"budget and schedule length, for all {n_solo} windows: identical incumbents before "
        f"repair and cut registries")
    return out


def batch_tear_round(pws, k6_args, k6_out, choice, T_list, T_pad, device, smi_line):
    """K7 and K8 on phase 6's stack (K6's outputs at (a)'s end state) against
    their plain versions, and K7 against each window alone, unpadded."""
    import torch

    from same_tpu_torch.kernels.tear_round import (
        register_cuts, tear_scalars, tear_scalars_plain,
    )

    B = len(pws)
    costs, nm, pair_idx, cand_ref, tris, tri_mask, src = (
        k6_args[i] for i in (0, 4, 5, 6, 7, 8, 9))
    checked, flipped, vmove = k6_out
    tw = np.zeros((B, T_pad), np.float32)
    for b, p in enumerate(pws):
        tw[b, :T_list[b]] = p.tri_weights
    tw = torch.as_tensor(tw).to(device)
    m_list = [len(p.ref_coords) for p in pws]
    m_ref = torch.as_tensor(np.asarray(m_list, np.int32)).to(device)
    ref_xy = k6_args[10]
    k7_args = (costs, nm, choice, cand_ref, ref_xy, m_ref, flipped, checked, tw, tri_mask, src)
    got = tear_scalars(*k7_args)
    plain = tear_scalars_plain(*k7_args)
    # The running windows as a subset, as _batch_round passes them.
    sub = np.arange(B - 1, -1, -2)
    part = tear_scalars(*k7_args, windows=sub)
    part_p = tear_scalars_plain(*k7_args, windows=sub)
    torch.cuda.synchronize()
    require_equal("K7 (g) stack vs plain", got, plain)
    require_equal(f"K7 (g) windows {sub.tolist()} vs plain", part, part_p)
    require_equal(f"K7 (g) windows {sub.tolist()} vs the stack", part, got[torch.as_tensor(sub)])
    for b in range(B):
        T = T_list[b]
        alone = tear_scalars(
            costs[b:b + 1], nm[b:b + 1], choice[b:b + 1], cand_ref[b:b + 1],
            ref_xy[b:b + 1, :m_list[b]], m_ref[b:b + 1],
            *(x[b:b + 1, :T].contiguous() for x in (flipped, checked, tw, tri_mask, src)))
        require_equal(f"K7 (g) window {b} alone vs in the stack", alone[0], got[b])
    dp = np.float32(GRID_OPTIM["delaunay_penalty"])
    surcharge = (tw * torch.tensor(dp, device=device)).contiguous()
    K, L = 6, int(pws[0].problem.n_slot_copies)
    n, C = costs.shape[1:]
    state = (torch.full((B, T_pad, K, 3), -2, dtype=torch.int32, device=device),
             torch.zeros((B, T_pad), dtype=torch.int32, device=device),
             torch.zeros((B, n, C), dtype=torch.float32, device=device))
    args = (tris, surcharge, choice, pair_idx, flipped, vmove)
    reg, done = np.ones(B, bool), np.zeros(B, np.int64)
    kw = dict(L=L, K=K, max_cuts_per_round=1000, max_cuts_total=1 << 30)
    added, _, _ = run_cuts_twice("(g) stack", args, state, reg, done, **kw)
    t7 = median_ms(lambda: tear_scalars(*k7_args))
    work = [t.clone() for t in state]

    def reset():
        for w_, s_ in zip(work, state):
            w_.copy_(s_)

    t8 = timed_reset(reset, lambda: register_cuts(*args, reg, done, *work, **kw))
    log(f"[phase 6] (g) K7 on {B} windows, T = {T_list} padded to {T_pad}: bit-equal to the "
        f"plain version, to each window alone and, on windows {sub.tolist()}, to the stack's "
        f"rows; K8: cuts added {added[0]}, then {added[1]}, "
        f"bit-equal to the plain version; K7 {t7:.4f} ms, K8 {t8:.4f} ms (medians of 60 and "
        f"30); {smi_line}")
    return {"k7_batch": {"ms": t7}, "k8_batch": {"ms": t8}}


# ----------------------------------------------------------------------------
# Phase 5: the synthetic tissue (the host separation loop)
# ----------------------------------------------------------------------------

def phase5():
    """Seed 8899 through run_same with examples/run_synthetic.py's parameters."""
    import torch

    from same_tpu_torch import create_full_benchmark, greedy_triangle_collapse, run_same
    from same_tpu_torch.kernels import auction_loop

    ref_df, query_df, _quadrants, _gt, _expr = create_full_benchmark(seed=8899)
    mc_align = greedy_triangle_collapse(
        query_df, cell_type_col="cell_type", original_idx_col="cell_idx",
        x_col="X", y_col="Y", max_metacell_size=1, r_max=5, min_angle_deg=5,
        return_object=True, verbose=False,
    )
    ref_in = ref_df.copy()
    ref_in["metacell_id"] = np.arange(len(ref_in))
    before = auction_loop.launches
    t0 = time.time()
    matches, var_out = run_same(
        ref_df=ref_in, aligned_df=mc_align, commonCT=["c1", "c2", "c3"],
        optim_params=dict(
            max_matches=2, radius=5, knn=8, no_match_penalty=10000,
            dist_ct_coeff=1, min_angle_deg=5, penalty_coeff=100,
            delaunay_penalty=10.0, cell_id_col="metacell_id",
            ref_metacell_match_multiplier=1, ignore_same_type_triangles=False,
        ),
        solver_params=dict(mip_gap=0.025, lazy_allowed_flip_fraction=0.0),
        verbose=False,
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    acc = float((
        query_df["cell_type"].to_numpy()[matches["Aligned_metacell_id"]]
        == ref_df["cell_type"].to_numpy()[matches["Ref_metacell_id"]]
    ).mean())
    tri = var_out["triangle_data"]
    tpu = var_out["tpu"]
    summary = {
        "matches": int(len(matches)), "query_cells": int(len(query_df)),
        "cell_type_accuracy": acc,
        "triangles_flipped": len(tri["flipped_triangles"]),
        "total_triangles": int(len(tri["triangles"])),
        "violation_nodes": int(matches["triangle_violation"].sum()),
        "objective": float(tpu["objective"]), "tear_rounds": int(tpu["tear_rounds"]),
        "auction_launches": auction_loop.launches - before, "wall_s": wall,
        "stage_times_s": {k: round(float(v), 3) for k, v in tpu["stage_times"].items()},
    }
    log("[phase 5] synthetic seed 8899 (JAX quality record, "
        "examples/results/synthetic_dp10.json: 372 matches, 100 % accuracy, 26 of 698 "
        "triangles flipped, 54 violation nodes): " + json.dumps(summary))
    require(summary["auction_launches"] > 0, "synthetic: auction_loop never launched")
    require(matches["Aligned_metacell_id"].is_unique, "synthetic: an aligned cell matched twice")
    require(np.isfinite(summary["objective"]), "synthetic: objective is not finite")
    require(summary["matches"] >= 0.95 * 372 and acc >= 0.95,
            f"synthetic: {summary['matches']} matches at accuracy {acc}")
    return summary


def profile_solve(pw, device, out_dir):
    """torch.profiler over one auction solve on the window; table + trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from same_tpu_torch.models.assignment import to_device
    from same_tpu_torch.solver.auction import solve_assignment

    pd = to_device(pw.problem, device)

    def solve(max_rounds):
        return solve_assignment(
            pd, eps_final=pw.eps_solver, prices0=pw.prices0, return_raw=True,
            obj_patience=128, max_rounds=max_rounds,
        )

    solve(500000)
    torch.cuda.synchronize()
    t0 = time.time()
    res = solve(500000)
    torch.cuda.synchronize()
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(500000)
        torch.cuda.synchronize()
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy_us = sum(dev_us(e) for e in ka)
    rows = sorted(ka, key=dev_us, reverse=True)[:12]
    log(f"[profile] auction solve: {res.rounds} rounds, {wall:.3f}s wall unprofiled; "
        f"device busy {busy_us / 1e6:.3f}s = {100 * busy_us / 1e6 / wall:.1f} % of it")
    for e in rows:
        log(f"[profile]   {e.key[:60]:60s} calls {e.count:7d}  device {dev_us(e) / 1e3:9.1f} ms  "
            f"cpu {e.self_cpu_time_total / 1e3:9.1f} ms")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "auction_solve_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(200)
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "auction_200_rounds_trace.json"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, default=LUAD_CELLS,
                    help="cells a side of the window (debugging; default 25000)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one auction solve on the window into DIR")
    ap.add_argument("--no-slice", action="store_true",
                    help="stop after phases 2 and 7 (debugging; ends with \"ok\": false)")
    ap.add_argument("--grid-only", action="store_true",
                    help="phases 0-1, the K3 and K4 checks of phase 2, and phases 4 "
                         "and 6 (debugging; ends with \"ok\": false)")
    ap.add_argument("--synthetic", action="store_true",
                    help="also run phase 5, the seed-8899 synthetic tissue (about 3 "
                         "minutes more)")
    args = ap.parse_args()

    import torch

    name, smi_line = phase0()
    sys.path.insert(0, HERE)
    require(os.path.isdir(os.path.join(HERE, "same_tpu_torch")),
            f"no same_tpu_torch package next to {__file__}: run from a checkout")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase1()

    mc_ref, mc_align, types = luad_window(args.cells)
    from same_tpu_torch import prepare_window

    t0 = time.time()
    pw = prepare_window(mc_ref.metacell_df, mc_align, types, optim_params=OPTIM,
                        solver_params=SOLVER, verbose=False)
    log(f"[setup] prepare_window: n_pad, C = {list(pw.problem.costs.shape)}, "
        f"S = {pw.problem.n_slots}, T = {len(pw.tris)}, {time.time() - t0:.1f}s")

    log(f"[phase 2] kernels against their twins on {smi_line}")
    k3 = phase2_knn(mc_ref, mc_align, device, smi_line)
    k4 = phase2_sinkhorn(pw, device, smi_line)
    not_ok = json.dumps({"ok": False, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}})
    if args.grid_only:
        mc_gref, mc_galign = grid_tissue(smi_line)
        grid = phase4(mc_gref, mc_galign)
        phase6(mc_gref, mc_galign, grid[0], pw, device, smi_line)
        if args.synthetic:
            phase5()
        print(smi_line)
        print(not_ok)
        return 2
    k1_rand = phase2_k1_random(device)
    k1_win, k2_win, first_solve = phase2_window(pw, device)
    tear = phase2_tear_round(pw, first_solve, device, smi_line)
    k9 = phase2_bid_compute(device, smi_line)
    k10 = phase2_sinkhorn_dense(device, smi_line)
    loop = phase2_loop(pw, device, smi_line)
    phase2_small_window(device)
    _bench, bench_launches = phase7(smi_line)
    if args.profile:
        profile_solve(pw, device, args.profile)
    if args.no_slice:
        print(smi_line)
        print(not_ok)
        return 2
    summary = phase3(mc_ref, mc_align, types, full=args.cells == LUAD_CELLS,
                     obj_lb=pw.obj_lb, smi_line=smi_line)
    mc_gref, mc_galign = grid_tissue(smi_line)
    grid = phase4(mc_gref, mc_galign)
    batched = phase6(mc_gref, mc_galign, grid[0], pw, device, smi_line)
    if args.synthetic:
        phase5()
    grid_launches = {label: run["launches"] for (label, _s, _d), run in zip(GRID_RUNS, grid)}

    a = loop["a"]
    kernels = [
        {
            "name": "auction_loop", "route": "cuda",
            "source": "same_tpu_torch/csrc/auction_loop.cu",
            "replaces": "same_tpu/solver/auction.py:66",
            "launches": summary["launches"]["auction_loop"],
            "max_abs_err": max(c["err"] for c in loop.values()),
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "cases": {k: {kk: c[kk] for kk in ("ms", "plain_ms", "bound_ms", "rounds")}
                      for k, c in loop.items()},
        },
        {
            "name": "auction_bid", "route": "cuda",
            "source": "same_tpu_torch/csrc/auction_bid.cu",
            "replaces": "same_tpu/solver/auction.py:256",
            "launches": summary["launches"]["auction_bid"],
            "max_abs_err": max(k1_rand[0], k1_win[0]),
            "ms": k1_win[1], "plain_ms": k1_win[2], "bound_ms": k1_win[3],
            "bound_by": "bytes", "library_ms": None,
            "ms_bench_shape": k1_rand[1], "plain_ms_bench_shape": k1_rand[2],
            "bound_ms_bench_shape": k1_rand[3],
        },
        {
            "name": "tear_metrics", "route": "cuda",
            "source": "same_tpu_torch/csrc/tear_metrics.cu",
            "replaces": "same_tpu/solver/tearing.py:73",
            "launches": summary["launches"]["tear_metrics"],
            "max_abs_err": k2_win[0], "ms": k2_win[1], "plain_ms": k2_win[2],
            "bound_ms": k2_win[3], "bound_by": "bytes", "library_ms": None,
        },
        # K3 and K4 run only where a window selects them: their launches are
        # those of the grid's third run. No single PyTorch call computes
        # either (cdist and topk are two, with another rounding; Sinkhorn is
        # a loop of many).
        {
            "name": "radius_knn", "route": "cuda",
            "source": "same_tpu_torch/csrc/radius_knn.cu",
            "replaces": "same_tpu/ops/pairwise.py:20",
            "launches": grid[2]["launches"]["radius_knn"],
            "max_abs_err": k3["err"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
            "rows_differing_from_ckdtree": k3["rows_differing_from_ckdtree"],
        },
        {
            "name": "sinkhorn_sparse", "route": "cuda",
            "source": "same_tpu_torch/csrc/sinkhorn_sparse.cu",
            "replaces": "same_tpu/ops/sinkhorn.py:57",
            "launches": grid[2]["launches"]["sinkhorn_sparse"],
            "max_abs_err": k4["err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"], "library_ms": None,
            "bit_equal_to_plain": k4["bit_equal"],
        },
    ]
    # K5 and K6 run on the batched path: their launches are those of the
    # mesh grid (phase 6 (f)); their times are at its largest batch.
    mesh_launches = batched["mesh"]["launches"]
    k5, k6 = batched["k5"], batched["k6"]
    kernels += [
        {
            "name": "auction_loop_batch", "route": "cuda",
            "source": "same_tpu_torch/csrc/auction_loop.cu",
            "replaces": "same_tpu/solver/tearing_device.py:710",
            "also_replaces": "same_tpu/parallel/shard.py:120",
            "launches": mesh_launches["auction_loop_batch"],
            "max_abs_err": k5["err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
            "bound_ms": k5["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "windows": k5["windows"], "solo_launches_ms": k5["solo_ms"],
            "rounds": k5["rounds"], "grid_per_window": k5["grid"],
            "windows_per_launch": k5["windows_per_launch"],
        },
        {
            "name": "tear_metrics_batch", "route": "cuda",
            "source": "same_tpu_torch/csrc/tear_metrics.cu",
            "replaces": "same_tpu/solver/tearing_device.py:710",
            "also_replaces": "same_tpu/solver/tearing_device.py:124",
            "launches": mesh_launches["tear_metrics_batch"],
            "max_abs_err": k6["err"], "ms": k6["ms"], "plain_ms": k6["plain_ms"],
            "bound_ms": k6["bound_ms"], "bound_by": "bytes", "library_ms": None,
        },
    ]
    # K7 and K8 run in both tear loops: their launches are the main path's
    # (phase 3), with the grid's and the mesh grid's beside them. K9 runs in
    # the microbenchmark (phase 7), K10 through its op (phase 2).
    k7, k8 = tear["k7"], tear["k8"]
    kernels += [
        {
            "name": "tear_scalars", "route": "cuda",
            "source": "same_tpu_torch/csrc/tear_round.cu",
            "replaces": "same_tpu/solver/tearing_device.py:146",
            "launches": summary["launches"]["tear_scalars"],
            "max_abs_err": k7["err"], "ms": k7["ms"], "plain_ms": k7["plain_ms"],
            "bound_ms": k7["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "launches_in_mesh_grid": mesh_launches["tear_scalars"],
            "ms_mesh_batch": batched["k7_batch"]["ms"],
        },
        {
            "name": "register_cuts", "route": "cuda",
            "source": "same_tpu_torch/csrc/tear_round.cu",
            "replaces": "same_tpu/solver/tearing_device.py:210",
            "launches": summary["launches"]["register_cuts"],
            "max_abs_err": k8["err"], "ms": k8["ms"], "plain_ms": k8["plain_ms"],
            "bound_ms": k8["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "launches_in_mesh_grid": mesh_launches["register_cuts"],
            "ms_mesh_batch": batched["k8_batch"]["ms"],
        },
        {
            "name": "bid_compute", "route": "cuda",
            "source": "same_tpu_torch/csrc/bid_compute.cu",
            "replaces": "examples/bench_pallas.py:122",
            "launches": bench_launches["bid_compute"],
            "max_abs_err": max(c["err"] for c in k9.values()),
            "ms": k9[8]["ms"], "plain_ms": k9[8]["plain_ms"], "bound_ms": k9[8]["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "ms_c24": k9[24]["ms"], "plain_ms_c24": k9[24]["plain_ms"],
            "bound_ms_c24": k9[24]["bound_ms"],
        },
        {
            "name": "sinkhorn_dense", "route": "cuda",
            "source": "same_tpu_torch/csrc/sinkhorn_dense.cu",
            "replaces": "same_tpu/ops/sinkhorn.py:27",
            "launches": k10["launches"],
            "max_abs_err": k10["err"], "plain_max_abs_err": k10["plain_err"],
            "ms": k10["ms"], "plain_ms": k10["plain_ms"], "bound_ms": k10["bound_ms"],
            "bound_by": k10["bound_by"], "library_ms": k10["library_ms"],
        },
    ]
    for kern in kernels[:3] + kernels[-4:-2]:
        kern["launches_in_grid"] = {label: l[kern["name"]] for label, l in grid_launches.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    ok = args.cells == LUAD_CELLS
    print(json.dumps({"ok": ok, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0 if ok else 2


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
