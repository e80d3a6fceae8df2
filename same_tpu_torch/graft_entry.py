"""Twins of the root ``__graft_entry__.py``: a single-device solve check and a
multi-window dry run, on the port.

``entry()`` returns the flagship computation, one window's epsilon-scaling
auction over a padded candidate tensor (``kernels.auction_loop``, one
persistent launch on the card), with example arguments on the device.

``dryrun_multichip(n)`` prepares n small window problems and runs the
batched full solve (auction and tearing separation) over an n-device mesh,
``[device] * n``: on one card its n shards are solved one after the other
(ROADMAP A7). Both run on the first CUDA card and raise without one, unless
given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np


def _example_problem(seed=0, n_side=8):
    """A small window problem from two jittered labeled grids."""
    from .candidates import radius_knn
    from .models.assignment import build_assignment_problem

    rng = np.random.default_rng(seed)
    g = (
        np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1)
        .reshape(-1, 2)
        .astype(float)
    )
    ref = g + rng.normal(0, 0.08, g.shape)
    qry = g + rng.normal(0, 0.08, g.shape)
    types = (g.sum(1) % 2).astype(int)
    idx, dist, mask = radius_knn(qry, ref, radius=2.0, k=4, backend="host")
    pairs, costs = [], []
    for i in range(len(qry)):
        for j, d in zip(idx[i][mask[i]], dist[i][mask[i]]):
            pairs.append((i, int(j)))
            costs.append(100.0 * (types[i] != types[j]) + 0.001 * float(d))
    pairs = np.asarray(pairs)
    costs = np.asarray(costs)
    n = len(qry)
    problem = build_assignment_problem(
        pairs, costs, n, len(ref), np.ones(len(ref), np.int64), 100.0,
        np.full(n, 1000.0),
    )
    return problem, qry, ref


def entry(device=None):
    """(fn, example_args): ``fn(*example_args)`` is one auction solve of the
    example window, returning its ``choice`` on ``device`` (the first CUDA
    card by default)."""
    import torch

    from .kernels.auction_loop import auction_loop
    from .models.assignment import resolve_device, to_device
    from .solver.auction import make_eps_schedule

    dev = resolve_device(device)
    problem, _qry, _ref = _example_problem()
    eps_schedule = make_eps_schedule(1000.0, 1e-2, 4.0)
    prices0 = torch.zeros(problem.n_slots + 1, dtype=torch.float32, device=dev)

    def step(costs, slots, valid, nm_cost, slot_rows, slot_cols):
        res = auction_loop(
            costs, slots, valid, nm_cost, prices0, eps_schedule,
            max_rounds=2000, slot_rows=slot_rows, slot_cols=slot_cols,
        )
        return res.choice

    tp = to_device(problem, dev)
    example_args = (tp.costs, tp.slots, tp.valid, tp.nm_cost, tp.slot_rows, tp.slot_cols)
    return step, example_args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Solve a batch of ``n_devices`` windows over ``[device] * n_devices``
    and print the JAX package's summary line."""
    import pandas as pd

    from .core import prepare_window
    from .models.assignment import resolve_device
    from .parallel import solve_windows_sharded

    dev = resolve_device(device)
    mesh = [dev] * n_devices

    # One full window problem per device, each running the COMPLETE solve
    # (auction + tearing separation).
    prepared = []
    for b in range(n_devices):
        rng = np.random.default_rng(b)
        n_side = 6
        g = (
            np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1)
            .reshape(-1, 2)
            .astype(float)
        )
        types = (g.sum(1) % 2).astype(int)

        def mk(coords):
            df = pd.DataFrame(coords, columns=["X", "Y"])
            df["ct0"] = 100.0 * (types == 0)
            df["ct1"] = 100.0 * (types == 1)
            df["cell_type"] = np.where(types == 0, "ct0", "ct1")
            df["Cell_Num_Old"] = np.arange(len(df))
            return df

        ref_df = mk(g + rng.normal(0, 0.08, g.shape))
        qry = g + rng.normal(0, 0.08, g.shape)
        # Swap two nearby points to force at least one orientation flip.
        qry[[0, 1]] = qry[[1, 0]]
        qry_df = mk(qry)
        prepared.append(
            prepare_window(
                ref_df, qry_df, ["ct0", "ct1"],
                optim_params=dict(radius=2.5, knn=4, delaunay_penalty=5,
                                  no_match_penalty=100),
                # Zero flip budget: every flip generates cuts, so the dry
                # run exercises the full separation loop on every window.
                solver_params=dict(lazy_allowed_flip_fraction=0.0),
                verbose=False,
                device=dev,
            )
        )

    results = solve_windows_sharded(prepared, mesh=mesh, verbose=False)
    if len(results) != n_devices:
        raise RuntimeError(f"dryrun_multichip: {len(results)} results for {n_devices} windows")
    matched = sum(int((r.match_ref >= 0).sum()) for r in results)
    total_flips = sum(int(r.flipped.sum()) for r in results)
    tear_rounds = [r.tear_rounds for r in results]
    print(
        f"dryrun_multichip: {n_devices} devices, {matched} matches, "
        f"{total_flips} flips, tear_rounds={tear_rounds}, "
        f"cuts={[r.cuts_added for r in results]}"
    )
