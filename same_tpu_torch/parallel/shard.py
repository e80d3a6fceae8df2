"""Window batches: many same-bucket windows solved together, over a mesh.

Port of ``same_tpu/parallel/shard.py``. Windows are embarrassingly parallel:
problems padded to shared shape buckets (models/assignment.py) are stacked on
a leading batch axis, and the solve runs once for the whole batch instead of
once a window. Where the JAX package vmaps the solver and lays the batch axis
over a ``jax.sharding.Mesh``, the port puts the batch into the launch grid of
its kernels (K5 ``auction_loop_batch``, K6 ``tear_metrics_batch``) and takes
a mesh to be a sequence of ``torch.device``s: the padded batch is cut into
contiguous shards, one a device. Nothing crosses devices until the
host-side merge (windows.merge_window_matches_unique_ref).

``make_mesh`` lists the CUDA cards and raises without one. The tests pass
``[torch.device("cpu")]`` or eight of it, which runs the kernels' plain
versions; on the card only the one-device mesh has been run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kernels.auction_loop import auction_loop_batch
from ..models.assignment import AssignmentProblem, default_device
from ..solver.auction import make_eps_schedule, natural_stop_args
from ..solver.tearing_device import mesh_devices


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` CUDA cards (all of them by default) as a mesh.

    Raises ``RuntimeError`` when there is no card, as ``default_device``
    does: a mesh of CPUs is built by hand (``[torch.device("cpu")] * 8``).
    """
    default_device()
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devices if n_devices is None else devices[:n_devices]


def stack_problems(problems: Sequence[AssignmentProblem]):
    """Stack same-shape problems into batched arrays.

    All problems must share (n, C) and n_slots — guaranteed for windows that
    fall into the same shape bucket.
    """
    shapes = {(p.costs.shape, p.n_slots) for p in problems}
    if len(shapes) != 1:
        raise ValueError(f"problems span multiple shape buckets: {shapes}")
    costs = np.stack([p.costs for p in problems])
    slots = np.stack([p.slots for p in problems])
    valid = np.stack([p.valid for p in problems])
    nm = np.stack([p.nm_cost for p in problems])
    P_max = max(p.slot_rows.shape[1] for p in problems)

    def pad_P(a, fill):
        out = np.full((a.shape[0], P_max), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    slot_rows = np.stack([pad_P(p.slot_rows, -1) for p in problems])
    slot_cols = np.stack([pad_P(p.slot_cols, 0) for p in problems])
    return costs, slots, valid, nm, slot_rows, slot_cols


def solve_window_batch(
    problems: Sequence[AssignmentProblem],
    mesh=None,
    eps_final: float = 1e-2,
    eps_scaling: float = 4.0,
    max_rounds: int = 500000,
    extra_costs: Optional[np.ndarray] = None,
):
    """Solve a batch of window assignment problems, sharded over ``mesh``.

    Returns per-problem ``(match_ref, match_pair)`` lists plus raw choices.
    With a mesh the batch is padded to a multiple of its size with copies of
    the last problem (discarded on return). Every window starts cold from
    zero prices on one epsilon schedule sized from the batch's largest cost
    scale, with the stall stop on at patience 128 (the JAX package's settings,
    ROADMAP C2); each device solves its shard with one K5 call.
    """
    B = len(problems)
    devices = mesh_devices(mesh)
    costs, slots, valid, nm, slot_rows, slot_cols = stack_problems(problems)
    if extra_costs is not None:
        costs = costs + np.asarray(extra_costs, dtype=costs.dtype)

    finite = costs[valid]
    scale = [float(np.max(nm, initial=0.0))]
    if finite.size:
        scale.append(float(finite.max() - finite.min()))
    eps_schedule = make_eps_schedule(max(scale + [1.0]), eps_final, eps_scaling)

    n_dev = len(devices)
    pad = (-B) % n_dev if mesh is not None else 0
    keep = np.minimum(np.arange(B + pad), B - 1)
    n_local = (B + pad) // n_dev
    S = problems[0].n_slots
    obj_args = natural_stop_args(costs.shape[1], eps_final)

    choices, prices, rounds = [], [], []
    for d, dev in enumerate(devices):
        idx = keep[d * n_local:(d + 1) * n_local]

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a[idx]), dtype=dtype).to(dev)

        res = auction_loop_batch(
            up(costs, torch.float32), up(slots, torch.int32), up(valid, torch.bool),
            up(nm, torch.float32),
            torch.zeros((len(idx), S + 1), dtype=torch.float32, device=dev),
            np.tile(eps_schedule, (len(idx), 1)), max_rounds,
            slot_rows=up(slot_rows, torch.int32), slot_cols=up(slot_cols, torch.int32),
            obj_patience=obj_args[0], obj_tol=obj_args[1],
        )
        choices.append(res.choice.cpu().numpy())
        prices.append(res.prices.cpu().numpy())
        rounds.append(res.rounds)

    choices = np.concatenate(choices)[:B]
    prices = np.concatenate(prices)[:B]
    out = []
    for b, p in enumerate(problems):
        n, C = p.costs.shape
        ch = choices[b][: p.n_aligned]
        col = np.clip(ch, 0, C - 1)
        rows = np.arange(p.n_aligned)
        is_match = ch < C
        match_ref = np.where(is_match, p.cand_ref[rows, col], -1).astype(np.int64)
        match_pair = np.where(is_match, p.pair_idx[rows, col], -1).astype(np.int64)
        out.append((match_ref, match_pair))
    return out, {"choices": choices, "prices": prices,
                 "rounds": np.concatenate(rounds)[:B].astype(np.int32)}


def solve_windows_sharded(
    prepared: Sequence,
    mesh=None,
    deadline: Optional[float] = None,
    verbose: bool = False,
) -> List:
    """Run the FULL device solve (auction + tearing separation) for a list of
    PreparedWindows, batched by shape bucket and sharded over ``mesh``.

    The batched replacement for the reference's sequential per-window
    ``model.optimize`` loop (reference src/same.py:507-593): the batched
    fused tearing loop (tearing_device.run_tearing_device_batch) runs every
    window's separation rounds in lockstep; the exact host-side incumbent
    evaluation and local repair then run per window. Returns a list of
    TearingResult aligned with ``prepared``. ``mesh`` None is the first CUDA
    card (raises without one).

    Every window with at least one triangle goes through the batched loop,
    whatever its size; windows whose triangulation is empty (no orientation
    constraints) take the single-window path on the mesh's first device.
    """
    import time as _time

    from ..core import solve_prepared
    from ..solver.tearing import _finish_solve, incumbents_from_device_data
    from ..solver.tearing_device import run_tearing_device_batch

    device = mesh_devices(mesh)[0]
    results: List = [None] * len(prepared)
    groups: dict = {}
    for idx, pw in enumerate(prepared):
        if len(pw.tris) == 0:
            results[idx] = solve_prepared(pw, deadline=deadline, verbose=verbose,
                                          device=device)
            continue
        solver = pw.solver
        # Every solver knob consumed at batch (not per-window) granularity
        # must be part of the key, or one window's setting would silently
        # apply to the whole bucket. Per-window knobs (delaunay_penalty,
        # flip fraction, eps, patience, penalty_coeff, hard) are per-window
        # inputs of the batched loop and need not match.
        key = (
            pw.problem.costs.shape,
            pw.problem.n_slots,
            pw.problem.n_slot_copies,
            solver["lazy_max_cuts"],
            solver["lazy_max_cuts_per_incumbent"],
            solver["tpu_max_tear_rounds"],
            solver["tpu_eps_scaling"],
        )
        groups.setdefault(key, []).append(idx)

    def _run_separation(pws):
        solver0 = pws[0].solver
        # Honor the per-window time_limit contract (reference
        # src/same.py:1245): the batch runs in lockstep, so its deadline is
        # the tightest window deadline in the group.
        batch_deadline = deadline
        for p in pws:
            if p.solver["time_limit"] is not None:
                d = p.t_start + float(p.solver["time_limit"])
                batch_deadline = d if batch_deadline is None else min(
                    batch_deadline, d
                )
        t_sep0 = _time.time()
        datas = run_tearing_device_batch(
            [p.problem for p in pws],
            [p.tris for p in pws],
            [p.tri_weights for p in pws],
            [p.source_signs for p in pws],
            [p.ref_coords for p in pws],
            delaunay_penalties=[
                float(p.optim["delaunay_penalty"]) for p in pws
            ],
            allowed_flip_fractions=[
                (
                    p.solver["lazy_allowed_flip_fraction"]
                    if p.optim["lazy_constraints"]
                    else 0.0
                )
                for p in pws
            ],
            hards=[bool(p.optim["hard_spatial_constraints"]) for p in pws],
            eps_finals=[p.eps_solver for p in pws],
            penalty_coeffs=[float(p.optim["penalty_coeff"]) for p in pws],
            eps_scaling=float(solver0["tpu_eps_scaling"]),
            max_cuts=solver0["lazy_max_cuts"],
            max_cuts_per_round=solver0["lazy_max_cuts_per_incumbent"],
            max_tear_rounds=solver0["tpu_max_tear_rounds"],
            mesh=mesh,
            prices0_list=[p.prices0 for p in pws],
            deadline=batch_deadline,
            # The JAX package's fallbacks (ROADMAP C3), read the same way.
            plateau_patiences=[
                p.solver.get("tpu_tear_patience", 6) for p in pws
            ],
            plateau_tols=[
                p.solver.get("tpu_tear_plateau_tol", 0.0) for p in pws
            ],
            obj_patience=solver0.get("tpu_auction_patience", 128),
            mip_gaps=[
                (
                    float(p.solver["mip_gap"])
                    if p.solver.get("tpu_gap_certificate", True)
                    else None
                )
                for p in pws
            ],
        )
        return datas, t_sep0, _time.time() - t_sep0

    # Bucket-level pipeline: bucket k+1's batched device separation runs on
    # a device thread while bucket k's host finishes (incumbent eval +
    # repair, serialized under HOST_LOCK inside _finish_solve) run here.
    # With one bucket this degenerates to the plain sequential order.
    from concurrent.futures import ThreadPoolExecutor

    group_items = list(groups.items())
    with ThreadPoolExecutor(max_workers=1) as dev_pool:
        sep_futs = [
            dev_pool.submit(_run_separation, [prepared[i] for i in idxs])
            for _key, idxs in group_items
        ]
        finished = _finish_groups(
            group_items, sep_futs, prepared, results, deadline, verbose,
            device, solve_prepared, incumbents_from_device_data, _finish_solve,
        )
    return finished


def _finish_groups(
    group_items, sep_futs, prepared, results, deadline, verbose, device,
    solve_prepared, incumbents_from_device_data, _finish_solve,
):
    for (key, idxs), fut in zip(group_items, sep_futs):
        pws = [prepared[i] for i in idxs]
        datas, t_sep0, t_sep = fut.result()
        if verbose:
            print(
                f"Sharded batch of {len(pws)} windows "
                f"(bucket {key[0]}): separation {t_sep:.2f}s"
            )
        for i, pw, data in zip(idxs, pws, datas):
            inc = incumbents_from_device_data(
                pw.problem, len(pw.tris), data, verbose=False
            )
            res = _finish_solve(
                pw.problem,
                pw.pair_costs,
                pw.tris,
                pw.tri_weights,
                pw.source_signs,
                pw.ref_coords,
                float(pw.optim["delaunay_penalty"]),
                float(pw.optim["penalty_coeff"]),
                bool(pw.optim["hard_spatial_constraints"]),
                deadline,
                inc,
                data["cut_tris"],
                data["cut_verts"],
                data["cut_pairs"],
                data["cuts_added"],
                data["rounds_used"],
                data["time_limit_reached"],
                t_sep0,
                allowed_flip_fraction=(
                    pw.solver["lazy_allowed_flip_fraction"]
                    if pw.optim["lazy_constraints"]
                    else 0.0
                ),
                repair_budget_override=pw.solver.get("tpu_repair_budget"),
                repair_workers=pw.solver.get("tpu_repair_workers"),
                mip_gap=(
                    float(pw.solver["mip_gap"])
                    if pw.solver.get("tpu_gap_certificate", True)
                    else None
                ),
            )
            pw.stage_times["solve"] = t_sep / max(len(pws), 1)
            for k2 in (
                "separation_time", "repair_time", "incumbent_eval_time",
                "host_queue_time", "device_time",
            ):
                if k2 in res.info:
                    pw.stage_times[k2] = res.info[k2]
            pw.stage_times["separation_time"] = t_sep / max(len(pws), 1)
            if "device_time" in data:
                pw.stage_times["device_time"] = data["device_time"]
            # Gap certification (mirrors solve_prepared): the auction bounds
            # suboptimality by n * eps; on the rare epsilon-sizing miss,
            # re-solve this one window finer through the sequential path.
            n = pw.problem.n_aligned
            gap = float(pw.solver["mip_gap"])
            eps = pw.eps_solver
            lb = max(res.assignment_objective - n * eps, pw.obj_lb)
            if (
                n * eps > gap * lb
                and eps > pw.eps_floor * 1.01
                and not res.info.get("time_limit_reached", False)
            ):
                eps2 = max(
                    pw.eps_floor, gap * lb / max(n, 1) / 1.5 if lb > 0 else 0.0
                )
                if eps2 < eps * 0.7:
                    if verbose:
                        print(
                            f"Window {i}: gap not certified "
                            f"(n*eps={n * eps:.4g} > {gap:.2g}*lb="
                            f"{gap * lb:.4g}); re-solving at eps={eps2:.3g}"
                        )
                    pw.eps_solver = eps2
                    res2 = solve_prepared(pw, deadline=deadline, verbose=False,
                                          device=device)
                    if res2.objective <= res.objective:
                        res = res2
                    res.info["eps_retry"] = eps2
            results[i] = res
    return results
