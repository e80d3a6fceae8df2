"""Entry ``run_same``: one window a call through the program's window solve.

A call runs the three stages that ``same_tpu_torch.run_same`` is made of
(``prepare_window``, ``solve_prepared``, ``finalize_window``), each in a span
of its own. After the window the plain reference judges every call's
matching.
"""

from __future__ import annotations

import numpy as np

from port_bench.reference import window as ref


def _params(ctx, **solver_override):
    optim = dict(ctx.config["optim_params"])
    solver = dict(ctx.config["solver_params"], **solver_override)
    return optim, solver


def warm_up(ctx, inp):
    """One untimed call on the cell's own shapes. The repair budget is 0, so
    that set-up does not wait out the repair's deadline."""
    import same_tpu_torch as stt

    ref_df, aligned_df = inp
    optim, solver = _params(ctx, tpu_repair_budget=0)
    stt.run_same(ref_df, aligned_df, ctx.types, optim_params=optim,
                 solver_params=solver, verbose=False, device=ctx.device)


def call(ctx, inp, spans, record):
    """One timed call; fills ``record`` with what the readers and the judge
    take from the program's output."""
    from same_tpu_torch import core

    ref_df, aligned_df = inp
    optim, solver = _params(ctx)
    try:
        with spans("prepare_window", record):
            pw = core.prepare_window(
                ref_df, aligned_df, ctx.types, optim_params=optim,
                solver_params=solver, verbose=False, device=ctx.device,
            )
    except core.EmptyWindowError:
        matches, var_out = core.empty_matches_df(ctx.types, optim["cell_id_col"]), {}
    else:
        with spans("solve_prepared", record):
            result = core.solve_prepared(pw, verbose=False, device=ctx.device)
        with spans("finalize_window", record):
            matches, var_out = core.finalize_window(pw, result, verbose=False)
    cid = optim["cell_id_col"]
    record["n_aligned"] = len(aligned_df)
    record["aligned_ids"] = matches[f"Aligned_{cid}"].to_numpy()
    record["ref_ids"] = matches[f"Ref_{cid}"].to_numpy()
    tri = var_out.get("triangle_data", {})
    record["triangles"] = np.asarray(tri.get("triangles", np.zeros((0, 3))), np.int64)
    record["flips"] = len(tri.get("flipped_triangles", []))
    record["program"] = {
        k: var_out.get("tpu", {}).get(k)
        for k in ("tear_rounds", "auction_rounds_total", "stage_times", "repair_stats")
    }


def window_of(ctx, inp):
    ref_df, aligned_df = inp
    return ref.build_window(
        ref_df, aligned_df, ctx.types, ctx.config["optim_params"],
        ctx.config["solver_params"]["lazy_allowed_flip_fraction"],
    )


def judge(ctx, inputs, records, picks):
    """Compare the calls ``picks`` with the reference. Returns the numbers
    that ``correct`` compares and the sums that the metrics read."""
    infeasible = tri_differ = flips_differ = 0
    worst_excess = worst_flip_excess = -np.inf
    objective = optimum = 0.0
    for k in picks:
        w = window_of(ctx, inputs[k])
        rec = records[k]
        j = ref.judge(w, rec["aligned_ids"], rec["ref_ids"])
        opt, _ = ref.optimum(w)
        infeasible += j.infeasible
        port_tris = rec["triangles"]
        if len(port_tris) and port_tris.max() >= len(w.aligned_ids):
            tri_differ += len(port_tris) + len(w.tris)
        else:
            mine = {tuple(sorted(t)) for t in w.aligned_ids[port_tris].tolist()}
            theirs = {tuple(sorted(t)) for t in w.aligned_ids[w.tris].tolist()}
            tri_differ += len(mine ^ theirs) + (len(port_tris) - len(mine))
        flips_differ += abs(rec["flips"] - j.flips)
        worst_excess = max(worst_excess, 100.0 * (j.objective - opt) / opt)
        worst_flip_excess = max(worst_flip_excess, j.flip_excess_pct)
        objective += j.objective
        optimum += opt
    checks = {
        "infeasible": infeasible,
        "triangles_differ": tri_differ,
        "flips_differ": flips_differ,
        "excess_pct": worst_excess,
        "flip_excess_pct": worst_flip_excess,
    }
    return checks, {"objective_sum": objective, "optimum_sum": optimum}
