"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (``device="cpu"``), shrinks
the traffic so that the CPU holds it, and drives the rest of a run: the
warm-up, one timed call, the reference's judgement. The faults: a solve that
returns its state unchanged (nothing assigned), half of the batch left out
(half of a window's rows), an answer altered where it is produced (one
match's reference id in the output), and the host repair skipped
(``faults.py``'s ``repair_skipped``). A one-card cell has no exchange
between chips to leave out.
"""

import dataclasses

import numpy as np
import pytest

from port_bench import faults, run

SEED = 2**33 + 3
WINDOW = {"traffic": {"n_cells": 1500, "extent": 3200},
          "solver_params": {"tpu_repair_budget": 1}}
EXACT = ("infeasible", "triangles_differ", "flips_differ")


def _run(workload, overrides):
    return run.execute(workload, SEED, 0.01, 0, device="cpu", overrides=overrides)


def _unchanged(mr, mp):
    return np.full_like(mr, -1), np.full_like(mp, -1)


def _half(mr, mp):
    mr[len(mr) // 2:] = -1
    mp[len(mp) // 2:] = -1
    return mr, mp


def _break_solve(monkeypatch, change):
    import same_tpu_torch.core as core

    real = core.solve_prepared

    def broken(pw, *args, **kwargs):
        res = real(pw, *args, **kwargs)
        mr, mp = change(res.match_ref.copy(), res.match_pair.copy())
        return dataclasses.replace(res, match_ref=mr, match_pair=mp)

    monkeypatch.setattr(core, "solve_prepared", broken)


def _alter_answer(monkeypatch):
    import same_tpu_torch.core as core

    real = core.finalize_window

    def altered(pw, result, *args, **kwargs):
        out, var_out = real(pw, result, *args, **kwargs)
        if len(out):
            ids = pw.ref_df["metacell_id"].to_numpy()
            col = out.columns.get_loc("Ref_metacell_id")
            out.iloc[0, col] = ids[(np.searchsorted(ids, out.iloc[0, col]) + len(ids) // 2)
                                   % len(ids)]
        return out, var_out

    monkeypatch.setattr(core, "finalize_window", altered)


@pytest.mark.parametrize("workload", ["luad.dp25.window"])
def test_window_faults_come_out_not_correct(workload, monkeypatch):
    sound = _run(workload, WINDOW)
    assert sound["failed"] == 0 and sound["attempted"] == 1
    assert all(sound["checks"][k]["value"] == 0 for k in EXACT)
    for change in (_unchanged, _half):
        with monkeypatch.context() as m:
            _break_solve(m, change)
            assert _run(workload, WINDOW)["correct"] is False, change.__name__
    with monkeypatch.context() as m:
        _alter_answer(m)
        res = _run(workload, WINDOW)
        assert res["correct"] is False and res["checks"]["infeasible"]["value"] > 0
    for fault, groups in faults.FAULTS.items():
        planted = dict(WINDOW, **{g: dict(WINDOW.get(g, {}), **keys)
                                  for g, keys in groups.items()})
        assert _run(workload, planted)["correct"] is False, fault

