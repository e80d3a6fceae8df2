"""The port's entry points run on the card unless asked for the CPU.

With ``torch.cuda.is_available`` patched to False (so the test means the same
on a machine with a card), each entry point called without ``device`` raises
a RuntimeError that names the fix, and called with ``device="cpu"`` returns.
"""

import numpy as np
import pytest
import torch

import same_tpu_torch
from same_tpu_torch.models.assignment import build_assignment_problem, default_device
from same_tpu_torch.solver.auction import solve_assignment
from same_tpu_torch.solver.tearing import solve_with_tearing
from same_tpu_torch.solver.tearing_device import run_tearing_device
from test_tearing import _swap_instance
from torch_parity import labeled_window, run_window


def _tear_args():
    pairs, costs, n, limits, nm, tris, w, src, ref_xy = _swap_instance(
        np.random.default_rng(0)
    )
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)
    return problem, costs, tris, w, src, ref_xy


def _run_same(**kw):
    ref, qry = labeled_window(n_side=5)
    matches, var_out = run_window(same_tpu_torch, ref, qry, **kw)
    assert np.isfinite(var_out["tpu"]["objective"])
    return matches


def _solve_assignment(**kw):
    problem = _tear_args()[0]
    match_ref, _, info = solve_assignment(problem, eps_final=1e-3, **kw)
    assert info["rounds"] > 0
    return match_ref


def _solve_with_tearing(**kw):
    problem, costs, tris, w, src, ref_xy = _tear_args()
    res = solve_with_tearing(
        problem, costs, tris, w, src, ref_xy, delaunay_penalty=1.0,
        penalty_coeff=100.0, eps_final=1e-3, max_tear_rounds=2, **kw,
    )
    assert np.isfinite(res.objective)
    return res


def _run_tearing_device(**kw):
    problem, _costs, tris, w, src, ref_xy = _tear_args()
    data = run_tearing_device(
        problem, tris, w, src, np.asarray(ref_xy, np.float32),
        delaunay_penalty=1.0, allowed_flip_fraction=0.0, eps_final=1e-3,
        max_tear_rounds=2, **kw,
    )
    assert data["rounds_used"] >= 1
    return data


ENTRY_POINTS = {
    "run_same": _run_same,
    "solve_assignment": _solve_assignment,
    "solve_with_tearing": _solve_with_tearing,
    "run_tearing_device": _run_tearing_device,
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_needs_card_by_default(no_card, entry):
    kw = {"device": None} if entry == "run_same" else {}
    with pytest.raises(RuntimeError, match="CUDA card"):
        ENTRY_POINTS[entry](**kw)


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_runs_on_cpu_when_asked(no_card, entry):
    assert ENTRY_POINTS[entry](device="cpu") is not None
