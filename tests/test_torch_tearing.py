"""Port parity: solve_with_tearing, host loop and fused loop.

The _swap_instance grids of tests/test_tearing.py go through the JAX package
and through same_tpu_torch (K1 and K2 by their plain twins). Each loop is
pinned: ``device_loop=False`` (the host separation loop) and ``"force"``
(the fused loop). Per round, choices, flipped, checked and auction rounds
are identical, the cut registry is the same, and the final objective agrees
to rel 1e-6. The repair budget is large enough for HiGHS to finish, so the
wall-clock-budgeted repair lands on the same point in both.
"""

import numpy as np
import pytest

import same_tpu.solver.tearing as jax_tearing
import same_tpu_torch.solver.tearing as torch_tearing
from same_tpu.models.assignment import build_assignment_problem
from test_tearing import _swap_instance
from torch_parity import assert_same_incumbents, capture_finish

CASES = {
    "dp1": (1.0, {}),
    "dp5_three_swaps": (5.0, dict(n_swaps=3)),
}


@pytest.mark.parametrize("device_loop", [False, "force"], ids=["host_loop", "fused_loop"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_with_tearing_parity(monkeypatch, case, device_loop):
    dp, kw = CASES[case]
    rng = np.random.default_rng(0)
    pairs, costs, n, limits, nm, tris, w, src, ref_xy = _swap_instance(rng, **kw)
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)
    results = {}
    for name, module, dev in (
        ("jax", jax_tearing, {}), ("torch", torch_tearing, {"device": "cpu"}),
    ):
        calls = capture_finish(monkeypatch, module)
        res = module.solve_with_tearing(
            problem, costs, tris, w, src, ref_xy, delaunay_penalty=dp,
            penalty_coeff=100.0, allowed_flip_fraction=0.0, eps_final=1e-3,
            device_loop=device_loop, repair_budget=120.0, **dev,
        )
        results[name] = (res, calls[-1])
    (rj, cj), (rt, ct) = results["jax"], results["torch"]
    assert len(cj["incumbents"]) >= 2  # the loop really separated
    assert cj["cuts_added"] > 0
    assert_same_incumbents(ct, cj)
    assert rt.objective == pytest.approx(rj.objective, rel=1e-6)
    assert rt.tear_rounds == rj.tear_rounds
    np.testing.assert_array_equal(rt.match_ref, rj.match_ref)
    np.testing.assert_array_equal(rt.flipped, rj.flipped)
    assert rt.info["auction_rounds_total"] == rj.info["auction_rounds_total"]


def test_fused_loop_round_data():
    """run_tearing_device returns the same per-round arrays as JAX's."""
    from same_tpu.solver.tearing_device import run_tearing_device as jax_run
    from same_tpu_torch.solver.tearing_device import run_tearing_device as torch_run

    rng = np.random.default_rng(0)
    pairs, costs, n, limits, nm, tris, w, src, ref_xy = _swap_instance(rng, n_swaps=3)
    problem = build_assignment_problem(pairs, costs, n, n, limits, 100.0, nm)
    kw = dict(delaunay_penalty=5.0, allowed_flip_fraction=0.0, penalty_coeff=100.0,
              eps_final=1e-3)
    ref32 = np.asarray(ref_xy, np.float32)
    want = jax_run(problem, tris, w, src, ref32, **kw)
    got = torch_run(problem, tris, w, src, ref32, device="cpu", **kw)
    assert got["rounds_used"] == want["rounds_used"] >= 2
    assert got["cuts_added"] == want["cuts_added"]
    for key in ("choices", "flipped", "checked", "auction_rounds"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    assert got["cut_tris"] == want["cut_tris"]
    for a, b in zip(got["cut_pairs"], want["cut_pairs"]):
        np.testing.assert_array_equal(a, b)
