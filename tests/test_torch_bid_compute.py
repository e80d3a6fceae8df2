"""Port parity: K9 ``bid_compute`` by its plain version, and the port's
microbenchmark, on the CPU.

``bid_compute_plain`` is held bit for bit to a copy of the Pallas kernel
body of ``examples/bench_pallas.py:98-120`` run through
``pl.pallas_call(..., interpret=True)`` on JAX's CPU backend, and to the
expression of its XLA twin ``compute_xla`` (``:80-88``), on
``examples/bench_pallas.py``'s random instance at n = 2,048 and C = 8 and 24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from same_tpu_torch import microbench
from same_tpu_torch.kernels.bid_compute import bid_compute, bid_compute_plain

import torch_parity  # noqa: F401  (one torch thread per xdist worker)

TILE = 1024
NEG = -3.0e38


def pallas_compute(costs, p_slot, valid, nm):
    """The Pallas kernel of examples/bench_pallas.py, in interpret mode."""
    n, C = costs.shape

    def kernel(costs_ref, pslot_ref, valid_ref, nm_ref, choice_ref, incr_ref):
        c = costs_ref[...]
        p = pslot_ref[...]
        v = valid_ref[...]
        vals = jnp.where(v, -(c + p), NEG)
        best = jnp.full((TILE,), NEG, jnp.float32)
        second = jnp.full((TILE,), NEG, jnp.float32)
        bidx = jnp.zeros((TILE,), jnp.int32)
        for k in range(C):
            vk = vals[:, k]
            better = vk > best
            second = jnp.where(better, best, jnp.maximum(second, vk))
            bidx = jnp.where(better, k, bidx)
            best = jnp.where(better, vk, best)
        vnm = -nm_ref[...]
        better = vnm > best
        second = jnp.where(better, best, jnp.maximum(second, vnm))
        bidx = jnp.where(better, C, bidx)
        best = jnp.where(better, vnm, best)
        incr = best - jnp.where(second > NEG, second, best - 1.0) + 1.0
        choice_ref[...] = bidx
        incr_ref[...] = incr

    call = pl.pallas_call(
        kernel,
        grid=(n // TILE,),
        in_specs=[
            pl.BlockSpec((TILE, C), lambda i: (i, 0)),
            pl.BlockSpec((TILE, C), lambda i: (i, 0)),
            pl.BlockSpec((TILE, C), lambda i: (i, 0)),
            pl.BlockSpec((TILE,), lambda i: (i,)),
        ],
        out_specs=[
            pl.BlockSpec((TILE,), lambda i: (i,)),
            pl.BlockSpec((TILE,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.float32),
        ],
        interpret=True,
    )
    return call(costs, p_slot, valid, nm)


def xla_compute(costs, p_slot, valid, nm):
    """compute_xla of examples/bench_pallas.py:80-88 (eps = 1)."""
    vals = jnp.where(valid, -(costs + p_slot), -jnp.inf)
    vals_all = jnp.concatenate([vals, -nm[:, None]], axis=1)
    top2, top2i = jax.lax.top_k(vals_all, 2)
    v1, v2 = top2[:, 0], top2[:, 1]
    incr = v1 - jnp.where(jnp.isfinite(v2), v2, v1 - 1.0) + jnp.float32(1.0)
    return top2i[:, 0].astype(jnp.int32), incr


def step_inputs(C, n=2048):
    x = microbench.instance(n, C, torch.device("cpu"))
    p_slot = x["prices"][x["slots"].long()]
    # Every column of a few rows invalid, and a few no-match costs below the
    # best value: the no-match column wins there.
    x["valid"][:8] = False
    x["nm"][8:16] = 1.0
    return x["costs"], p_slot, x["valid"], x["nm"]


@pytest.mark.parametrize("reference", ["pallas", "xla"])
@pytest.mark.parametrize("C", [8, 24])
def test_bid_compute_plain_bit_equal(C, reference):
    args = step_inputs(C)
    choice, incr = bid_compute_plain(*args)
    fn = pallas_compute if reference == "pallas" else jax.jit(xla_compute)
    want_choice, want_incr = fn(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_choice))
    np.testing.assert_array_equal(incr.numpy().view(np.int32),
                                  np.asarray(want_incr).view(np.int32))
    assert (choice.numpy() == C).any() and (choice.numpy() < C).any()


def test_bid_compute_runs_plain_on_cpu():
    args = step_inputs(8)
    for a, b in zip(bid_compute(*args), bid_compute_plain(*args)):
        assert torch.equal(a, b)


def test_microbench_runs_on_cpu_when_asked(capsys):
    results = microbench.main(["--n", "1024", "--iters", "2", "--device", "cpu"])
    assert set(results) == {"full_round_kernel", "full_round_plain", "gather_only",
                            "compute_plain", "compute_kernel"}
    assert all(v > 0 for v in results.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "n=1024 C=8 device=cpu" and len(lines) == 5


def test_microbench_needs_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        microbench.main(["--n", "1024", "--iters", "1"])
