"""Port parity: ``same_tpu_torch.ops.sinkhorn.sinkhorn_dense`` on the CPU
(kernel K10's plain version) against ``same_tpu.ops.sinkhorn.sinkhorn_dense``
at the sizes of ``tests/test_sinkhorn.py``, for float32 and float64 input
(numpy's default, which both ops take as float32).

Both packages compute in float32; XLA and PyTorch take the logsumexp's sum
in their own orders, so plans and duals are compared to rtol 1e-4, atol 1e-5
(over 500 iterations at eps 0.05). In float64 the plain version is the
reference the card's kernel is held to; it agrees with the float32 run to
the same tolerance.
"""

import numpy as np
import pytest
import torch

from same_tpu.ops import sinkhorn as sj
from same_tpu_torch.kernels.sinkhorn_dense import sinkhorn_dense, sinkhorn_dense_plain
from same_tpu_torch.ops import sinkhorn as st

import torch_parity  # noqa: F401  (one torch thread per xdist worker)


def uniform_instance(dtype=np.float32):
    """tests/test_sinkhorn.py:7-16: random costs, uniform marginals."""
    rng = np.random.default_rng(0)
    n, m = 16, 20
    cost = rng.uniform(0, 5, (n, m)).astype(dtype)
    return cost, np.full(n, 1.0 / n, dtype), np.full(m, 1.0 / m, dtype)


def float64_instance():
    """The uniform instance in numpy's default dtype: both ops take it as
    float32."""
    return uniform_instance(np.float64)


def diagonal_instance():
    """tests/test_sinkhorn.py:19-28: a strongly diagonal cost."""
    n = 10
    cost = np.full((n, n), 5.0, np.float32)
    np.fill_diagonal(cost, 0.0)
    a = np.full(n, 1.0 / n, np.float32)
    return cost, a, a.copy()


INSTANCES = {"float64_input": float64_instance, "diagonal": diagonal_instance}


@pytest.mark.parametrize("name", list(INSTANCES))
def test_sinkhorn_dense_matches_jax(name):
    cost, a, b = INSTANCES[name]()
    want = sj.sinkhorn_dense(cost, a, b, eps=0.05, n_iters=500)
    got = st.sinkhorn_dense(cost, a, b, eps=0.05, n_iters=500, device="cpu")
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-5)
    plan = got[0].numpy()
    np.testing.assert_allclose(plan.sum(1), a, atol=1e-3)
    np.testing.assert_allclose(plan.sum(0), b, atol=1e-3)
    if name == "float64_input":  # the same bits as the float32 instance's
        got32 = st.sinkhorn_dense(*uniform_instance(), eps=0.05, n_iters=500, device="cpu")
        for x, y in zip(got, got32):
            assert torch.equal(x, y)
    if name == "diagonal":
        assert (plan.argmax(1) == np.arange(len(a))).all()
        assert plan.diagonal().sum() > 0.95 * plan.sum()


def test_float64_reference_agrees():
    cost, a, b = uniform_instance()
    f32 = sinkhorn_dense_plain(*(torch.as_tensor(x) for x in (cost, a, b)), 0.05, 500)
    f64 = sinkhorn_dense_plain(*(torch.as_tensor(x).double() for x in (cost, a, b)), 0.05, 500)
    assert f64[1].dtype == torch.float64
    for x32, x64 in zip(f32, f64):
        np.testing.assert_allclose(x32.numpy(), x64.numpy(), rtol=1e-4, atol=1e-5)


def test_kernel_wrapper_runs_plain_on_cpu():
    args = [torch.as_tensor(x) for x in uniform_instance()]
    for x, y in zip(sinkhorn_dense(*args, 0.05, 50), sinkhorn_dense_plain(*args, 0.05, 50)):
        assert torch.equal(x, y)


def test_odd_shapes_match_jax():
    """The plain version against JAX at a non-square, odd shape and at one
    row, the shapes the card's kernel splits unevenly between its blocks."""
    rng = np.random.default_rng(3)
    for n, m in ((13, 37), (1, 29)):
        cost = rng.uniform(0, 5, (n, m)).astype(np.float32)
        a, b = np.full(n, 1.0 / n, np.float32), np.full(m, 1.0 / m, np.float32)
        want = sj.sinkhorn_dense(cost, a, b, eps=0.05, n_iters=200)
        got = st.sinkhorn_dense(cost, a, b, eps=0.05, n_iters=200, device="cpu")
        for g_, w_ in zip(got, want):
            assert g_.shape == w_.shape
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[0].numpy().sum(0), b, rtol=1e-4)
