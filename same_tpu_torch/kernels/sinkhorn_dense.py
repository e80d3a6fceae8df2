"""K10 ``sinkhorn_dense``: log-domain Sinkhorn on a dense cost matrix.

``sinkhorn_dense`` launches ``csrc/sinkhorn_dense.cu`` for CUDA tensors and
runs ``sinkhorn_dense_plain``, a PyTorch transcription of
``same_tpu/ops/sinkhorn.py:27-53``, for CPU tensors. Arguments: ``cost``
[n, m], marginals ``a`` [n] and ``b`` [m], ``eps``, ``n_iters``; both return
``(plan [n, m], f [n], g [m])``.

The plain version computes in the inputs' dtype, float32 as the JAX package
does (and float64 when given float64: the reference the smoke holds the
kernel to). The kernel takes float32 and returns float32, but carries the
duals and the logits in float64 between and within iterations: the duals'
gauge direction (f + k, g - k) gathers float32 rounding over the
iterations without decay, and the kernel keeps it out (see the note in the
source). One call of the wrapper enqueues the whole chain of ``2 * n_iters
+ 2`` launches from C; ``sinkhorn_dense.launches`` counts calls.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build


def sinkhorn_dense_plain(cost, a, b, eps: float = 0.1, n_iters: int = 200):
    """Plain PyTorch version of K10 (same_tpu/ops/sinkhorn.py:27-53)."""
    # A device scalar: PyTorch divides by a host scalar through its reciprocal.
    eps_t = torch.tensor(eps, dtype=cost.dtype, device=cost.device)
    log_a = torch.log(a)
    log_b = torch.log(b)
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    for _ in range(n_iters):
        # f-update: row logsumexp of (g - cost)/eps
        f = eps_t * log_a - eps_t * torch.logsumexp((g[None, :] - cost) / eps_t, dim=1)
        g = eps_t * log_b - eps_t * torch.logsumexp((f[:, None] - cost) / eps_t, dim=0)
    plan = torch.exp((f[:, None] + g[None, :] - cost) / eps_t)
    return plan, f, g


def _lib():
    lib = _build.load("sinkhorn_dense")
    if lib.same_sinkhorn_dense.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_sinkhorn_dense.restype = i
        lib.same_sinkhorn_dense.argtypes = (
            [p] * 3 + [i, i, ctypes.c_float, i] + [p] * 7
        )
    return lib


def sinkhorn_dense(cost, a, b, eps: float = 0.1, n_iters: int = 200):
    """Dense Sinkhorn: K10 on CUDA tensors, the plain version on CPU tensors."""
    if cost.device.type == "cpu":
        return sinkhorn_dense_plain(cost, a, b, eps, n_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"sinkhorn_dense: unsupported device {cost.device}")
    dev = cost.device
    n, m = cost.shape
    n_iters = int(n_iters)
    _build.check_tensors("sinkhorn_dense", dev, (
        ("cost", cost, torch.float32, (n, m)),
        ("a", a, torch.float32, (n,)),
        ("b", b, torch.float32, (m,)),
    ))
    plan = torch.empty((n, m), dtype=torch.float32, device=dev)
    f = torch.empty(n, dtype=torch.float32, device=dev)
    g = torch.empty(m, dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return plan, f.zero_(), g.zero_()
    cost_t = torch.empty((m, n), dtype=torch.float32, device=dev)
    f64 = torch.empty(n, dtype=torch.float64, device=dev)
    g64 = torch.empty(m, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        lib = _lib()
        rc = lib.same_sinkhorn_dense(
            cost.data_ptr(), a.data_ptr(), b.data_ptr(), n, m, float(np.float32(eps)),
            n_iters, cost_t.data_ptr(), f64.data_ptr(), g64.data_ptr(), plan.data_ptr(),
            f.data_ptr(), g.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "sinkhorn_dense")
    _build.count_launch(sinkhorn_dense)
    return plan, f, g


sinkhorn_dense.launches = 0
