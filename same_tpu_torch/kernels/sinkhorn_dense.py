"""K10 ``sinkhorn_dense``: log-domain Sinkhorn on a dense cost matrix.

``sinkhorn_dense`` launches ``csrc/sinkhorn_dense.cu`` for CUDA tensors and
runs ``sinkhorn_dense_plain``, a PyTorch transcription of
``same_tpu/ops/sinkhorn.py:27-53``, for CPU tensors. Arguments: ``cost``
[n, m], marginals ``a`` [n] and ``b`` [m], ``eps``, ``n_iters``; both return
``(plan [n, m], f [n], g [m])``.

The plain version computes in the inputs' dtype, float32 as the JAX package
does (and float64 when given float64: the reference the smoke holds the
kernel to). The kernel takes float32 and returns float32, but carries the
duals in float64 between half-iterations and ends each logsumexp in float64:
the duals' gauge direction (f + k, g - k) gathers any float32 rounding of
f or g over the iterations without decay (see the note in the source). One
call is one cooperative launch, every iteration inside it;
``sinkhorn_dense.launches`` counts launches.
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
            [p] * 3 + [i, i, ctypes.c_float, i] + [p] * 7 + [i] + [p] * 6
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
    with torch.cuda.device(dev):
        lib = _lib()
        # The partials' rows: one a block of the launch (a block an SM), at most n.
        rows = min(torch.cuda.get_device_properties(dev).multi_processor_count, n)
        # f, g, eps * log(a), eps * log(b) in float64.
        f64, g64, la, lb = torch.empty(2 * (n + m), dtype=torch.float64,
                                       device=dev).split([n, m, n, m])
        fp = torch.empty(n, dtype=torch.float32, device=dev)
        gp = torch.empty(m, dtype=torch.float32, device=dev)
        part = torch.empty((rows, m, 2), dtype=torch.float32, device=dev)
        bar = torch.empty(2, dtype=torch.int32, device=dev)
        shape = (ctypes.c_int * 2)()
        rc = lib.same_sinkhorn_dense(
            cost.data_ptr(), a.data_ptr(), b.data_ptr(), n, m, float(np.float32(eps)),
            n_iters, f64.data_ptr(), g64.data_ptr(), la.data_ptr(), lb.data_ptr(),
            fp.data_ptr(), gp.data_ptr(), part.data_ptr(), rows, bar.data_ptr(),
            plan.data_ptr(), f.data_ptr(), g.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, shape,
        )
        _build.check(lib, rc, "sinkhorn_dense")
    sinkhorn_dense.shape = (shape[0], shape[1])
    _build.count_launch(sinkhorn_dense)
    return plan, f, g


sinkhorn_dense.launches = 0
# (blocks, rows a block kept in shared memory) of the last launch.
sinkhorn_dense.shape = None
