"""K4 ``sinkhorn_sparse``: log-domain Sinkhorn over padded candidates.

``sinkhorn_sparse`` launches ``csrc/sinkhorn_sparse.cu`` for CUDA tensors and
runs ``sinkhorn_sparse_plain``, a PyTorch transcription of
``same_tpu/ops/sinkhorn.py:56-99``, for CPU tensors. Arguments follow the JAX
function: ``cand_cost`` [n, K] float32, ``cand_ref`` [n, K] int32 (clipped to
the ref range), ``cand_mask`` [n, K] bool, ``nm_cost`` [n] float32; both
return ``(plan [n, K+1], g [n_ref])``, the plan's last column the no-match
mass.

Two things are fixed so that kernel and plain version add in one order and a
run repeats: the row's logsumexp sums its columns 0..K in that order after
subtracting the row maximum, and the mass of a ref is summed over its plan
entries sorted by row, then column (``ref_entry_lists``, built once per
problem), where the JAX version scatter-adds. Against XLA's reduction order
that moves results in the last bits only.

On the card a call is one launch of one thread-block cluster that runs every
iteration, plus ``ref_entry_lists``' PyTorch ops before it;
``sinkhorn_sparse.launches`` counts calls. ``sinkhorn_sparse.g_memory`` says
where the last call kept the duals during its row passes ("shared": a copy in
each block's shared memory, or "global") and ``row_warps`` how many warps a
block ran them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

NEG_INF = float("-inf")


def ref_entry_lists(safe_ref, cand_mask, n_ref: int):
    """The valid plan entries of each ref, as a CSR pair ``(ptr, ent)``.

    ``ent`` holds flat indices into the [n, K+1] plan, grouped by ref and
    within a ref sorted by row, then column; ``ptr`` [n_ref+1] delimits the
    groups. Both int32, on the inputs' device.
    """
    n, K = cand_mask.shape
    flat = cand_mask.reshape(-1).nonzero()[:, 0]  # row-major: by row, column
    refs = safe_ref.reshape(-1)[flat].long()
    order = torch.sort(refs, stable=True).indices
    flat = flat[order]
    ent = (flat // K) * (K + 1) + flat % K
    ptr = torch.zeros(n_ref + 1, dtype=torch.int64, device=cand_mask.device)
    ptr[1:] = torch.cumsum(torch.bincount(refs, minlength=n_ref), 0)
    return ptr.to(torch.int32), ent.to(torch.int32)


def _row_pass_plain(costs_all, valid_all, safe_ref, g, eps):
    """One row pass: the [n, K+1] plan from the ref duals ``g``."""
    n, K1 = costs_all.shape
    g_cols = torch.cat([g[safe_ref], g.new_zeros((n, 1))], dim=1)
    logits = torch.where(valid_all, (g_cols - costs_all) / eps, NEG_INF)
    mx = logits.max(dim=1, keepdim=True).values
    e = torch.exp(logits - mx)
    s = g.new_zeros(n)
    for k in range(K1):  # a fixed order, the kernel's
        s = s + e[:, k]
    lse = torch.log(s)[:, None] + mx
    return torch.exp(logits - lse)


def sinkhorn_sparse_plain(
    cand_cost, cand_ref, cand_mask, nm_cost, n_ref: int,
    eps: float = 1.0, n_iters: int = 100,
):
    """Plain PyTorch version of K4 (same_tpu/ops/sinkhorn.py:56-99)."""
    n, K = cand_cost.shape
    dev = cand_cost.device
    safe_ref = cand_ref.long().clamp(0, n_ref - 1)
    costs_all = torch.cat([cand_cost, nm_cost[:, None]], dim=1)
    valid_all = torch.cat(
        [cand_mask, torch.ones((n, 1), dtype=torch.bool, device=dev)], dim=1
    )
    # A device scalar: PyTorch divides by a host scalar through its reciprocal.
    eps_t = torch.tensor(eps, dtype=cand_cost.dtype, device=dev)
    ptr, ent = ref_entry_lists(safe_ref, cand_mask, n_ref)
    # [n_ref, D] entry matrix, padded with the index of an appended zero.
    counts = (ptr[1:] - ptr[:-1]).long()
    depth = int(counts.max()) if counts.numel() else 0
    pad = n * (K + 1)
    ent_pad = torch.full((n_ref, depth), pad, dtype=torch.int64, device=dev)
    owner = torch.repeat_interleave(torch.arange(n_ref, device=dev), counts)
    pos = torch.arange(ent.shape[0], device=dev) - ptr[:-1].long()[owner]
    ent_pad[owner, pos] = ent.long()

    g = torch.zeros(n_ref, dtype=cand_cost.dtype, device=dev)
    for _ in range(n_iters):
        plan = _row_pass_plain(costs_all, valid_all, safe_ref, g, eps_t)
        flat = torch.cat([plan.reshape(-1), plan.new_zeros(1)])
        mass = torch.zeros_like(g)
        for d in range(depth):  # by row, then column, like the kernel
            mass = mass + flat[ent_pad[:, d]]
        g = g - eps_t * torch.log(mass.clamp_min(1e-9))
        g = g.clamp_max(0.0)
    return _row_pass_plain(costs_all, valid_all, safe_ref, g, eps_t), g


def _lib():
    lib = _build.load("sinkhorn_sparse")
    if lib.same_sinkhorn_sparse.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.same_sinkhorn_sparse.restype = i
        lib.same_sinkhorn_sparse.argtypes = (
            [p] * 6 + [i, i, i, ctypes.c_float, i] + [p] * 4
        )
    return lib


def sinkhorn_sparse(
    cand_cost, cand_ref, cand_mask, nm_cost, n_ref: int,
    eps: float = 1.0, n_iters: int = 100,
):
    """Sparse Sinkhorn: K4 on CUDA tensors, the plain version on CPU tensors."""
    if cand_cost.device.type == "cpu":
        return sinkhorn_sparse_plain(
            cand_cost, cand_ref, cand_mask, nm_cost, n_ref, eps, n_iters
        )
    if cand_cost.device.type != "cuda":
        raise ValueError(f"sinkhorn_sparse: unsupported device {cand_cost.device}")
    dev = cand_cost.device
    n, K = cand_cost.shape
    n_ref, n_iters = int(n_ref), int(n_iters)
    _build.check_tensors("sinkhorn_sparse", dev, (
        ("cand_cost", cand_cost, torch.float32, (n, K)),
        ("cand_ref", cand_ref, torch.int32, (n, K)),
        ("cand_mask", cand_mask, torch.bool, (n, K)),
        ("nm_cost", nm_cost, torch.float32, (n,)),
    ))
    if n_ref < 1 or K < 1 or n * (K + 1) >= 2**31:
        raise ValueError(f"sinkhorn_sparse: n_ref = {n_ref}, [n, K] = [{n}, {K}]")
    lib = _lib()
    ptr, ent = ref_entry_lists(cand_ref.long().clamp(0, n_ref - 1), cand_mask, n_ref)
    g = torch.zeros(n_ref, dtype=torch.float32, device=dev)
    plan = torch.empty((n, K + 1), dtype=torch.float32, device=dev)
    if n == 0:
        return plan, g
    shape = (ctypes.c_int * 2)()
    rc = lib.same_sinkhorn_sparse(
        cand_cost.data_ptr(), cand_ref.data_ptr(), cand_mask.data_ptr(),
        nm_cost.data_ptr(), ptr.data_ptr(), ent.data_ptr(), n, K, n_ref,
        float(np.float32(eps)), n_iters, g.data_ptr(), plan.data_ptr(), shape,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "sinkhorn_sparse")
    _build.count_launch(sinkhorn_sparse, g_memory="shared" if shape[0] else "global",
                        row_warps=shape[1])
    return plan, g


sinkhorn_sparse.launches = 0
