"""Entropic optimal transport (Sinkhorn), counterpart of
``same_tpu/ops/sinkhorn.py``.

Complementary first-order solver to the auction (solver/auction.py): where
the auction produces integral matchings, Sinkhorn produces fractional
transport plans and smooth dual potentials in a fixed number of iterations.
Its use here is the **warm start**: the ref-side dual potentials seed auction
prices (``prices ~ -g``), shrinking bidding wars on contested regions
(``init_method="sinkhorn"``).

Log-domain updates for numerical stability. The sparse variant works
directly on the padded [n, K] candidate tensors and is kernel K4
(``kernels/sinkhorn_sparse.py``) on the card; the dense variant, a public op
with no caller in the package, is kernel K10 (``kernels/sinkhorn_dense.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.sinkhorn_dense import sinkhorn_dense as dense_kernel
from ..kernels.sinkhorn_sparse import sinkhorn_sparse
from ..models.assignment import resolve_device

__all__ = ["sinkhorn_dense", "sinkhorn_sparse", "sinkhorn_prices"]


def sinkhorn_dense(cost, a, b, eps: float = 0.1, n_iters: int = 200, device=None):
    """Log-domain Sinkhorn on a dense cost matrix.

    Parameters: cost [n, m]; marginals a [n], b [m] (need not be balanced:
    the final plan satisfies the row marginals exactly, column marginals
    approximately). The inputs are taken as float32, as the JAX op takes
    them. Returns float32 (plan [n, m], f [n], g [m]) as tensors on
    ``device``: ``None`` is the first CUDA card (kernel K10; raises without
    one), ``"cpu"`` runs the kernel's plain version.
    """
    device = resolve_device(device)
    cost, a, b = (torch.as_tensor(t).to(device=device, dtype=torch.float32).contiguous()
                  for t in (cost, a, b))
    return dense_kernel(cost, a, b, eps, n_iters)


def sinkhorn_prices(problem, eps: float = 1.0, n_iters: int = 100, device=None):
    """Auction price warm start from Sinkhorn ref potentials.

    Maps the sparse dual g (<= 0, per ref) to initial slot prices (-g >= 0)
    replicated across each ref's capacity slots. ``device`` is where the
    iterations run: ``None`` is the first CUDA card (and raises without
    one), ``"cpu"`` runs the kernel's plain version.
    """
    device = resolve_device(device)

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    # Candidate columns are slot-expanded; each column is its own candidate.
    _plan, g = sinkhorn_sparse(
        up(problem.costs, torch.float32),
        up(np.clip(np.asarray(problem.cand_ref), 0, None), torch.int32),
        up(problem.valid, torch.bool),
        up(problem.nm_cost, torch.float32),
        n_ref=int(problem.n_ref),
        eps=eps,
        n_iters=n_iters,
    )
    g = g.cpu().numpy()
    prices = np.zeros(problem.n_slots + 1, dtype=problem.costs.dtype)
    slot_ref = np.asarray(problem.slot_ref)
    real = slot_ref >= 0
    prices[: problem.n_slots][real] = -g[slot_ref[real]]
    return prices
