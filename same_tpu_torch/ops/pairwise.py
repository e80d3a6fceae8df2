"""Radius-kNN on the device (counterpart of ``same_tpu/ops/pairwise.py``).

Candidate generation in the reference is a per-point Python loop over a C++
cKDTree (reference src/utils.py:709-742); the JAX package sweeps every pair
on the TPU. On the card it is kernel K3 (``kernels/radius_knn.py``): the refs
binned into a grid of cells, each query testing the refs of the cells within
reach by the same f32 expansion and keeping its k best in registers, so its
answer is the brute-force sweep's and no [n, m] distance matrix is formed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.radius_knn import radius_knn
from ..models.assignment import resolve_device


def _points(xy, device) -> torch.Tensor:
    """``xy`` as a contiguous float32 [n, 2] tensor on ``device``."""
    if not isinstance(xy, torch.Tensor):
        xy = torch.as_tensor(np.ascontiguousarray(xy, dtype=np.float32))
    return xy.to(device=device, dtype=torch.float32).reshape(-1, 2).contiguous()


def radius_knn_device(query_xy, ref_xy, radius: float, k: int, device=None):
    """For each query point, the k nearest refs within ``radius``.

    Returns tensors ``(idx, dist, mask)`` on the device with shapes [n, k],
    padded with -1 / +inf / False. Distances are Euclidean. Neighbors are
    sorted by distance (ascending); ties go to the smaller ref index.
    ``device`` is where the sweep runs: ``None`` is the first CUDA card (and
    raises without one), ``"cpu"`` runs the kernel's plain version.
    """
    device = resolve_device(device)
    return radius_knn(_points(query_xy, device), _points(ref_xy, device), radius, k)


def nearest_neighbors_device(query_xy, ref_xy, k: int = 1, device=None):
    """k-NN without radius bound; returns (idx, dist) of shape [n, k]."""
    idx, dist, _ = radius_knn_device(query_xy, ref_xy, float("inf"), k, device)
    return idx, dist
