"""Batched triangle-orientation ops in PyTorch.

Port of ``same_tpu/ops/orient.py``: the sign of the cross product
``(b-a) x (c-a)`` for a batch of triangles, and the per-matching flip test.
Inside the tear round the flip test runs in kernel K2
(``kernels/tear_metrics.py``); these functions serve the host tail and the
plain twin. Each product and difference is its own f32 op, so no FMA
contraction changes a sign against the JAX package.
"""

from __future__ import annotations

import torch


def triangle_cross(coords: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """Cross products ``(b-a) x (c-a)`` for triangles.

    coords : [n, 2] float point coordinates; tris : [T, 3] int vertex
    indices into ``coords``. Returns [T] floats (twice the signed area).
    """
    p = coords[tris.long()]  # [T, 3, 2]
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    return (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]
    ) * (c[:, 0] - a[:, 0])


def triangle_orientation(
    coords: torch.Tensor, tris: torch.Tensor, round_decimals: int | None = None
) -> torch.Tensor:
    """Orientation sign per triangle: +1 CCW, -1 CW, 0 degenerate.

    ``round_decimals=3`` rounds the cross product to three decimals (half to
    even, like ``jnp.round``) before taking the sign.
    """
    cross = triangle_cross(coords, tris)
    if round_decimals is not None:
        scale = 10.0**round_decimals
        cross = torch.round(cross * scale) / scale
    return torch.sign(cross).to(torch.int32)


def matched_triangle_flips(
    ref_coords: torch.Tensor,
    tris: torch.Tensor,
    tri_mask: torch.Tensor,
    match_ref: torch.Tensor,
    source_signs: torch.Tensor,
):
    """Vectorized flip test for all triangles under a matching.

    A triangle is *checked* iff all three vertices are matched and neither
    its source nor its image orientation is degenerate; it is *flipped* iff
    the image orientation differs from the source orientation. Returns
    ``(checked, flipped)``, two [T] bool tensors.
    """
    tri_match = match_ref[tris.long()]  # [T, 3]
    all_matched = (tri_match >= 0).all(dim=1) & tri_mask
    # Clamp so gathers stay in-bounds for unmatched vertices; they are masked.
    ref_tris = tri_match.clamp(0, ref_coords.shape[0] - 1)
    ref_sign = triangle_orientation(ref_coords, ref_tris)
    checked = all_matched & (source_signs != 0) & (ref_sign != 0)
    flipped = checked & (ref_sign != source_signs)
    return checked, flipped
