"""Port parity: ops/orient.py in torch against same_tpu.ops.orient (JAX).

Exact equality: the cross products bit for bit, the signs and flip masks
element for element, on random coordinates that include collinear and
repeated-vertex triangles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from same_tpu.ops import orient as jo
from same_tpu_torch.ops import orient as to
from torch_parity import assert_bit_equal


def _coords_and_tris(seed, n=60, T=400):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-50, 50, (n, 2)).astype(np.float32)
    # Points on shared lines (exactly collinear) and near-degenerate ones.
    xy[:10, 1] = 3.0
    xy[10:20] = xy[0] + np.outer(np.arange(1, 11), [0.5, 0.25]).astype(np.float32)
    xy[20:30] = xy[30:40] + rng.normal(0, 1e-4, (10, 2)).astype(np.float32)
    tris = rng.integers(0, n, (T, 3))
    tris[:40] = rng.integers(0, 10, (40, 3))      # collinear on y = 3
    tris[40:80] = rng.integers(10, 20, (40, 3))   # collinear along a ray
    tris[80:100, 2] = tris[80:100, 0]             # repeated vertex
    return xy, tris


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangle_cross_bit_equal(seed):
    xy, tris = _coords_and_tris(seed)
    want = jo.triangle_cross(jnp.asarray(xy), jnp.asarray(tris))
    got = to.triangle_cross(torch.as_tensor(xy), torch.as_tensor(tris))
    assert_bit_equal(got, want, "cross")


@pytest.mark.parametrize("round_decimals", [None, 3])
def test_triangle_orientation_equal(round_decimals):
    xy, tris = _coords_and_tris(3)
    want = jo.triangle_orientation(jnp.asarray(xy), jnp.asarray(tris), round_decimals)
    got = to.triangle_orientation(
        torch.as_tensor(xy), torch.as_tensor(tris), round_decimals
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Degenerate triangles are present and agree on sign 0.
    assert (got.numpy() == 0).sum() >= 100


@pytest.mark.parametrize("seed", [4, 5])
def test_matched_triangle_flips_equal(seed):
    rng = np.random.default_rng(seed)
    ref_xy, _ = _coords_and_tris(seed, n=60)
    n_al, T = 50, 300
    tris = rng.integers(0, n_al, (T, 3))
    match_ref = rng.integers(-1, 60, n_al).astype(np.int32)
    src = rng.integers(-1, 2, T).astype(np.int32)
    tri_mask = rng.random(T) < 0.9
    want = jo.matched_triangle_flips(
        jnp.asarray(ref_xy), jnp.asarray(tris), jnp.asarray(tri_mask),
        jnp.asarray(match_ref), jnp.asarray(src),
    )
    got = to.matched_triangle_flips(
        torch.as_tensor(ref_xy), torch.as_tensor(tris), torch.as_tensor(tri_mask),
        torch.as_tensor(match_ref), torch.as_tensor(src),
    )
    for g, w, name in zip(got, want, ("checked", "flipped")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].any() and got[1].any()


def test_two_vertices_on_one_ref_are_not_checked():
    """With ``max_matches`` >= 2 two vertices of a triangle can hold the same
    ref. Its image is then exactly degenerate: x*y - y*x with each product
    its own f32 op is 0, as in numpy, and the triangle is not checked. (A
    compiler that contracts the expression to an FMA leaves the product's
    rounding residual instead, and a sign of chance: jitted XLA on the CPU
    does, which is why the two packages' tear rounds part on such windows.)
    """
    rng = np.random.default_rng(6)
    ref_xy = rng.uniform(-50, 50, (40, 2)).astype(np.float32)
    tris = np.stack([rng.permutation(30)[:3] for _ in range(200)])
    match_ref = rng.integers(0, 40, 30).astype(np.int32)
    shared = match_ref[tris[:, 1]] == match_ref[tris[:, 2]]
    match_ref_t = torch.as_tensor(match_ref)
    tris_t = torch.as_tensor(tris)
    cross = to.triangle_cross(torch.as_tensor(ref_xy), match_ref_t[tris_t].long())
    checked, flipped = to.matched_triangle_flips(
        torch.as_tensor(ref_xy), tris_t, torch.ones(200, dtype=torch.bool),
        match_ref_t, torch.ones(200, dtype=torch.int32),
    )
    assert shared.sum() >= 3
    assert (cross.numpy()[shared] == 0).all()
    assert not checked.numpy()[shared].any() and not flipped.numpy()[shared].any()
    assert checked.numpy()[~shared].any()
