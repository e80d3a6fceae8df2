"""K3's grid of cells (``grid_params``, ``point_cells`` and ``visited_cells``
of ``same_tpu_torch.kernels.radius_knn``, the f32 steps the kernel shares) on
the CPU: the rule it must keep for the kernel to stay bit-equal to
``radius_knn_plain``. The binning itself (the counting sort) runs only on the
card, and ``chip_smoke.py`` checks its output there.

Every (query, ref) pair that the f32 expansion admits (d2 <= float32(radius)^2)
must lie in a cell that the query visits. Far from the origin the expansion
admits refs whose exact distance is above the radius (by up to E, the
expansion's error, some hundreds of units^2 near 13,000 and more near
31,000), so the instances put refs on rings just outside the radius there. A
list restricted to the visited cells must then equal ``radius_knn_plain``'s,
bit for bit, which is what the kernel computes on the card. The same inputs
go through ``same_tpu.ops.pairwise.radius_knn_tpu`` on JAX-CPU, whose
expansion rounds at other places: there the two agree where the expansion
allows (each reported squared distance within E of the exact one, position
by position within 2 E, the same rows filled).
"""

import numpy as np
import pytest
import torch

from same_tpu.ops.pairwise import radius_knn_tpu
from same_tpu_torch.kernels.radius_knn import (
    expansion_error, grid_params, point_cells, radius_knn_plain, radius_sq,
    squared_distances, unbinned_grid, visited_cells,
)

import torch_parity  # noqa: F401  (one torch thread per xdist worker)

INF = float("inf")


def edge_rings(center, radius, queries=40, per_query=40, seed=9):
    """Queries within 400 units of (center, center), each with refs on a
    ring 0 to 0.05 units outside ``radius`` (float64, rounded to float32)."""
    rng = np.random.default_rng(seed)
    q = (center + rng.uniform(-400, 400, (queries, 2))).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (queries, per_query))
    rr = radius + rng.uniform(0, 0.05, (queries, per_query))
    q64 = q.astype(np.float64)
    refs = np.stack([q64[:, :1] + rr * np.cos(ang), q64[:, 1:] + rr * np.sin(ang)], -1)
    return q, refs.reshape(-1, 2).astype(np.float32)


def exact_d2(q, r):
    """Exact squared distances of the float32 points (float64)."""
    q, r = np.asarray(q, np.float64), np.asarray(r, np.float64)
    return ((q[:, None, :] - r[None]) ** 2).sum(-1)


def pair_error(q, r):
    """E of each pair: ``expansion_error`` at its |q|^2 + |r|^2."""
    q, r = np.asarray(q, np.float64), np.asarray(r, np.float64)
    return expansion_error((q ** 2).sum(1)[:, None] + (r ** 2).sum(1)[None])


def grid_of(q, r, radius):
    """The grid ``knn_grid`` chooses for (q, r) on the card, before binning."""
    def bounds(xy):
        xy = np.asarray(xy)
        return [xy[:, 0].min(), xy[:, 0].max(), xy[:, 1].min(), xy[:, 1].max()]

    return unbinned_grid(grid_params(bounds(q), bounds(r), radius, len(r)), r)


def visited_pairs(q, r, grid):
    """[n, m] bool: which refs lie in a cell that each query visits (every
    pair on a one-cell grid)."""
    if not grid.cells:
        return torch.ones((q.shape[0], r.shape[0]), dtype=torch.bool)
    cx, cy = point_cells(r, grid)
    xlo, xhi, ylo, yhi, _ = visited_cells(q, grid)
    return ((cx[None, :] >= xlo[:, None]) & (cx[None, :] <= xhi[:, None])
            & (cy[None, :] >= ylo[:, None]) & (cy[None, :] <= yhi[:, None]))


def cells_knn(q, r, radius, k):
    """The kernel's answer on the CPU: the plain version's sort restricted to
    the refs of the visited cells."""
    grid = grid_of(q, r, radius)
    d2 = squared_distances(q, r)
    key = torch.where(visited_pairs(q, r, grid) & (d2 <= radius_sq(radius)), d2, INF)
    key, order = torch.sort(key, dim=1, stable=True)
    kk = min(k, r.shape[0])
    idx = torch.full((q.shape[0], k), -1, dtype=torch.int32)
    dist = torch.full((q.shape[0], k), INF)
    valid = torch.isfinite(key[:, :kk])
    idx[:, :kk] = torch.where(valid, order[:, :kk].to(torch.int32), -1)
    dist[:, :kk] = torch.where(valid, torch.sqrt(key[:, :kk].double()).float(), INF)
    mask = torch.zeros((q.shape[0], k), dtype=torch.bool)
    mask[:, :kk] = valid
    return grid, (idx, dist, mask)


def assert_cells_cover(q, r, radius, k):
    """Every admitted pair visited, and the restricted list the plain one."""
    qt, rt = torch.as_tensor(q), torch.as_tensor(r)
    grid, got = cells_knn(qt, rt, radius, k)
    admitted = squared_distances(qt, rt) <= radius_sq(radius)
    missed = admitted & ~visited_pairs(qt, rt, grid)
    assert not missed.any(), f"{int(missed.sum())} admitted pairs in unvisited cells"
    for a, b in zip(got, radius_knn_plain(qt, rt, radius, k)):
        assert torch.equal(a, b)
    return grid, admitted.numpy()


def assert_within_expansion(q, r, radius, got, want):
    """Two f32 expansions' lists agree as far as E allows."""
    (it, dt, mt), (ij, dj, mj) = got, want
    for idx, dist, mask in ((it, dt, mt), (ij, dj, mj)):
        rows, cols = np.nonzero(mask)
        ex = exact_d2(q, r)[rows, idx[rows, cols]]
        e = pair_error(q, r)[rows, idx[rows, cols]]
        assert (np.abs(dist[rows, cols].astype(np.float64) ** 2 - ex) <= e).all()
    np.testing.assert_array_equal(mt.sum(1), mj.sum(1))
    both = mt & mj
    e_row = pair_error(q, r).max(1)[:, None] * np.ones_like(dt, np.float64)
    gap = np.abs(dt.astype(np.float64) ** 2 - dj.astype(np.float64) ** 2)
    assert (gap[both] <= 2 * e_row[both]).all()


@pytest.mark.parametrize("center", [13000.0, 31000.0])
def test_cells_cover_the_edge_far_from_the_origin(center):
    radius = 250.0
    q, r = edge_rings(center, radius)
    grid, admitted = assert_cells_cover(q, r, radius, 8)
    assert grid.cells and grid.gx * grid.gy > 1
    exact = exact_d2(q, r)
    # The expansion admits refs beyond the radius, some of them further than
    # the radius on one axis: a reach of the radius alone could miss them.
    beyond = admitted & (exact > radius_sq(radius))
    assert beyond.any()
    dx = np.abs(q[:, None, :].astype(np.float64) - r[None].astype(np.float64)).max(-1)
    assert (admitted & (dx > radius)).any()
    # E bounds the overshoot pair by pair.
    assert (exact - radius_sq(radius) <= pair_error(q, r))[admitted].all()
    assert grid.reach ** 2 >= radius_sq(radius) + (exact[admitted] - radius_sq(radius)).max()
    # The same inputs through the JAX package.
    got = [a.numpy() for a in radius_knn_plain(torch.as_tensor(q), torch.as_tensor(r), radius, 8)]
    want = [np.asarray(a) for a in radius_knn_tpu(q, r, radius, 8)]
    assert_within_expansion(q, r, radius, got, want)


def test_radius_inf_and_one_cell_test_every_pair():
    q, r = edge_rings(13000.0, 250.0, queries=20, per_query=10)
    for radius in (INF, 1e9):  # the reach is not finite / covers every ref
        grid = grid_of(q, torch.as_tensor(r), radius)
        assert not grid.cells
        assert_cells_cover(q, r, radius, 3)
    # All refs at one point: one cell whatever the radius.
    same = np.repeat(r[:1], 30, axis=0)
    assert not grid_of(q, torch.as_tensor(same), 250.0).cells
    assert_cells_cover(q, same, 250.0, 40)  # k > m: padding after the 30
    got = [a.numpy() for a in radius_knn_plain(torch.as_tensor(q), torch.as_tensor(r), INF, 3)]
    want = [np.asarray(a) for a in radius_knn_tpu(q, r, INF, 3)]
    assert_within_expansion(q, r, INF, got, want)


def test_radius_zero_keeps_coincident_points():
    rng = np.random.default_rng(4)
    r = rng.uniform(12000, 14000, (300, 2)).astype(np.float32)
    q = np.concatenate([r[::3], rng.uniform(12000, 14000, (50, 2)).astype(np.float32)])
    grid, admitted = assert_cells_cover(q, r, 0.0, 2)
    assert grid.cells  # the reach is the expansion's error, not 0
    assert admitted[np.arange(100), np.arange(0, 300, 3)].all()


def test_empty_cells_and_more_neighbours_than_refs():
    rng = np.random.default_rng(5)
    # Two clusters 20,000 units apart: most cells between them are empty.
    r = np.concatenate([rng.uniform(0, 900, (40, 2)), 20000 + rng.uniform(0, 900, (40, 2))])
    q = np.concatenate([rng.uniform(0, 900, (30, 2)), 20000 + rng.uniform(0, 900, (30, 2)),
                        rng.uniform(9000, 11000, (10, 2))]).astype(np.float32)
    r = r.astype(np.float32)
    grid, _ = assert_cells_cover(q, r, 300.0, 100)  # k > m
    cx, cy = point_cells(torch.as_tensor(r), grid)
    counts = np.bincount((cy * grid.gx + cx).numpy(), minlength=grid.gx * grid.gy)
    assert counts.size == grid.gx * grid.gy and counts.sum() == len(r)
    assert (counts == 0).sum() > 0.9 * counts.size
    qt = torch.as_tensor(q)
    # JAX's top_k takes k <= m only.
    got = [a.numpy() for a in radius_knn_plain(qt, torch.as_tensor(r), 300.0, 60)]
    want = [np.asarray(a) for a in radius_knn_tpu(q, r, 300.0, 60)]
    assert_within_expansion(q, r, 300.0, got, want)
    assert got[2].sum() == want[2].sum() > 0
