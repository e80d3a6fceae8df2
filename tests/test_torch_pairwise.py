"""Port parity: the device kNN (kernel K3's plain version on the CPU) against
``same_tpu.ops.pairwise`` and against the host cKDTree.

Both packages evaluate squared distances by the f32 expansion
|q|^2 + |r|^2 - 2 q.r, but XLA and PyTorch round its inner product at
different places, so the squared distances agree to a few ulp of
|q|^2 + |r|^2 (about 200 here, ulp 1.5e-5): 1e-4 absolute, which is 1e-4 or
less on the distance except next to a coincident point. Masks must be equal,
and indices may differ only where the distances agree to 1e-4 (the rule of
tests/test_candidates.py). On the lattice instance the expansion is exact, so
everything is identical, ties and short rows included.
"""

import numpy as np
import pytest
import torch

from same_tpu.candidates import radius_knn as radius_knn_jax
from same_tpu.ops.pairwise import nearest_neighbors_tpu, radius_knn_tpu
from same_tpu_torch.candidates import find_knn_within_radius, radius_knn
from same_tpu_torch.kernels.radius_knn import radius_knn as k3, radius_knn_plain
from same_tpu_torch.ops.pairwise import nearest_neighbors_device, radius_knn_device
from torch_parity import as_np, knn_points


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_radius_knn_device_matches_jax(kind):
    qry, ref, radius, k = knn_points(kind)
    ij, dj, mj = (np.asarray(a) for a in radius_knn_tpu(qry, ref, radius, k))
    it, dt, mt = (as_np(a) for a in radius_knn_device(qry, ref, radius, k, device="cpu"))
    assert it.dtype == ij.dtype and dt.dtype == dj.dtype and mt.dtype == mj.dtype
    assert it.shape == (len(qry), k)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(it[~mt], -1)
    assert np.isinf(dt[~mt]).all()
    if kind == "ties":
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(dt, dj)
        assert (~mt).any() and mt.any()  # short rows and full rows both occur
        d = np.where(mt, dt, -1.0)
        assert ((d[:, 1:] == d[:, :-1]) & mt[:, 1:]).any()  # exact ties occur
    else:
        diff = (it != ij) & mt
        np.testing.assert_allclose(dt[diff], dj[diff], atol=1e-4)
        np.testing.assert_allclose(dt[mt] ** 2, dj[mt] ** 2, rtol=0, atol=1e-4)
    # Ascending by distance; equal distances in ascending ref index.
    for i in range(len(qry)):
        d, j = dt[i][mt[i]], it[i][mt[i]]
        assert (np.diff(d) >= 0).all()
        assert (np.diff(j)[np.diff(d) == 0] > 0).all()


def test_nearest_neighbors_device_matches_jax():
    qry, ref, _radius, _k = knn_points("ties")
    ij, dj = (np.asarray(a) for a in nearest_neighbors_tpu(qry, ref, k=3))
    it, dt = (as_np(a) for a in nearest_neighbors_device(qry, ref, k=3, device="cpu"))
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    assert (it >= 0).all()


def test_wrapper_on_cpu_is_the_plain_version():
    qry, ref, radius, k = (torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                           for a in knn_points("random"))
    for a, b in zip(k3(qry, ref, radius, k), radius_knn_plain(qry, ref, radius, k)):
        assert torch.equal(a, b)
    assert k3.launches == 0  # a CPU tensor launches nothing
    with pytest.raises(ValueError, match="at least 1"):
        k3(qry, ref, radius, 0)


def test_more_neighbours_asked_than_refs():
    qry, ref, _radius, _k = knn_points("ties")
    idx, dist, mask = radius_knn_plain(
        torch.as_tensor(qry), torch.as_tensor(ref[:3]), float("inf"), 5)
    assert mask[:, :3].all() and not mask[:, 3:].any()
    assert (idx[:, 3:] == -1).all() and torch.isinf(dist[:, 3:]).all()


def test_candidates_device_backend_matches_host_and_jax():
    """same_tpu_torch.candidates.radius_knn(backend="tpu") against its own
    host backend (tests/test_candidates.py:51-63) and the JAX package's."""
    qry, ref, radius, k = knn_points("random")
    ih, dh, mh = radius_knn(qry, ref, radius, k, backend="host")
    it, dt, mt = radius_knn(qry, ref, radius, k, backend="tpu", device="cpu")
    ij, dj, mj = radius_knn_jax(qry, ref, radius, k, backend="tpu")
    assert (mh == mt).all() and (mj == mt).all()
    assert dt.dtype == np.float64 == dj.dtype
    for other_i, other_d in ((ih, dh), (ij, dj)):
        diff = (other_i != it) & mt
        assert np.allclose(other_d[diff], dt[diff], atol=1e-4)


def test_env_selects_the_device_backend(monkeypatch):
    """SAME_TPU_KNN=tpu reaches the device branch: without a card and without
    device="cpu" it raises instead of falling back to the host sweep."""
    import pandas as pd

    qry, ref, radius, k = knn_points("random")
    monkeypatch.setenv("SAME_TPU_KNN", "tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        radius_knn(qry, ref, radius, k)
    a = pd.DataFrame(qry.astype(np.float64), columns=["X", "Y"])
    r = pd.DataFrame(ref.astype(np.float64), columns=["X", "Y"])
    na, nr, pairs = find_knn_within_radius(a, r, radius=radius, knn=k, device="cpu")
    monkeypatch.setenv("SAME_TPU_KNN", "host")
    ha, hr, hpairs = find_knn_within_radius(a, r, radius=radius, knn=k)
    np.testing.assert_array_equal(pairs, hpairs)
    assert len(na) == len(ha) and len(nr) == len(hr)
