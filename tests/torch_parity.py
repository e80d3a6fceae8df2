"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

The tests run the JAX package (on JAX's CPU backend, forced by conftest.py)
and ``same_tpu_torch`` (on the CPU, through the kernels' plain twins) on the
same numpy inputs made from a seed, and compare the outputs. Instances stay
in the smallest shape bucket (n = 64, S = 64, C = 8) where they can, so a
file's JAX calls share one compile.
"""

from __future__ import annotations

import numpy as np
import torch

# pytest-xdist runs several workers side by side: one thread each.
torch.set_num_threads(1)


LABEL_TYPES = ["A", "B"]
# Window parameters for the run_same parity tests. The stall stop and a
# coarser final epsilon keep the auction to a few thousand rounds; the
# repair budget is large enough that HiGHS finishes in both packages.
WINDOW_OPTIM = dict(
    max_matches=1, radius=2.0, knn=4, no_match_penalty=100,
    dist_ct_coeff=1, penalty_coeff=100, delaunay_penalty=10,
    cell_id_col="metacell_id", ref_metacell_match_multiplier=1,
    ignore_same_type_triangles=False, min_angle_deg=5,
)
WINDOW_SOLVER = dict(
    mip_gap=0.025, lazy_allowed_flip_fraction=0.0, tpu_repair_budget=60.0,
    tpu_eps_final=0.05, tpu_auction_patience=128,
)


def labeled_window(seed=0, n_side=8):
    """(ref_df, qry_df): a jittered labeled grid and a label-swapped copy.

    Two cell types in blocks, with probability columns; a few horizontal
    neighbours of the query swap labels so that the feature-optimal
    matching crosses over and flips triangles.
    """
    import pandas as pd

    rng = np.random.default_rng(seed)
    g = (
        np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side)), -1)
        .reshape(-1, 2)
        .astype(float)
    )
    types = ((g[:, 0] // 2 + g[:, 1] // 3) % 2).astype(int)

    def frame(xy, t):
        df = pd.DataFrame(xy, columns=["X", "Y"])
        df["cell_type"] = np.asarray(LABEL_TYPES)[t]
        probs = np.where(t[:, None] == np.arange(2)[None, :], 0.9, 0.1)
        probs = probs + rng.uniform(0, 0.05, probs.shape)
        for k, name in enumerate(LABEL_TYPES):
            df[name] = probs[:, k]
        df["Cell_Num_Old"] = np.arange(len(df))
        return df

    ref = frame(g + rng.normal(0, 0.08, g.shape), types)
    qtypes = types.copy()
    for a in range(n_side + 1, n_side * n_side - 1, 2 * n_side + 2):
        qtypes[a], qtypes[a + 1] = qtypes[a + 1], qtypes[a]
    qry = frame(g + rng.normal(0, 0.08, g.shape), qtypes)
    ref["metacell_id"] = np.arange(len(ref))
    return ref, qry


def run_window(pkg, ref, qry):
    """MS=1 collapse of the query, then ``pkg.run_same`` on the window."""
    mc = pkg.greedy_triangle_collapse(
        qry, max_metacell_size=1, r_max=2.0, min_angle_deg=5,
        return_object=True, verbose=False,
    )
    return pkg.run_same(
        ref_df=ref, aligned_df=mc, commonCT=LABEL_TYPES,
        optim_params=WINDOW_OPTIM, solver_params=WINDOW_SOLVER, verbose=False,
    )


def as_np(x):
    """Host numpy copy of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bit_equal(a, b, what=""):
    """Exact equality of two arrays; float arrays compared bit for bit."""
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        a = a.view(np.int32 if a.dtype == np.float32 else np.int64)
        b = b.view(a.dtype)
    bad = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
    assert bad.size == 0, f"{what}: first difference at flat index {bad[:5]}"


def capture_finish(monkeypatch, module):
    """Record the incumbents and cut registry each solve hands _finish_solve."""
    calls = []
    orig = module._finish_solve

    def spy(*args, **kwargs):
        calls.append(
            {
                "incumbents": args[10],
                "cut_tris": list(args[11]),
                "cut_verts": [np.asarray(v).tolist() for v in args[12]],
                "cut_pairs": [np.asarray(p).tolist() for p in args[13]],
                "cuts_added": args[14],
                "rounds_used": args[15],
            }
        )
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, "_finish_solve", spy)
    return calls


def assert_same_incumbents(got, want):
    """Per-round choices, flips, checks and auction rounds are identical."""
    assert got["rounds_used"] == want["rounds_used"]
    assert len(got["incumbents"]) == len(want["incumbents"])
    for r, (a, b) in enumerate(zip(got["incumbents"], want["incumbents"])):
        for k, name in ((0, "match_ref"), (1, "match_pair"), (2, "flipped"), (3, "checked")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"round {r} {name}")
        assert a[5] == b[5], f"round {r}: auction rounds {a[5]} vs {b[5]}"
    for key in ("cut_tris", "cut_verts", "cut_pairs", "cuts_added"):
        assert got[key] == want[key], key
