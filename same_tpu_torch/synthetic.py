"""Synthetic 4-quadrant benchmark generator (paper-exact regeneration).

Rebuilds the reference benchmark (reference src/synthetic_datagen.py): four
10x10-grid quadrants, 3 cell classes, each quadrant stressing one failure
mode of spatial matching:

- top-left: class c3 entirely missing from the query, plus jitter;
- top-right: smooth GP deformation with noisy (~uniform) class probabilities;
- bottom-right: space fold — shear inside a disc plus 3 swapped adjacent
  point pairs (guaranteed triangle flips);
- bottom-left: topological split — one ellipse of class c2 in the reference
  becomes two rings in the query.

REGENERATION CONTRACT. ``create_full_benchmark(seed=8899)`` reproduces the
committed paper dataset (reference examples/synthetic/data/{ref,query,
ground_truth}.csv) row for row: the paper data was produced by seeding
numpy's legacy global RNG (reference reproduce_figures.ipynb cell 27,
``np.random.seed(8899)``) and consuming it in a fixed call sequence, so
every sampling step below is ordered and shaped to draw the identical
stream — grid jitters, RBF-kernel GP displacement fields (drawn through
``scipy.stats.multivariate_normal`` on the global state), per-row soft
one-hot probabilities, and the simulated expression matrices. Changing the
order, shape, or vectorization of any draw breaks the reproduction; pinned
by tests/test_synthetic_regen.py against the committed CSVs.

Quirk preserved on purpose: ground-truth rows for unmatched bottom-left
query points record ``ref_offset - 1`` (= 299), not -1 — the reference
offsets the per-quadrant ``-1`` sentinel like a local index (reference
src/synthetic_datagen.py:556-560) and the committed ground_truth.csv pins
that behavior.

Copy of ``same_tpu/synthetic.py`` (numpy, pandas and scipy only); the RBF
kernel is written out with scipy where the original calls sklearn.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

CLASS_NAMES = ["c1", "c2", "c3"]
CLASS_COLORS = {"c1": "#FF692A", "c2": "#9810FA", "c3": "#31C950"}


def _jittered_grid(x_range, y_range, n_per_side=10, jitter=0.1):
    """Regular grid + global-RNG gaussian jitter (reference :100-107)."""
    x = np.linspace(x_range[0], x_range[1], n_per_side)
    y = np.linspace(y_range[0], y_range[1], n_per_side)
    gx, gy = np.meshgrid(x, y)
    pts = np.column_stack([gx.ravel(), gy.ravel()])
    return pts + np.random.normal(0, jitter, pts.shape)


def _checkerboard(points, classes_to_use=(0, 1, 2), grid_scale=0.6):
    """Diagonal-stripe class assignment over jittered coords (:119-140)."""
    h = np.floor(points[:, 0] / grid_scale) + np.floor(points[:, 1] / grid_scale)
    h = h.astype(int) % len(classes_to_use)
    return np.asarray(classes_to_use)[h]


def _gp_displacement(points, length_scale, variance=0.05):
    """Smooth 2D displacement field from an RBF-kernel GP (:149-155).

    Drawn via scipy's multivariate normal on the global RNG — the exact
    sampling path the paper data came from (numpy SVD-based transform).
    """
    from scipy.spatial.distance import pdist, squareform
    from scipy.stats import multivariate_normal as mvn

    n = len(points)
    # The RBF kernel as sklearn's ``RBF(length_scale)(points)`` evaluates it
    # (scaled points, condensed squared distances, unit diagonal), so the
    # draws below consume the same covariance bit for bit without sklearn.
    rbf = squareform(np.exp(-0.5 * pdist(points / length_scale, metric="sqeuclidean")))
    np.fill_diagonal(rbf, 1.0)
    K = variance * rbf
    K = K + 1e-6 * np.eye(n)
    return mvn.rvs(mean=np.zeros(n), cov=K, size=2).T


def _soft_probs(classes, confident=True):
    """Per-row soft one-hot, scalar draw order preserved (:158-185)."""
    n = len(classes)
    probs = np.zeros((n, 3))
    for i in range(n):
        c = int(classes[i])
        if confident:
            p_main = 0.85 + np.random.uniform(0, 0.1)
        else:
            p_main = 0.33 + np.random.uniform(0.05, 0.15)
        probs[i, c] = p_main
        rest = 1.0 - p_main
        for j in range(3):
            if j != c:
                probs[i, j] = rest / 2 + np.random.uniform(-0.02, 0.02)
        row = np.clip(probs[i], 0, 1)
        probs[i] = row / row.sum()
    return probs * 100.0


def _quadrant_missing_class():
    """Top-left: query drops every c3 cell + extra jitter (:191-230)."""
    ref = _jittered_grid((1, 6), (7.25, 12.25))
    ref_cls = _checkerboard(ref)
    qry = ref + _gp_displacement(ref, length_scale=2.5)
    keep = ref_cls != 2
    qry = qry[keep]
    qry = qry + np.random.normal(0, 0.1, qry.shape)
    return {
        "ref_points": ref,
        "ref_classes": ref_cls,
        "query_points": qry,
        "query_classes": ref_cls[keep],
        "ground_truth_ref_idx": np.where(keep)[0],
        "description": "Missing class (c3 removed) + jitter on c1",
    }


def _quadrant_noisy_probs():
    """Top-right: GP deformation only; near-uniform probabilities (:236-267)."""
    ref = _jittered_grid((7.25, 12.25), (7.25, 12.25))
    ref_cls = _checkerboard(ref)
    qry = ref + _gp_displacement(ref, length_scale=2.5)
    return {
        "ref_points": ref,
        "ref_classes": ref_cls,
        "query_points": qry,
        "query_classes": ref_cls.copy(),
        "ground_truth_ref_idx": np.arange(len(ref)),
        "description": "GP only + noisy probabilities",
        "use_noisy_probs": True,
    }


def _quadrant_space_fold():
    """Bottom-right: disc shear + 3 nearest-pair swaps = true tears (:273-348)."""
    ref = _jittered_grid((7.25, 12.25), (1, 6))
    ref_cls = _checkerboard(ref)
    qry = ref + _gp_displacement(ref, length_scale=2.0)
    qry = qry + np.random.normal(0, 0.05, qry.shape)

    center = np.array([8.5, 2.5])
    in_disc = np.linalg.norm(ref - center, axis=1) < 2.5
    shear = np.array([[1.0, 0.35], [0.0, 1.0]])
    qry[in_disc] = (qry[in_disc] - center) @ shear.T + center

    # Swap the 3 globally closest ref pairs, excluding already-used points.
    d = np.linalg.norm(ref[:, None, :] - ref[None, :, :], axis=2)
    np.fill_diagonal(d, np.inf)
    gt = np.arange(len(ref))
    swapped = []
    for _ in range(3):
        a, b = np.unravel_index(np.argmin(d), d.shape)
        if not np.isfinite(d[a, b]):
            break
        qry[[a, b]] = qry[[b, a]]
        gt[a], gt[b] = b, a
        swapped.append((int(min(a, b)), int(max(a, b))))
        d[[a, b], :] = np.inf
        d[:, [a, b]] = np.inf
    return {
        "ref_points": ref,
        "ref_classes": ref_cls,
        "query_points": qry,
        "query_classes": ref_cls.copy(),
        "ground_truth_ref_idx": gt,
        "description": "Space fold (point swaps + shear)",
        "swapped_pairs": swapped,
    }


def _quadrant_topological_split():
    """Bottom-left: one c2 ellipse (ref) -> two c2 rings (query) (:354-466)."""
    grid = _jittered_grid((1, 6), (1, 6), jitter=0.05)
    grid_cls = _checkerboard(grid, (0, 2))

    ell_c = np.array([3.5, 3.5])
    ell_a, ell_b = 1.5, 0.8
    r1_c, r2_c = np.array([2.1, 3.5]), np.array([4.1, 3.5])
    ring_r, n_ring = 0.6, 10
    n_ellipse = 2 * n_ring

    d_ell = np.sqrt(
        ((grid[:, 0] - ell_c[0]) / ell_a) ** 2
        + ((grid[:, 1] - ell_c[1]) / ell_b) ** 2
    )
    ref_bg = d_ell > 1.0
    qry_bg = (np.linalg.norm(grid - r1_c, axis=1) > ring_r + 0.1) & (
        np.linalg.norm(grid - r2_c, axis=1) > ring_r + 0.1
    )
    n_ref_bg, n_qry_bg = int(ref_bg.sum()), int(qry_bg.sum())

    ang = np.linspace(0, 2 * np.pi, n_ellipse, endpoint=False)
    ellipse = np.column_stack(
        [ell_c[0] + ell_a * np.cos(ang), ell_c[1] + ell_b * np.sin(ang)]
    )
    ellipse = ellipse + np.random.normal(0, 0.03, ellipse.shape)
    ref_pts = np.vstack([grid[ref_bg], ellipse])
    ref_cls = np.concatenate([grid_cls[ref_bg], np.ones(n_ellipse, dtype=int)])

    bg = grid[qry_bg].copy()
    if len(bg):
        bg += _gp_displacement(bg, length_scale=2)
    ring_ang = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    rings = []
    for rc in (r1_c, r2_c):
        ring = np.column_stack(
            [rc[0] + ring_r * np.cos(ring_ang), rc[1] + ring_r * np.sin(ring_ang)]
        )
        rings.append(ring + np.random.normal(0, 0.03, ring.shape))
    qry_pts = np.vstack([bg] + rings)
    qry_cls = np.concatenate([grid_cls[qry_bg], np.ones(2 * n_ring, dtype=int)])

    gt = np.full(len(qry_pts), -1, dtype=int)
    upto = min(n_qry_bg, n_ref_bg)
    gt[:upto] = np.arange(upto)
    return {
        "ref_points": ref_pts,
        "ref_classes": ref_cls,
        "query_points": qry_pts,
        "query_classes": qry_cls,
        "ground_truth_ref_idx": gt,
        "description": "Topological split (1 ellipse → 2 rings)",
        "n_ref_background": n_ref_bg,
        "n_query_background": n_qry_bg,
        "ellipse_center": ell_c,
        "ellipse_a": ell_a,
        "ellipse_b": ell_b,
        "ring1_center": r1_c,
        "ring2_center": r2_c,
        "ring_radius": ring_r,
    }


def _simulated_expression(classes, n_genes=100):
    """Class-structured positive expression, reference draw order (:472-524)."""
    classes = np.asarray(classes)
    lo, hi = (1, 3), (8, 12)
    means = []
    for c in range(3):
        parts = []
        for block, width in enumerate((34, 33, 33)):
            rng_lo, rng_hi = hi if block == c else lo
            parts.append(np.random.uniform(rng_lo, rng_hi, width))
        means.append(np.concatenate(parts))
    means = np.asarray(means)

    expr = np.zeros((len(classes), n_genes))
    for i in range(len(classes)):
        mu = means[int(classes[i])]
        expr[i] = np.maximum(mu + np.random.normal(0, 0.2 * mu), 0.1)
    gene_names = [f"gene_{i}" for i in range(n_genes)]
    return expr, gene_names


def create_full_benchmark(seed: int | None = 8899):
    """Build the complete 4-quadrant benchmark.

    Returns ``(ref_df, query_df, quadrants, ground_truth_df, expression)``
    following the reference's return contract (src/synthetic_datagen.py:
    530-643); ``expression`` maps 'ref'/'query' to 100-gene DataFrames
    indexed by ``cell_idx``. With the default ``seed=8899`` the output
    equals the committed paper dataset (see module docstring); ``seed=None``
    draws from the current global RNG state (the reference's module-level
    ``np.random.seed(2024)`` behavior is ``np.random.seed(2024)`` followed
    by ``create_full_benchmark(seed=None)``).
    """
    if seed is not None:
        np.random.seed(seed)

    order = ["top_left", "top_right", "bottom_right", "bottom_left"]
    makers = {
        "top_left": _quadrant_missing_class,
        "top_right": _quadrant_noisy_probs,
        "bottom_right": _quadrant_space_fold,
        "bottom_left": _quadrant_topological_split,
    }
    quadrants = {name: makers[name]() for name in order}

    ref_pts, ref_cls, qry_pts, qry_cls = [], [], [], []
    ref_quad, qry_quad, gt_pairs = [], [], []
    r_off = q_off = 0
    for name in order:
        q = quadrants[name]
        # NB: the -1 sentinel is offset too (committed-data quirk, see
        # module docstring).
        for qi, ri in enumerate(q["ground_truth_ref_idx"]):
            gt_pairs.append((q_off + qi, r_off + int(ri)))
        ref_pts.append(q["ref_points"])
        ref_cls.append(q["ref_classes"])
        qry_pts.append(q["query_points"])
        qry_cls.append(q["query_classes"])
        ref_quad.extend([name] * len(q["ref_points"]))
        qry_quad.extend([name] * len(q["query_points"]))
        r_off += len(q["ref_points"])
        q_off += len(q["query_points"])

    ref_pts = np.vstack(ref_pts)
    ref_cls = np.concatenate(ref_cls)
    qry_pts = np.vstack(qry_pts)
    qry_cls = np.concatenate(qry_cls)

    # Probability draws: all ref rows first, then query per quadrant —
    # stream order matters (reference :577-596).
    ref_probs = _soft_probs(ref_cls, confident=True)
    qry_chunks = []
    for name in order:
        q = quadrants[name]
        qry_chunks.append(
            _soft_probs(
                q["query_classes"], confident=not q.get("use_noisy_probs", False)
            )
        )
    qry_probs = np.vstack(qry_chunks)

    def frame(pts, cls, probs, quad_labels):
        return pd.DataFrame(
            {
                "X": pts[:, 0],
                "Y": pts[:, 1],
                "cell_type": [CLASS_NAMES[c] for c in cls],
                "c1": probs[:, 0],
                "c2": probs[:, 1],
                "c3": probs[:, 2],
                "quadrant": quad_labels,
                "cell_idx": np.arange(len(pts)),
            }
        )

    ref_df = frame(ref_pts, ref_cls, ref_probs, ref_quad)
    query_df = frame(qry_pts, qry_cls, qry_probs, qry_quad)
    ground_truth_df = pd.DataFrame(gt_pairs, columns=["query_idx", "ref_idx"])

    expression = {}
    for key, cls, df in (("ref", ref_cls, ref_df), ("query", qry_cls, query_df)):
        mat, gene_names = _simulated_expression(cls)
        e = pd.DataFrame(mat, columns=gene_names)
        e["cell_idx"] = df["cell_idx"].values
        expression[key] = e.set_index("cell_idx")
    return ref_df, query_df, quadrants, ground_truth_df, expression


def print_statistics(ref_df, query_df, quadrants):
    """Per-quadrant summary table (reference notebook companion)."""
    print(f"Template: {len(ref_df)} cells, query: {len(query_df)} cells")
    for name, q in quadrants.items():
        print(
            f"  {name:13s} ref={len(q['ref_points']):4d} "
            f"query={len(q['query_points']):4d}  {q['description']}"
        )


def check_triangle_violations_within_quadrants(matches_df, mc_align):
    """Flag triangle flips, counting only triangles internal to a quadrant.

    Vectorized re-implementation of the reference evaluation helper
    (reference src/synthetic_datagen.py:1314-1418): for every Delaunay
    triangle of the aligned metacells whose three vertices (a) lie in the
    same quadrant and (b) are all matched, compare the signed area at the
    matched reference positions against the query positions; a sign flip
    marks all three nodes. Cross-quadrant triangles are ignored — the
    benchmark's quadrant boundaries are intentional discontinuities.

    Returns a copy of ``matches_df`` with the ``triangle_violation`` column
    replaced by the quadrant-local verdicts.
    """
    simplices = np.asarray(mc_align.metacell_delaunay, dtype=np.int64).reshape(-1, 3)
    metacell_df = mc_align.metacell_df

    if "Aligned_metacell_id" in matches_df.columns:
        aligned_mc = matches_df["Aligned_metacell_id"].to_numpy()
    else:
        aligned_mc = matches_df["aligned_idx"].to_numpy()

    n_mc = len(metacell_df)
    quad = pd.factorize(metacell_df["quadrant"])[0]

    # metacell_id -> row in matches_df (-1 when unmatched).
    mc_to_row = np.full(n_mc, -1, dtype=np.int64)
    valid_ids = (aligned_mc >= 0) & (aligned_mc < n_mc)
    mc_to_row[aligned_mc[valid_ids]] = np.flatnonzero(valid_ids)

    tri_ok = (simplices >= 0).all(axis=1) & (simplices < n_mc).all(axis=1)
    tris = simplices[tri_ok]
    same_quad = (quad[tris[:, 0]] == quad[tris[:, 1]]) & (
        quad[tris[:, 1]] == quad[tris[:, 2]]
    )
    rows = mc_to_row[tris]
    all_matched = (rows >= 0).all(axis=1)
    use = same_quad & all_matched
    rows = rows[use]

    qx = matches_df["X"].to_numpy()
    qy = matches_df["Y"].to_numpy()
    rx = matches_df["ref_X"].to_numpy()
    ry = matches_df["ref_Y"].to_numpy()

    def signed_area(xs, ys):
        return 0.5 * (
            (xs[:, 1] - xs[:, 0]) * (ys[:, 2] - ys[:, 0])
            - (xs[:, 2] - xs[:, 0]) * (ys[:, 1] - ys[:, 0])
        )

    area_q = signed_area(qx[rows], qy[rows])
    area_r = signed_area(rx[rows], ry[rows])
    flipped = area_q * area_r < 0

    violations = np.zeros(len(matches_df), dtype=bool)
    violations[rows[flipped].ravel()] = True
    out = matches_df.copy()
    out["triangle_violation"] = violations
    return out


def simulate_expression(classes, rng=None, n_genes: int = 100):
    """Class-structured positive expression matrix as a DataFrame.

    Thin public wrapper over the draw-order-exact generator; ``rng`` is
    accepted for backward compatibility and ignored (draws come from the
    global stream, matching the regeneration contract).
    """
    mat, gene_names = _simulated_expression(classes, n_genes)
    df = pd.DataFrame(mat, columns=gene_names)
    df.index.name = "cell_idx"
    return df
