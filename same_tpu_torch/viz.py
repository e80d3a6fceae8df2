"""Visualization utilities for benchmarks and matchings.

Counterparts to the reference's plotting helpers
(src/synthetic_datagen.py:646-1239): benchmark overview panels, match-line
overlays, and triangle-violation maps. Figures only — no solver coupling.
All functions return the matplotlib Figure for saving/notebook display.
"""

from __future__ import annotations

import numpy as np

CLASS_COLORS = {"c1": "#FF692A", "c2": "#9810FA", "c3": "#31C950"}


def _colors_for(types):
    uniq = sorted(set(types))
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("tab10")
    lookup = {
        t: CLASS_COLORS.get(t, cmap(i % 10)) for i, t in enumerate(uniq)
    }
    return [lookup[t] for t in types], lookup


def visualize_benchmark(ref_df, query_df, figsize=(14, 4)):
    """Three-panel overview: reference, query, and overlay."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=figsize)
    for ax, df, title in [
        (axes[0], ref_df, "reference / template"),
        (axes[1], query_df, "query / moving"),
    ]:
        colors, _ = _colors_for(df["cell_type"])
        ax.scatter(df["X"], df["Y"], c=colors, s=12)
        ax.set_title(title)
        ax.set_aspect("equal")
    axes[2].scatter(ref_df["X"], ref_df["Y"], c="lightgray", s=12, label="ref")
    colors, _ = _colors_for(query_df["cell_type"])
    axes[2].scatter(query_df["X"], query_df["Y"], c=colors, s=8, label="query")
    axes[2].set_title("overlay")
    axes[2].set_aspect("equal")
    fig.tight_layout()
    return fig


def visualize_matches(
    matches_df, ref_df=None, query_df=None, max_lines=5000, figsize=(7, 7)
):
    """Match-line plot: segments from query positions to matched ref positions.

    Violating matches (``triangle_violation``) drawn in red.
    """
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    if ref_df is not None:
        ax.scatter(ref_df["X"], ref_df["Y"], c="lightgray", s=8)
    sub = matches_df.head(max_lines)
    viol = (
        sub["triangle_violation"].to_numpy()
        if "triangle_violation" in sub.columns
        else np.zeros(len(sub), bool)
    )
    for flag, color, alpha in [(False, "steelblue", 0.4), (True, "crimson", 0.8)]:
        rows = sub[viol == flag]
        for _, row in rows.iterrows():
            ax.plot(
                [row["X"], row["ref_X"]],
                [row["Y"], row["ref_Y"]],
                color=color,
                alpha=alpha,
                linewidth=0.6,
            )
    ax.scatter(sub["X"], sub["Y"], c="black", s=4)
    ax.set_aspect("equal")
    ax.set_title(
        f"{len(matches_df)} matches, "
        f"{int(viol.sum())} in flipped triangles"
    )
    fig.tight_layout()
    return fig


def visualize_triangulation(
    coords, triangles, flipped=None, figsize=(7, 7)
):
    """Triangulation wireframe; flipped triangles filled red."""
    import matplotlib.pyplot as plt

    coords = np.asarray(coords, dtype=float)
    triangles = np.asarray(triangles, dtype=int).reshape(-1, 3)
    fig, ax = plt.subplots(figsize=figsize)
    ax.triplot(
        coords[:, 0], coords[:, 1], triangles, color="gray", linewidth=0.5
    )
    if flipped is not None and np.asarray(flipped).any():
        flipped = np.asarray(flipped, bool)
        for tri in triangles[flipped[: len(triangles)]]:
            ax.fill(coords[tri, 0], coords[tri, 1], color="crimson", alpha=0.5)
    ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def visualize_benchmark_v2(ref_df, query_df, figsize=(12, 6)):
    """Two-panel benchmark overview with quadrant annotations.

    Counterpart of reference src/synthetic_datagen.py:768-1011: reference
    and query side by side, quadrant names printed at each quadrant's
    centroid, cell classes colored consistently.
    """
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=figsize)
    for ax, df, title in [
        (axes[0], ref_df, "reference / template"),
        (axes[1], query_df, "query / moving"),
    ]:
        colors, lookup = _colors_for(df["cell_type"])
        ax.scatter(df["X"], df["Y"], c=colors, s=10)
        if "quadrant" in df.columns:
            for name, sub in df.groupby("quadrant"):
                ax.annotate(
                    name,
                    (sub["X"].mean(), sub["Y"].mean()),
                    ha="center", fontsize=11, fontweight="bold", alpha=0.7,
                )
        ax.set_title(title)
        ax.set_aspect("equal")
    handles = [
        plt.Line2D([], [], marker="o", ls="", color=c, label=t)
        for t, c in lookup.items()
    ]
    axes[1].legend(handles=handles, loc="upper right", fontsize=8)
    fig.tight_layout()
    return fig


def visualize_space_tearing(
    quadrants, q_name="bottom_right", min_angle_deg=10, figsize=(12, 6)
):
    """Before/after view of the space-fold quadrant with flipped triangles.

    Counterpart of reference src/synthetic_datagen.py:1014-1169: the
    reference-side triangulation, the same triangles drawn at the query
    (folded) positions, and sign-flipped triangles filled red.
    """
    import matplotlib.pyplot as plt

    from .geometry import delaunay_simplices, filter_triangles_by_radius

    q = quadrants[q_name]
    ref_pts = np.asarray(q["ref_points"], float)
    qry_pts = np.asarray(q["query_points"], float)
    gt = np.asarray(q["ground_truth_ref_idx"], int)

    tris = delaunay_simplices(ref_pts)
    tris = np.asarray(
        filter_triangles_by_radius(
            ref_pts, tris, radius=1e9, min_angle_deg=min_angle_deg,
            verbose=False,
        )
    ).reshape(-1, 3)

    # Triangle flips: ref triangle vs its image under the ground-truth map.
    inv = np.full(len(ref_pts), -1, int)
    ok = gt >= 0
    inv[gt[ok]] = np.flatnonzero(ok)
    mapped = inv[tris]
    tri_ok = (mapped >= 0).all(axis=1)

    def areas(pts, t):
        a, b, c = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
        return (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
            b[:, 1] - a[:, 1]
        ) * (c[:, 0] - a[:, 0])

    flipped = np.zeros(len(tris), bool)
    flipped[tri_ok] = (
        areas(ref_pts, tris[tri_ok]) * areas(qry_pts, mapped[tri_ok]) < 0
    )

    fig, axes = plt.subplots(1, 2, figsize=figsize)
    axes[0].triplot(ref_pts[:, 0], ref_pts[:, 1], tris, color="gray", lw=0.5)
    axes[0].set_title(f"{q_name}: reference triangulation")
    axes[1].triplot(
        qry_pts[:, 0], qry_pts[:, 1], mapped[tri_ok], color="gray", lw=0.5
    )
    for tri in mapped[flipped[: len(mapped)] & tri_ok]:
        axes[1].fill(qry_pts[tri, 0], qry_pts[tri, 1], color="crimson", alpha=0.6)
    axes[1].set_title(
        f"query (folded): {int(flipped.sum())} flipped triangles"
    )
    for ax in axes:
        ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def visualize_topological_merger(quadrants, q_name="bottom_left", figsize=(12, 6)):
    """Topological-split quadrant: one structure vs its split image.

    Counterpart of reference src/synthetic_datagen.py:1172-1239.
    """
    import matplotlib.pyplot as plt

    q = quadrants[q_name]
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    for ax, pts, cls, title in [
        (axes[0], q["ref_points"], q["ref_classes"], "reference"),
        (axes[1], q["query_points"], q["query_classes"], "query (split)"),
    ]:
        pts = np.asarray(pts, float)
        colors, _ = _colors_for([f"c{c + 1}" for c in np.asarray(cls)])
        ax.scatter(pts[:, 0], pts[:, 1], c=colors, s=14)
        ax.set_title(f"{q_name}: {title}")
        ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def print_statistics(ref_df, query_df, quadrants=None):
    """Per-quadrant / per-class composition table (reference :1242-1311)."""
    print(f"Reference cells: {len(ref_df)}; query cells: {len(query_df)}")
    for label, df in [("reference", ref_df), ("query", query_df)]:
        if "quadrant" in df.columns:
            counts = (
                df.groupby(["quadrant", "cell_type"]).size().unstack(fill_value=0)
            )
            print(f"\n{label} composition (rows=quadrant):")
            print(counts.to_string())
    if quadrants:
        print("\nquadrant scenarios:")
        for name, q in quadrants.items():
            gt = np.asarray(q["ground_truth_ref_idx"])
            print(
                f"  {name}: {len(q['query_points'])} query / "
                f"{len(q['ref_points'])} ref, "
                f"{int((gt >= 0).sum())} ground-truth pairs"
            )


def plot_quadrant_summary(per_quadrant_df, figsize=(9, 4)):
    """Fig-2-style panel: per-quadrant accuracy and violation bars."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=figsize, sharex=True)
    x = np.arange(len(per_quadrant_df))
    axes[0].bar(x, per_quadrant_df["accuracy"], color="#5B8DEF")
    axes[0].set_title("ground-truth accuracy")
    axes[0].set_ylim(0, 1.02)
    axes[1].bar(x, per_quadrant_df["violation_frac"], color="#E4572E")
    axes[1].set_title("triangle-violation fraction")
    for ax in axes:
        ax.set_xticks(x)
        ax.set_xticklabels(per_quadrant_df["quadrant"], rotation=30, ha="right")
    fig.tight_layout()
    return fig


def plot_window_grid(matches_df, figsize=(7, 7)):
    """Scatter of matches colored by window_id (sliding-window diagnostics)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    sc = ax.scatter(
        matches_df["X"], matches_df["Y"], c=matches_df["window_id"],
        cmap="tab20", s=6,
    )
    fig.colorbar(sc, ax=ax, label="window_id")
    ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def plot_match_lines(
    matches_df, ref_df, violation_col="triangle_violation", figsize=(8, 6)
):
    """Fig-2-style match overlay: query->ref displacement lines, violations
    highlighted (reference synthetic reproduce_figures.ipynb cell 23 —
    good matches as faint black lines, violating nodes as magenta).
    """
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    ax.scatter(
        ref_df["X"], ref_df["Y"], c="tab:blue", marker="P", s=20, alpha=0.3
    )
    bad = matches_df[violation_col].astype(bool)
    good, viol = matches_df[~bad], matches_df[bad]
    for _, row in good.iterrows():
        ax.plot(
            [row["X"], row["ref_X"]], [row["Y"], row["ref_Y"]],
            "k-", alpha=0.3, linewidth=1,
        )
    for _, row in viol.iterrows():
        ax.plot(
            [row["X"], row["ref_X"]], [row["Y"], row["ref_Y"]],
            "m-", alpha=0.8, linewidth=1.5,
        )
    ax.scatter(good["X"], good["Y"], c="tab:blue", s=30,
               label=f"Good ({len(good)})")
    ax.scatter(viol["X"], viol["Y"], c="magenta", s=50, marker="x",
               linewidths=2, label=f"Violation ({len(viol)})")
    ax.set_title("Matches and triangle violations")
    ax.legend()
    ax.set_aspect("equal")
    ax.set_axis_off()
    fig.tight_layout()
    return fig


def plot_accuracy_violation_sweep(sweep_df, label_col="dp", figsize=(6, 5)):
    """Fig-3c-style frontier: cell-type accuracy vs triangle violations per
    parameter setting (one point per dp / MS / knn configuration).
    """
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(
        sweep_df["violations_pct"], sweep_df["accuracy_pct"],
        "o-", color="#5B8DEF",
    )
    for _, row in sweep_df.iterrows():
        ax.annotate(
            f"{label_col}={row[label_col]:g}",
            (row["violations_pct"], row["accuracy_pct"]),
            textcoords="offset points", xytext=(6, 4), fontsize=9,
        )
    ax.set_xlabel("triangle violations (%)")
    ax.set_ylabel("cell-type accuracy (%)")
    ax.set_title("Accuracy / tearing frontier")
    fig.tight_layout()
    return fig


def plot_knn_sweep(sweep_df, figsize=(7, 4)):
    """Fig-S4-style panel: accuracy and violation fraction vs candidate kNN
    (reference examples/heart/run_parameter_sweep.sh kNN sweep).

    Expects columns ``knn``, ``ct_accuracy`` (0-1), ``violation_frac`` (0-1).
    """
    import matplotlib.pyplot as plt

    df = sweep_df.sort_values("knn")
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(df["knn"], 100 * df["ct_accuracy"], "o-", color="#5B8DEF",
            label="cell-type accuracy")
    ax.set_xlabel("kNN candidates per query cell")
    ax.set_ylabel("cell-type accuracy (%)", color="#5B8DEF")
    ax2 = ax.twinx()
    ax2.plot(df["knn"], 100 * df["violation_frac"], "s--", color="#E8590C",
             label="violation nodes")
    ax2.set_ylabel("violation nodes (%)", color="#E8590C")
    ax.set_title("Candidate-set size sweep")
    fig.tight_layout()
    return fig


def plot_ms_dp_heatmap(sweep_df, value="ct_accuracy", scale=100.0,
                       fmt="{:.1f}", figsize=(7, 3.2)):
    """Fig-S6/S7-style heatmap: a metric over the MS x dp grid
    (reference examples/heart/run_parameter_sweep.sh MS/dp sweep).

    Expects columns ``ms``, ``dp`` and ``value``; ``scale`` converts
    fractions to percent for display.
    """
    import matplotlib.pyplot as plt

    pivot = sweep_df.pivot_table(index="ms", columns="dp", values=value)
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(pivot.to_numpy() * scale, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(pivot.columns)), [f"{c:g}" for c in pivot.columns])
    ax.set_yticks(range(len(pivot.index)), [f"{i:g}" for i in pivot.index])
    ax.set_xlabel("delaunay_penalty (dp)")
    ax.set_ylabel("max metacell size (MS)")
    for r in range(pivot.shape[0]):
        for c in range(pivot.shape[1]):
            v = pivot.to_numpy()[r, c] * scale
            if np.isfinite(v):
                ax.text(c, r, fmt.format(v), ha="center", va="center",
                        color="white", fontsize=8)
    fig.colorbar(im, ax=ax, label=value)
    ax.set_title(f"{value} over MS x dp")
    fig.tight_layout()
    return fig


def plot_noise_robustness(noise_df, baseline_pct=None, figsize=(6, 4)):
    """Fig-S5-style panel: accuracy vs Dirichlet label-noise level
    (reference examples/heart/run_robustness.sh).

    Expects columns ``noise`` and ``accuracy_pct``.
    """
    import matplotlib.pyplot as plt

    df = noise_df.sort_values("noise")
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(df["noise"], df["accuracy_pct"], "o-", color="#5B8DEF")
    if baseline_pct is not None:
        ax.axhline(baseline_pct, ls=":", color="#999999",
                   label=f"image-only baseline ({baseline_pct:.1f}%)")
        ax.legend()
    ax.set_xlabel("Dirichlet mixture noise $\\eta$")
    ax.set_ylabel("1-NN cell-type accuracy (%)")
    ax.set_title("Label-noise robustness")
    fig.tight_layout()
    return fig
