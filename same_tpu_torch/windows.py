"""Sliding-window orchestration, resume, and cross-window merge.

Reproduces the reference behaviors:
- ``sliding_window_matching`` (reference src/same.py:297-595): window grid
  with step = window_size - overlap, small-window merging (right then down),
  per-window ``run_same``, central-region crop of half the overlap with edge
  handling, incremental ``matchedDF.csv`` checkpointing, and resume.
- ``get_unprocessed_windows`` (reference src/helpers.py:21-70).
- ``merge_window_matches_unique_ref`` (reference src/helpers.py:692-815):
  dedup preferring non-violating rows then smaller window_id, followed by
  maximum-cardinality bipartite matching so each aligned and ref ID appears
  at most once.

PyTorch port of ``same_tpu/windows.py``: the sequential, the pipelined and
the batched (``mesh=``) path, resume and the merge.
``sliding_window_matching`` takes ``device`` like ``run_same`` (``None`` is
the first CUDA card, ``"cpu"`` on request) and passes it down. With
``mesh`` (a sequence of torch devices, e.g. ``parallel.make_mesh()``) every
window is prepared on the host, the windows' device solves run as one batch
per shape bucket (``parallel.solve_windows_sharded``), and the windows are
finalized in grid order. With ``host_shard=True`` (the multi-process mode,
``parallel.distributed``) each process solves only its block of the grid's
windows, on its own ``device``.

Windows in flight: in the pipelined path up to ``tpu_pipeline_windows`` host
threads run ``solve_prepared`` at once. All of them launch on the device's
one default stream, so their kernels serialize there (an ``auction_loop``
solve is one thread-block cluster; the batched path, ``mesh=``, is the one
that runs several windows' clusters at once). Each solve allocates its own
workspace, and the kernels' launch counts are kept under a lock and per
thread (``kernels/_build.py::count_launch``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import pandas as pd

from .core import run_same
from .models.assignment import resolve_device
from .utils.params import init_optim_params, init_solver_params


def subset_data(df, x_min, x_max, y_min, y_max):
    """Half-open bounding-box subset (reference src/same.py:293-295)."""
    return df[
        (df["X"] >= x_min)
        & (df["X"] < x_max)
        & (df["Y"] >= y_min)
        & (df["Y"] < y_max)
    ]


def get_unprocessed_windows(
    moving_df,
    output_name,
    x_windows,
    y_windows,
    window_size,
    overlap,
    cell_id_col="Cell_Num_Old",
):
    """Resume support: which (i, j) windows still need processing.

    Parity with reference src/helpers.py:21-70, including the
    ``window_id = len(x_windows) * j + i`` decoding.
    """
    all_windows = {}
    for i, x in enumerate(x_windows):
        for j, y in enumerate(y_windows):
            cells = moving_df[
                (moving_df["X"] >= x)
                & (moving_df["X"] < x + window_size)
                & (moving_df["Y"] >= y)
                & (moving_df["Y"] < y + window_size)
            ][cell_id_col].unique()
            if len(cells) > 0:
                all_windows[(i, j)] = set(cells)

    try:
        existing = pd.read_csv(output_name)
    except FileNotFoundError:
        return set(all_windows.keys()), None

    processed = set()
    if "window_id" in existing.columns:
        processed = set(existing["window_id"].unique())
    processed_coords = {
        (wid % len(x_windows), wid // len(x_windows)) for wid in processed
    }
    return set(all_windows.keys()) - processed_coords, existing


def _collect_window_tasks(
    ref, moving, x_windows, y_windows, window_size, overlap, min_cells,
    windows_to_process, x_min, x_max, y_min, y_max, verbose,
):
    """Walk the window grid and emit solvable window tasks.

    Replicates the reference's traversal exactly (src/same.py:507-593):
    undersized windows merge right then down (consuming the next i or j),
    and each emitted task carries its central-crop bounds. Both the
    sequential and the mesh-sharded execution paths consume this list, so
    their window decomposition is identical by construction.
    """
    tasks = []
    i = 0
    while i < len(x_windows):
        j = 0
        while j < len(y_windows):
            if windows_to_process is not None and (i, j) not in windows_to_process:
                j += 1
                continue
            x = x_windows[i]
            y = y_windows[j]
            x_w_min, x_w_max = x, x + window_size
            y_w_min, y_w_max = y, y + window_size

            ref_sub = subset_data(ref, x_w_min, x_w_max, y_w_min, y_w_max)
            mov_sub = subset_data(moving, x_w_min, x_w_max, y_w_min, y_w_max)

            # Merge undersized windows right, then down (:527-542).
            if len(ref_sub) < min_cells or len(mov_sub) < min_cells:
                if i + 1 < len(x_windows):
                    x_w_max = x_windows[i + 1] + window_size
                    ref_sub = subset_data(ref, x_w_min, x_w_max, y_w_min, y_w_max)
                    mov_sub = subset_data(moving, x_w_min, x_w_max, y_w_min, y_w_max)
                    if len(ref_sub) >= min_cells and len(mov_sub) >= min_cells:
                        i += 1
                if (len(ref_sub) < min_cells or len(mov_sub) < min_cells) and (
                    j + 1 < len(y_windows)
                ):
                    y_w_max = y_windows[j + 1] + window_size
                    ref_sub = subset_data(ref, x_w_min, x_w_max, y_w_min, y_w_max)
                    mov_sub = subset_data(moving, x_w_min, x_w_max, y_w_min, y_w_max)
                    if len(ref_sub) >= min_cells and len(mov_sub) >= min_cells:
                        j += 1

            if verbose:
                print(
                    f"Window at ({x}, {y}) - Ref cells: {len(ref_sub)}, "
                    f"Moving cells: {len(mov_sub)}"
                )

            if len(ref_sub) >= min_cells and len(mov_sub) >= min_cells:
                window_id = len(x_windows) * j + i
                # Central crop of half the overlap, except at edges (:564-582).
                is_left = x == int(x_min)
                is_right = x_w_max >= int(x_max)
                is_top = y == int(y_min)
                is_bottom = y_w_max >= int(y_max)
                crop = (
                    x_w_min if is_left else x_w_min + overlap / 2,
                    x_w_max if is_right else x_w_max - overlap / 2,
                    y_w_min if is_top else y_w_min + overlap / 2,
                    y_w_max if is_bottom else y_w_max - overlap / 2,
                )
                tasks.append(
                    {
                        "window_id": window_id,
                        "ref_sub": ref_sub,
                        "mov_sub": mov_sub,
                        "crop": crop,
                    }
                )
            j += 1
        i += 1
    return tasks


def sliding_window_matching(
    ref,
    moving,
    commonCT=None,
    outprefix: Optional[str] = None,
    moving_delaunay=None,
    moving_delaunay_vertex_col: Optional[str] = None,
    optim_params: Optional[Dict[str, Any]] = None,
    gurobi_params: Optional[Dict[str, Any]] = None,
    solver_params: Optional[Dict[str, Any]] = None,
    ignore_precomputed_triangulation: bool = False,
    mesh=None,
    host_shard: bool = False,
    verbose: bool = True,
    device=None,
):
    """Match cells between datasets window by window; returns merged matches.

    See module docstring; the signature and semantics mirror the reference
    (src/same.py:297-595) with ``solver_params`` as the TPU-era alias for
    ``gurobi_params``. ``device`` is where the windows are solved: the first
    CUDA card by default (raises without one), ``"cpu"`` on request.

    ``mesh`` (a sequence of torch devices) solves the windows as batches of
    one shape bucket each, sharded over its devices.

    ``host_shard=True`` is the multi-process mode: after the window grid is
    collected (identically on every process) each process keeps only its
    ``parallel.distributed.host_window_slice`` of the tasks, solves them on
    ``device`` and returns just those windows' matches; callers gather the
    shards with ``distributed.gather_matches`` and run the uniqueness merge
    on the root. Window ids stay globally consistent because the grid
    (including small-window merging) is computed from the full extent on
    every process. Processes that share ``outprefix`` overwrite each other's
    ``matchedDF.csv``, as in the JAX package (ROADMAP C14): give each its own.
    """
    device = resolve_device(device)
    ref_cell_type_col = "cell_type"
    moving_cell_type_col = "cell_type"
    optim_params = dict(optim_params or {})
    if solver_params is None:
        solver_params = dict(gurobi_params or {})

    # MetaCell duck-typing (reference :418-435).
    if hasattr(ref, "metacell_df"):
        mc_ref = ref
        ref = mc_ref.metacell_df
        if hasattr(mc_ref, "cell_type_col"):
            ref_cell_type_col = mc_ref.cell_type_col
        if (optim_params.get("cell_id_col") is None) and hasattr(
            mc_ref, "metacell_idx_col"
        ):
            optim_params["cell_id_col"] = mc_ref.metacell_idx_col
    if hasattr(moving, "metacell_df") and hasattr(moving, "metacell_delaunay"):
        mc = moving
        moving = mc.metacell_df
        if moving_delaunay is None and not ignore_precomputed_triangulation:
            moving_delaunay = mc.metacell_delaunay
        if moving_delaunay_vertex_col is None and hasattr(mc, "metacell_idx_col"):
            moving_delaunay_vertex_col = mc.metacell_idx_col
        if hasattr(mc, "cell_type_col"):
            moving_cell_type_col = mc.cell_type_col
        if (optim_params.get("cell_id_col") is None) and hasattr(
            mc, "metacell_idx_col"
        ):
            optim_params["cell_id_col"] = mc.metacell_idx_col

    optim = init_optim_params(**optim_params)
    solver = init_solver_params(**solver_params)

    window_size = optim["window_size"]
    overlap = optim["overlap"]
    min_cells = optim["min_cells_per_window"]
    cell_id_col = optim["cell_id_col"]

    # Strict cell-type category check + commonCT inference (:445-478).
    ref_types = mov_types = None
    if ref_cell_type_col in ref.columns and moving_cell_type_col in moving.columns:
        ref_types = set(pd.Series(ref[ref_cell_type_col]).dropna().unique().tolist())
        mov_types = set(
            pd.Series(moving[moving_cell_type_col]).dropna().unique().tolist()
        )
        if ref_types != mov_types:
            raise ValueError(
                "Cell type categories differ between ref and moving.\n"
                f"ref ({ref_cell_type_col}) has {len(ref_types)} types, moving "
                f"({moving_cell_type_col}) has {len(mov_types)} types.\n"
                f"Only-in-ref: {sorted(ref_types - mov_types)[:20]}\n"
                f"Only-in-moving: {sorted(mov_types - ref_types)[:20]}"
            )
    if commonCT is None:
        if ref_types is None:
            raise ValueError(
                "commonCT is None, but cell_type columns were not found to infer "
                "it. Pass commonCT explicitly (list of probability/one-hot "
                "columns), or ensure both dataframes have "
                f"'{ref_cell_type_col}'/'{moving_cell_type_col}'."
            )
        commonCT = sorted(ref_types)
        missing_ref = [c for c in commonCT if c not in ref.columns]
        missing_mov = [c for c in commonCT if c not in moving.columns]
        if missing_ref or missing_mov:
            raise ValueError(
                "commonCT was inferred from cell_type values, but those names "
                "are not probability columns.\n"
                f"Missing in ref (first 20): {missing_ref[:20]}\n"
                f"Missing in moving (first 20): {missing_mov[:20]}"
            )

    x_min = min(ref["X"].min(), moving["X"].min())
    x_max = max(ref["X"].max(), moving["X"].max())
    y_min = min(ref["Y"].min(), moving["Y"].min())
    y_max = max(ref["Y"].max(), moving["Y"].max())
    step = window_size - overlap
    x_windows = list(range(int(x_min), int(x_max), step))
    y_windows = list(range(int(y_min), int(y_max), step))

    all_matches = []
    output_file = None
    windows_to_process = None
    if outprefix:
        os.makedirs(outprefix, exist_ok=True)
        output_file = os.path.join(outprefix, "matchedDF.csv")
        windows_to_process, existing = get_unprocessed_windows(
            moving, output_file, x_windows, y_windows, window_size, overlap,
            cell_id_col=cell_id_col,
        )
        if existing is not None:
            all_matches.append(existing)

    tasks = _collect_window_tasks(
        ref, moving, x_windows, y_windows, window_size, overlap, min_cells,
        windows_to_process, x_min, x_max, y_min, y_max, verbose,
    )

    if host_shard:
        from .parallel.distributed import host_window_slice

        sl = host_window_slice(len(tasks))
        if verbose:
            print(
                f"host_shard: process owns windows [{sl.start}, {sl.stop}) "
                f"of {len(tasks)}"
            )
        tasks = tasks[sl]

    def _crop_and_record(task, window_matches):
        if window_matches.shape[0] == 0:
            return
        x_lo, x_hi, y_lo, y_hi = task["crop"]
        central = window_matches[
            (window_matches["X"] >= x_lo)
            & (window_matches["X"] < x_hi)
            & (window_matches["Y"] >= y_lo)
            & (window_matches["Y"] < y_hi)
        ].copy()
        central["window_id"] = task["window_id"]
        if len(central) > 0:
            all_matches.append(central)
            if outprefix:
                pd.concat(all_matches, ignore_index=True).to_csv(
                    output_file, index=False
                )

    def _window_outprefix(task):
        return (
            os.path.join(outprefix, f"window_{task['window_id']}")
            if outprefix
            else None
        )

    pipeline_k = int(solver.get("tpu_pipeline_windows", 2) or 1)
    if mesh is None and (pipeline_k <= 1 or len(tasks) <= 1):
        for task in tasks:
            window_matches, _var_out = run_same(
                aligned_df=task["mov_sub"],
                ref_df=task["ref_sub"],
                commonCT=commonCT,
                optim_params=optim,
                solver_params=solver,
                outprefix=_window_outprefix(task),
                aligned_delaunay=moving_delaunay,
                aligned_delaunay_vertex_col=moving_delaunay_vertex_col,
                ignore_precomputed_triangulation=ignore_precomputed_triangulation,
                verbose=verbose,
                device=device,
            )
            _crop_and_record(task, window_matches)
    elif mesh is None:
        # Pipelined sequential path: up to ``tpu_pipeline_windows`` windows
        # in flight so one window's device separation overlaps another's
        # host repair (scipy's HiGHS releases the GIL). Host-heavy stages
        # (prepare / finish+repair / finalize) are serialized by the shared
        # HOST_LOCK — the wall-clock-budgeted repair never competes for the
        # host — while device separation runs outside it. Results are
        # recorded in grid order, so outputs and the resume checkpoint are
        # identical to the sequential path's.
        from concurrent.futures import ThreadPoolExecutor

        from .core import (
            EmptyWindowError,
            empty_matches_df,
            finalize_window,
            prepare_window,
            solve_prepared,
        )
        from .utils.concurrency import HOST_LOCK

        def _solve_one(task):
            try:
                with HOST_LOCK:
                    pw = prepare_window(
                        task["ref_sub"],
                        task["mov_sub"],
                        commonCT,
                        aligned_delaunay=moving_delaunay,
                        aligned_delaunay_vertex_col=moving_delaunay_vertex_col,
                        optim_params=optim,
                        solver_params=solver,
                        ignore_precomputed_triangulation=ignore_precomputed_triangulation,
                        verbose=verbose,
                        device=device,
                    )
            except EmptyWindowError:
                return empty_matches_df(commonCT, optim["cell_id_col"])
            res = solve_prepared(pw, verbose=verbose, device=device)
            with HOST_LOCK:
                window_matches, _var_out = finalize_window(
                    pw, res, outprefix=_window_outprefix(task), verbose=verbose
                )
            return window_matches

        with ThreadPoolExecutor(max_workers=pipeline_k) as pool:
            futures = [pool.submit(_solve_one, task) for task in tasks]
            for task, fut in zip(tasks, futures):
                _crop_and_record(task, fut.result())
    else:
        # Batched path: host preprocessing per window, then the batched
        # device solve (full tearing separation) sharded over the mesh, then
        # per-window finalization in grid order.
        from .core import (
            EmptyWindowError,
            empty_matches_df,
            finalize_window,
            prepare_window,
        )
        from .parallel import solve_windows_sharded

        prepared, kept_tasks = [], []
        for task in tasks:
            try:
                prepared.append(
                    prepare_window(
                        task["ref_sub"],
                        task["mov_sub"],
                        commonCT,
                        aligned_delaunay=moving_delaunay,
                        aligned_delaunay_vertex_col=moving_delaunay_vertex_col,
                        optim_params=optim,
                        solver_params=solver,
                        ignore_precomputed_triangulation=ignore_precomputed_triangulation,
                        verbose=verbose,
                        device=device,
                    )
                )
                kept_tasks.append(task)
            except EmptyWindowError:
                # Reference behavior: such windows emit zero matches.
                _crop_and_record(
                    task, empty_matches_df(commonCT, optim["cell_id_col"])
                )
        results = solve_windows_sharded(prepared, mesh=mesh, verbose=verbose)
        for task, pw, res in zip(kept_tasks, prepared, results):
            window_matches, _var_out = finalize_window(
                pw, res, outprefix=_window_outprefix(task), verbose=verbose
            )
            _crop_and_record(task, window_matches)

    return (
        pd.concat(all_matches, ignore_index=True) if all_matches else pd.DataFrame()
    )


def merge_window_matches_unique_ref(matches_list, cell_id_col="Cell_Num_Old"):
    """Merge per-window matches into a one-to-one maximum-cardinality set.

    Parity with reference src/helpers.py:692-815: dedup identical
    (aligned, ref) pairs preferring ``filtered_violation == False`` then
    smaller ``window_id`` (stable sort), then maximum-cardinality bipartite
    matching between aligned and ref IDs. Uses the first-party C++
    Hopcroft-Karp when built (native/), else scipy's implementation.
    """
    if not matches_list:
        return pd.DataFrame()
    if isinstance(matches_list, pd.DataFrame):
        matches_list = [matches_list]

    merged = pd.concat(matches_list, ignore_index=True)
    aligned_col = f"Aligned_{cell_id_col}"
    ref_col = f"Ref_{cell_id_col}"
    required = ["window_id", aligned_col, ref_col, "X", "Y", "filtered_violation"]
    missing = [c for c in required if c not in merged.columns]
    if missing:
        raise ValueError(f"Missing required columns in matches: {missing}")

    merged["filtered_violation"] = (
        merged["filtered_violation"].fillna(True).astype(bool)
    )
    merged = merged.sort_values(
        by=["filtered_violation", "window_id"], ascending=[True, True],
        kind="mergesort",
    )
    merged = merged.drop_duplicates(subset=[aligned_col, ref_col], keep="first")

    aligned_vals = merged[aligned_col].to_numpy()
    ref_vals = merged[ref_col].to_numpy()
    unique_aligned = sorted(pd.unique(aligned_vals))
    unique_ref = sorted(pd.unique(ref_vals))
    a_idx = {a: i for i, a in enumerate(unique_aligned)}
    b_idx = {b: i for i, b in enumerate(unique_ref)}
    ai = np.array([a_idx[a] for a in aligned_vals])
    bi = np.array([b_idx[b] for b in ref_vals])

    pairing = _max_bipartite_matching(ai, bi, len(unique_aligned), len(unique_ref))

    # Row per matched (aligned, ref) edge; dedup kept one row per edge.
    edge_row = {}
    for row, (x, yv) in enumerate(zip(ai, bi)):
        edge_row.setdefault((x, yv), row)
    selected = [
        edge_row[(x, pairing[x])] for x in range(len(unique_aligned))
        if pairing[x] >= 0 and (x, pairing[x]) in edge_row
    ]
    return merged.iloc[selected].copy().reset_index(drop=True)


def _max_bipartite_matching(ai, bi, n_a, n_b):
    """Maximum-cardinality matching; returns per-aligned ref index or -1.

    Deterministic across backends: the Python fallback mirrors the native
    C++ Hopcroft-Karp's traversal order exactly (adjacency in edge input
    order, BFS/DFS in ascending left-vertex order), so the SELECTED edge
    set — not just its cardinality — is identical whether or not
    native/libsame_native.so is built (reference tie-break determinism,
    src/helpers.py:755-760 + SURVEY §7.3 item 6).
    """
    try:
        from .utils.native import native_hopcroft_karp

        res = native_hopcroft_karp(ai, bi, n_a, n_b)
        if res is not None:
            return res
    except Exception:
        pass
    return _hopcroft_karp_py(ai, bi, n_a, n_b)


def _hopcroft_karp_py(ai, bi, n_a, n_b):
    """Pure-Python Hopcroft-Karp, order-identical to native same_hopcroft_karp.

    Same phase structure (BFS layering from all free left vertices, then DFS
    augmentation over left vertices in ascending order, adjacency scanned in
    edge input order, dist[u] poisoned to INF on DFS failure) so the matched
    edge set is bit-identical to the C++ implementation's.
    """
    from collections import deque

    INF = np.iinfo(np.int64).max
    adj = [[] for _ in range(n_a)]
    for u, v in zip(ai, bi):
        adj[int(u)].append(int(v))
    match_l = np.full(n_a, -1, dtype=np.int64)
    match_r = np.full(n_b, -1, dtype=np.int64)
    dist = np.empty(n_a, dtype=np.int64)

    def bfs():
        q = deque()
        for u in range(n_a):
            if match_l[u] < 0:
                dist[u] = 0
                q.append(u)
            else:
                dist[u] = INF
        found = False
        while q:
            u = q.popleft()
            du = dist[u]
            for v in adj[u]:
                w = match_r[v]
                if w < 0:
                    found = True
                elif dist[w] == INF:
                    dist[w] = du + 1
                    q.append(w)
        return found

    def dfs(root):
        # Iterative DFS preserving the recursive C++ order: stack frames of
        # (vertex, next adjacency index); on failure dist[u] = INF.
        stack = [(root, 0)]
        while stack:
            u, i = stack[-1]
            advanced = False
            while i < len(adj[u]):
                v = adj[u][i]
                i += 1
                w = match_r[v]
                if w < 0:
                    # Augment along the stack: each frame's current edge is
                    # adj[u][i-1] with i already advanced.
                    stack[-1] = (u, i)
                    for uu, ii in reversed(stack):
                        vv = adj[uu][ii - 1]
                        match_r[vv] = uu
                        match_l[uu] = vv
                    return True
                if dist[w] == dist[u] + 1:
                    stack[-1] = (u, i)
                    stack.append((w, 0))
                    advanced = True
                    break
            if not advanced:
                dist[u] = INF
                stack.pop()
        return False

    while bfs():
        for u in range(n_a):
            if match_l[u] < 0:
                dfs(u)
    return match_l
