"""Metacell coarsening: greedy same-type triangle collapse + unpacking.

Functional parity with the reference (src/metacell_utils.py):
- ``MetaCell`` dataclass container with the same fields and helper methods;
- ``greedy_triangle_collapse`` (reference :160-561): iteratively merge
  same-type Delaunay triangles (merged size <= max_metacell_size), batched
  per iteration as a non-overlapping set ordered by perimeter; merged
  metacells take the true centroid / true member-means from the original
  cells; ``max_metacell_size=1`` degenerates to a filtered-Delaunay builder
  (the MS=1 "no-merge" pass used by the paper scripts);
- ``unpack_metacell_matches`` (reference :564-766): distribute or
  nearest-assignment unpacking, with ref-column tiling when aligned members
  outnumber ref members.

Candidate selection per iteration is fully vectorized; only the Delaunay
call (host Qhull / native C++) and the final merge bookkeeping are serial.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd

from .geometry import delaunay_simplices, filter_triangles_collapse


@dataclass
class MetaCell:
    """Container for metacell collapse results + reproducibility metadata.

    Conventions (same as the reference):
    - ``original_delaunay`` triangles are in *original-ID* space;
    - ``metacell_delaunay`` triangles are row indices into ``metacell_df``;
    - ``metacell_df['members']`` holds lists of original IDs.
    """

    original_df: pd.DataFrame
    params: Dict[str, Any]
    x_col: str
    y_col: str
    cell_type_col: str
    original_idx_col: str
    metacell_idx_col: str
    original_delaunay: np.ndarray
    metacell_df: pd.DataFrame
    metacell_delaunay: np.ndarray

    def metacell_members(self, metacell_idx: int) -> List[Any]:
        return list(self.metacell_df.iloc[int(metacell_idx)]["members"])

    def original_delaunay_to_row_indices(
        self, triangles: Optional[np.ndarray] = None, *, on_missing: str = "drop"
    ) -> np.ndarray:
        tri = self.original_delaunay if triangles is None else np.asarray(triangles)
        if tri.size == 0:
            return np.array([], dtype=int).reshape(0, 3)
        if tri.ndim != 2 or tri.shape[1] != 3:
            raise ValueError(f"triangles must have shape (n, 3); got {tri.shape}")
        ids = self.original_df[self.original_idx_col].to_numpy()
        id_to_pos = {v: i for i, v in enumerate(ids)}
        flat = tri.reshape(-1)
        remapped = np.fromiter(
            (id_to_pos.get(v, -1) for v in flat), dtype=int, count=flat.size
        ).reshape(tri.shape)
        if (remapped < 0).any():
            if on_missing == "error":
                missing = set(flat[remapped.reshape(-1) < 0].tolist())
                raise KeyError(
                    f"Triangle vertices not in original_df[{self.original_idx_col}]:"
                    f" {list(missing)[:10]}"
                )
            remapped = remapped[(remapped >= 0).all(axis=1)]
        return remapped

    def original_delaunay_to_pos(self, triangles=None, *, on_missing="drop"):
        return self.original_delaunay_to_row_indices(
            triangles=triangles, on_missing=on_missing
        )

    def original_delaunay_to_xy(self, triangles=None, *, on_missing="drop"):
        tri_pos = self.original_delaunay_to_row_indices(
            triangles=triangles, on_missing=on_missing
        )
        if tri_pos.size == 0:
            return np.array([], dtype=float).reshape(0, 3, 2)
        coords = self.original_df[[self.x_col, self.y_col]].to_numpy(dtype=float)
        return coords[tri_pos]

    def metacell_delaunay_to_xy(self) -> np.ndarray:
        tri = np.asarray(self.metacell_delaunay)
        if tri.size == 0:
            return np.array([], dtype=float).reshape(0, 3, 2)
        coords = self.metacell_df[[self.x_col, self.y_col]].to_numpy(dtype=float)
        return coords[tri.astype(int)]

    def to_summary_dict(self) -> Dict[str, Any]:
        return {
            "n_original": int(len(self.original_df)),
            "n_metacells": int(len(self.metacell_df)),
            "params": dict(self.params),
            "x_col": self.x_col,
            "y_col": self.y_col,
            "cell_type_col": self.cell_type_col,
            "original_idx_col": self.original_idx_col,
            "metacell_idx_col": self.metacell_idx_col,
            "n_original_triangles": int(
                getattr(self.original_delaunay, "shape", [0])[0]
            ),
            "n_metacell_triangles": int(
                getattr(self.metacell_delaunay, "shape", [0])[0]
            ),
        }


_ID_COLUMNS = ["Cell_Num", "Cell_Num_Old", "cell_id", "Cell_ID", "ID", "id"]


def greedy_triangle_collapse(
    aligned_df,
    max_metacell_size: int = 3,
    max_iterations: int = 1000,
    r_max: Optional[float] = None,
    min_angle_deg: Optional[float] = 10,
    use_alpha_shape: bool = False,
    alpha: float = 0.05,
    *,
    original_idx_col: str = "Cell_Num_Old",
    metacell_idx_col: str = "metacell_id",
    x_col: str = "X",
    y_col: str = "Y",
    cell_type_col: str = "cell_type",
    return_object: bool = False,
    verbose: bool = True,
):
    """Iteratively collapse same-type triangles into metacells.

    See module docstring; returns ``(metacell_df, metacell_delaunay)`` or a
    :class:`MetaCell` when ``return_object``.
    """
    required = [x_col, y_col, cell_type_col, original_idx_col]
    missing = [c for c in required if c not in aligned_df.columns]
    if missing:
        raise ValueError(f"Input dataframe missing required columns: {missing}")

    aligned_df = aligned_df.copy()
    if aligned_df[original_idx_col].duplicated().any():
        dups = (
            aligned_df.loc[aligned_df[original_idx_col].duplicated(), original_idx_col]
            .head(5)
            .tolist()
        )
        raise ValueError(
            f"'{original_idx_col}' must be unique per original cell. "
            f"Found duplicates (examples): {dups}"
        )
    aligned_indexed = aligned_df.set_index(original_idx_col, drop=False)

    def _filter(coords, tris):
        tris = filter_triangles_collapse(coords, tris, r_max, min_angle_deg)
        if use_alpha_shape and len(tris):
            tris = _alpha_filter(coords, tris, alpha)
        return tris

    # Filtered original Delaunay in original-ID space.
    orig_coords = aligned_df[[x_col, y_col]].to_numpy(dtype=float)
    if len(orig_coords) >= 4:
        orig_tris_pos = _filter(orig_coords, delaunay_simplices(orig_coords))
    else:
        orig_tris_pos = np.array([], dtype=int).reshape(0, 3)
    ids_by_pos = aligned_df[original_idx_col].to_numpy()
    original_delaunay = (
        ids_by_pos[orig_tris_pos]
        if orig_tris_pos.size
        else np.array([], dtype=ids_by_pos.dtype).reshape(0, 3)
    )

    id_cols = [c for c in aligned_df.columns if c in _ID_COLUMNS]
    if original_idx_col not in id_cols:
        id_cols.append(original_idx_col)
    if metacell_idx_col in aligned_df.columns and metacell_idx_col not in id_cols:
        id_cols.append(metacell_idx_col)
    carry_cols = [
        c
        for c in aligned_df.columns
        if c not in [x_col, y_col, cell_type_col] + id_cols
    ]

    metacell_df = pd.DataFrame(
        {
            x_col: aligned_df[x_col].to_numpy(),
            y_col: aligned_df[y_col].to_numpy(),
            cell_type_col: aligned_df[cell_type_col].to_numpy(),
            "size": 1,
            "members": [[oid] for oid in aligned_df[original_idx_col]],
            **{c: aligned_df[c].to_numpy() for c in carry_cols},
        }
    )
    metacell_df[metacell_idx_col] = range(len(metacell_df))

    if verbose:
        print(
            f"Greedy triangle collapse: {len(aligned_df)} cells, "
            f"max size {max_metacell_size}"
        )

    for iteration in range(max_iterations):
        coords = metacell_df[[x_col, y_col]].to_numpy(dtype=float)
        if len(coords) < 4:
            break
        tris = _filter(coords, delaunay_simplices(coords))
        if len(tris) == 0:
            break

        # Vectorized candidate selection: same-type triangles within the
        # size budget, ranked by perimeter.
        types = metacell_df[cell_type_col].to_numpy()
        sizes = metacell_df["size"].to_numpy()
        tri_types = types[tris]
        same = (tri_types[:, 0] == tri_types[:, 1]) & (
            tri_types[:, 1] == tri_types[:, 2]
        )
        merged_size = sizes[tris].sum(axis=1)
        ok = same & (merged_size <= max_metacell_size)
        if not ok.any():
            break
        cand = tris[ok]
        p = coords[cand]
        perim = (
            np.linalg.norm(p[:, 0] - p[:, 1], axis=1)
            + np.linalg.norm(p[:, 1] - p[:, 2], axis=1)
            + np.linalg.norm(p[:, 2] - p[:, 0], axis=1)
        )
        order = np.argsort(perim, kind="stable")

        used = np.zeros(len(metacell_df), dtype=bool)
        batch = []
        for t in order:
            a, b, c = cand[t]
            if used[a] or used[b] or used[c]:
                continue
            batch.append(cand[t])
            used[[a, b, c]] = True
        if not batch:
            break

        merged_rows = []
        remove = []
        for a, b, c in batch:
            remove.extend([a, b, c])
            members = (
                list(metacell_df.iloc[a]["members"])
                + list(metacell_df.iloc[b]["members"])
                + list(metacell_df.iloc[c]["members"])
            )
            member_rows = aligned_indexed.loc[members]
            row = {
                x_col: member_rows[x_col].mean(),
                y_col: member_rows[y_col].mean(),
                cell_type_col: metacell_df.iloc[a][cell_type_col],
                "size": int(sizes[a] + sizes[b] + sizes[c]),
                "members": members,
            }
            for col in carry_cols:
                if pd.api.types.is_numeric_dtype(metacell_df[col]):
                    if col in aligned_df.columns:
                        row[col] = member_rows[col].mean()
                    else:
                        w = sizes[[a, b, c]]
                        v = metacell_df[col].to_numpy()[[a, b, c]]
                        row[col] = np.average(v, weights=w)
                else:
                    row[col] = metacell_df.iloc[a][col]
            merged_rows.append(row)

        metacell_df = metacell_df.drop(remove).reset_index(drop=True)
        if merged_rows:
            metacell_df = pd.concat(
                [metacell_df, pd.DataFrame(merged_rows)], ignore_index=True
            )
        metacell_df[metacell_idx_col] = range(len(metacell_df))

    final_coords = metacell_df[[x_col, y_col]].to_numpy(dtype=float)
    if len(final_coords) >= 4:
        final_delaunay = _filter(final_coords, delaunay_simplices(final_coords))
    else:
        final_delaunay = np.array([]).reshape(0, 3)

    if verbose:
        print(
            f"Collapse complete: {len(aligned_df)} -> {len(metacell_df)} "
            f"({100 * (1 - len(metacell_df) / len(aligned_df)):.1f}% reduction), "
            f"{len(final_delaunay)} triangles"
        )

    if return_object:
        return MetaCell(
            original_df=aligned_df,
            params={
                "max_metacell_size": max_metacell_size,
                "max_iterations": max_iterations,
                "r_max": r_max,
                "min_angle_deg": min_angle_deg,
                "use_alpha_shape": use_alpha_shape,
                "alpha": alpha,
            },
            x_col=x_col,
            y_col=y_col,
            cell_type_col=cell_type_col,
            original_idx_col=original_idx_col,
            metacell_idx_col=metacell_idx_col,
            original_delaunay=original_delaunay,
            metacell_df=metacell_df,
            metacell_delaunay=final_delaunay,
        )
    return metacell_df, final_delaunay


def _alpha_filter(coords, tris, alpha):
    """Optional alpha-shape containment filter (off in all paper configs)."""
    try:
        from alphashape import alphashape
        from shapely.geometry import Polygon
    except ImportError:
        print("Warning: alphashape not available, skipping alpha shape filtering")
        return tris
    shape = alphashape([tuple(c) for c in coords], alpha)
    keep = [t for t in tris if shape.contains(Polygon(coords[t]))]
    return np.asarray(keep) if keep else np.array([], dtype=int).reshape(0, 3)


def unpack_metacell_matches(
    metacell_matches,
    metacell_aligned_df,
    metacell_ref_df,
    aligned_df=None,
    ref_df=None,
    strategy: str = "distribute",
    aligned_original_idx_col: Optional[str] = None,
    ref_original_idx_col: Optional[str] = None,
    x_col: str = "X",
    y_col: str = "Y",
):
    """Unpack metacell-level matches to individual-cell matches.

    Returns a DataFrame with ``Aligned_cell_id`` / ``Ref_cell_id`` columns
    (reference src/metacell_utils.py:564-766). Strategies:
    - 'distribute': ref individual -> every aligned member maps to it; ref
      metacell -> round-robin over ref members;
    - 'nearest': Hungarian assignment on member distances, tiling ref columns
      ceil(n_aligned / n_ref) times when aligned outnumber ref.
    """
    from scipy.optimize import linear_sum_assignment
    from scipy.spatial.distance import cdist

    # MetaCell duck-typing, same convention as run_same /
    # sliding_window_matching: passing the collapse result object supplies
    # both the metacell table and the original-cell table (+ index column)
    # it was built from, so ``strategy='nearest'`` works out of the box.
    if hasattr(metacell_aligned_df, "metacell_df"):
        mc = metacell_aligned_df
        metacell_aligned_df = mc.metacell_df
        if aligned_df is None:
            aligned_df = mc.original_df
            if aligned_original_idx_col is None:
                aligned_original_idx_col = mc.original_idx_col
        if x_col == "X" and mc.x_col != "X":
            x_col, y_col = mc.x_col, mc.y_col
    if hasattr(metacell_ref_df, "metacell_df"):
        mc = metacell_ref_df
        metacell_ref_df = mc.metacell_df
        if ref_df is None:
            ref_df = mc.original_df
            if ref_original_idx_col is None:
                ref_original_idx_col = mc.original_idx_col
        # Adopt coordinate column names from the ref-side MetaCell too:
        # 'nearest' reads x_col/y_col from BOTH member tables, so a ref
        # MetaCell built with non-default columns must supply them even
        # when the aligned side is a plain DataFrame.
        if x_col == "X" and mc.x_col != "X":
            x_col, y_col = mc.x_col, mc.y_col

    aligned_indexed = ref_indexed = None
    if aligned_df is not None and aligned_original_idx_col is not None:
        if aligned_original_idx_col not in aligned_df.columns:
            raise ValueError(
                f"aligned_df missing aligned_original_idx_col="
                f"'{aligned_original_idx_col}'"
            )
        aligned_indexed = aligned_df.set_index(aligned_original_idx_col, drop=False)
    if ref_df is not None and ref_original_idx_col is not None:
        if ref_original_idx_col not in ref_df.columns:
            raise ValueError(
                f"ref_df missing ref_original_idx_col='{ref_original_idx_col}'"
            )
        ref_indexed = ref_df.set_index(ref_original_idx_col, drop=False)

    ref_has_metacells = (
        "members" in metacell_ref_df.columns
        and metacell_ref_df["members"].apply(lambda x: isinstance(x, list)).any()
    )
    if strategy == "nearest" and aligned_df is None:
        raise ValueError("strategy='nearest' requires aligned_df parameter")
    if ref_has_metacells and strategy == "nearest" and (
        aligned_df is None or ref_df is None
    ):
        raise ValueError(
            "When ref has metacells and strategy='nearest', must provide both "
            "aligned_df and ref_df for nearest neighbor unpacking."
        )

    out = []
    for _, row in metacell_matches.iterrows():
        a_idx = row["Aligned_metacell_id"]
        r_idx = row["Ref_metacell_id"]
        a_members = metacell_aligned_df.iloc[int(a_idx)]["members"]

        if not ref_has_metacells:
            for m in a_members:
                out.append({"Aligned_cell_id": m, "Ref_cell_id": r_idx})
            continue

        r_members = metacell_ref_df.iloc[int(r_idx)]["members"]
        if strategy == "distribute":
            n_r = len(r_members)
            for i, m in enumerate(a_members):
                out.append({"Aligned_cell_id": m, "Ref_cell_id": r_members[i % n_r]})
        elif strategy == "nearest":
            a_src = aligned_indexed if aligned_indexed is not None else aligned_df
            r_src = ref_indexed if ref_indexed is not None else ref_df
            a_xy = a_src.loc[a_members, [x_col, y_col]].to_numpy(dtype=float)
            r_xy = r_src.loc[r_members, [x_col, y_col]].to_numpy(dtype=float)
            d = cdist(a_xy, r_xy)
            if len(a_members) <= len(r_members):
                ri_, ci_ = linear_sum_assignment(d)
                for i, j in zip(ri_, ci_):
                    out.append(
                        {"Aligned_cell_id": a_members[i], "Ref_cell_id": r_members[j]}
                    )
            else:
                n_copies = int(np.ceil(len(a_members) / len(r_members)))
                tiled = np.tile(d, (1, n_copies))
                ri_, ci_ = linear_sum_assignment(tiled)
                for i, j in zip(ri_, ci_):
                    out.append(
                        {
                            "Aligned_cell_id": a_members[i],
                            "Ref_cell_id": r_members[j % len(r_members)],
                        }
                    )
        else:
            raise ValueError(f"Unknown strategy: {strategy}")
    return pd.DataFrame(out)
