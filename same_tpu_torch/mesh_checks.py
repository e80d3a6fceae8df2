"""Mesh analysis utilities (reference src/triangle_utils.py parity).

Host-side analysis helpers over triangulations: alpha-shape-filtered
Delaunay, minimum-angle search, orientation and bounds checks. Vectorized
over the triangle axis.

Copy of ``same_tpu/mesh_checks.py`` (no device code).
"""

from __future__ import annotations

import numpy as np

from .geometry import (
    delaunay_simplices,
    orientation_signs_np,
    triangle_min_angles_deg,
)


def compute_filtered_delaunay(points, min_angle_deg: float = 15, alpha=None):
    """Delaunay triangulation filtered by min angle and optional alpha shape.

    Parity with reference src/triangle_utils.py:14-50 /
    src/synthetic_datagen.py:84-97.
    """
    points = np.asarray(points, dtype=float)
    if len(points) < 3:
        return np.empty((0, 3), dtype=np.int64)
    tris = delaunay_simplices(points)
    if len(tris) == 0:
        return tris
    keep = triangle_min_angles_deg(points, tris) >= min_angle_deg
    tris = tris[keep]
    if alpha is not None and len(tris):
        try:
            from alphashape import alphashape
            from shapely.geometry import Polygon

            shape = alphashape([tuple(p) for p in points], alpha)
            keep2 = [shape.contains(Polygon(points[t])) for t in tris]
            tris = tris[np.asarray(keep2, dtype=bool)]
        except ImportError:
            print("Warning: alphashape not available, skipping alpha filtering")
    return tris


def find_min_angle_triangles(points, tris, min_angle_deg: float = 15):
    """Indices and angles of triangles thinner than ``min_angle_deg``."""
    points = np.asarray(points, dtype=float)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    if len(tris) == 0:
        return np.empty(0, dtype=np.int64), np.empty(0)
    angles = triangle_min_angles_deg(points, tris)
    bad = np.flatnonzero(angles < min_angle_deg)
    return bad, angles[bad]


def check_mesh_orientation(points, tris):
    """Orientation census of a mesh: counts of CCW / CW / degenerate."""
    points = np.asarray(points, dtype=float)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    signs = orientation_signs_np(points, tris) if len(tris) else np.empty(0, int)
    return {
        "n_triangles": int(len(tris)),
        "ccw": int((signs > 0).sum()),
        "cw": int((signs < 0).sum()),
        "degenerate": int((signs == 0).sum()),
        "consistent": bool(len(tris) == 0 or (signs > 0).all() or (signs < 0).all()),
    }


def check_mesh_bounds(points, tris):
    """Index-validity and bounding-box report for a triangulation."""
    points = np.asarray(points, dtype=float)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    valid_idx = bool(len(tris) == 0 or ((tris >= 0) & (tris < len(points))).all())
    report = {
        "n_points": int(len(points)),
        "n_triangles": int(len(tris)),
        "indices_valid": valid_idx,
    }
    if len(points):
        report["bounds"] = {
            "min_x": float(points[:, 0].min()),
            "max_x": float(points[:, 0].max()),
            "min_y": float(points[:, 1].min()),
            "max_y": float(points[:, 1].max()),
        }
    return report
