"""ctypes loader for the first-party C++ runtime components (native/).

The native library is optional: every entry point returns ``None`` when the
shared object has not been built, and callers fall back to scipy/Qhull.
Build with ``make -C native`` (see native/Makefile).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [
        os.environ.get("SAME_TPU_NATIVE_LIB", ""),
        os.path.join(here, "native", "libsame_native.so"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.same_delaunay.restype = ctypes.c_longlong
                lib.same_delaunay.argtypes = [
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.c_longlong,
                ]
                lib.same_hopcroft_karp.restype = ctypes.c_longlong
                lib.same_hopcroft_karp.argtypes = [
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.c_longlong,
                    ctypes.c_longlong,
                    ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_longlong),
                ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def native_delaunay(points: np.ndarray):
    """Bowyer-Watson Delaunay via native/delaunay.cpp; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = len(pts)
    max_tris = max(4 * n, 16)
    out = np.empty(max_tris * 3, dtype=np.int64)
    count = lib.same_delaunay(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        max_tris,
    )
    if count < 0:
        return None
    return out[: count * 3].reshape(-1, 3).copy()


def native_hopcroft_karp(ai: np.ndarray, bi: np.ndarray, n_a: int, n_b: int):
    """Max-cardinality bipartite matching; per-left match or -1. None if no lib."""
    lib = _load()
    if lib is None:
        return None
    ai = np.ascontiguousarray(ai, dtype=np.int64)
    bi = np.ascontiguousarray(bi, dtype=np.int64)
    out = np.full(n_a, -1, dtype=np.int64)
    rc = lib.same_hopcroft_karp(
        ai.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        bi.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        len(ai),
        n_a,
        n_b,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if rc < 0:
        return None
    return out
