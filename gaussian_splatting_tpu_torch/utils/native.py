"""ctypes bindings for the host point ops (counterpart of
``gaussian_splatting_tpu/utils/native.py``): grid-hash kNN mean distance and
radius dedupe from the port's own copy of the C++ source,
``csrc/pointops.cpp``, built with g++ into ``build/host/`` on first use
(``ops/_build.load_host``). The port never loads ``native/libpointops.so``,
which its build script compiles for the CPU of whatever host ran it.

When the library cannot be built or loaded, or returns degenerate output,
the scipy KD-tree gives the same result; every call logs which path ran.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

log = logging.getLogger(__name__)

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    from gaussian_splatting_tpu_torch.ops import _build

    try:
        lib = _build.load_host("pointops")
    except (OSError, RuntimeError) as e:
        log.warning("native pointops unavailable (%s); using the scipy KD-tree", e)
        return None
    lib.knn_mean_distance.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
    ]
    lib.knn_mean_distance.restype = None
    lib.radius_dedupe.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_float, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.radius_dedupe.restype = None
    _LIB = lib
    return _LIB


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def knn_mean_distance(points: np.ndarray, queries: np.ndarray, k: int = 7) -> np.ndarray:
    """Mean distance of each query to its k-1 nearest points (excluding the
    nearest, itself when the query is one of the points), float32."""
    points = np.ascontiguousarray(points, np.float32)
    queries = np.ascontiguousarray(queries, np.float32)
    lib = _load()
    if lib is not None and len(points) > 0:
        out = np.zeros((len(queries),), np.float32)
        lib.knn_mean_distance(_fptr(points), len(points), _fptr(queries), len(queries),
                              ctypes.c_int32(k), _fptr(out))
        if np.isfinite(out).all() and (out > 0).any():
            log.info("kNN mean distance: native pointops, %d queries over %d points, k=%d",
                     len(queries), len(points), k)
            return out
        log.warning("native kNN returned degenerate output; using the scipy KD-tree")
    from scipy.spatial import cKDTree

    log.info("kNN mean distance: scipy KD-tree, %d queries over %d points, k=%d",
             len(queries), len(points), k)
    kk = min(k, len(points))
    d, _ = cKDTree(points).query(queries, k=kk)
    if kk > 1:
        return d[:, 1:].mean(axis=1).astype(np.float32)
    return d[:, 0].astype(np.float32)


def radius_dedupe(points: np.ndarray, radius: float = 0.01) -> np.ndarray:
    """Boolean keep-mask dropping later points within ``radius`` of a kept
    one."""
    points = np.ascontiguousarray(points, np.float32)
    lib = _load()
    if lib is not None and len(points) > 0:
        keep = np.ones((len(points),), np.uint8)
        lib.radius_dedupe(_fptr(points), len(points), ctypes.c_float(radius),
                          keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return keep.astype(bool)
    from scipy.spatial import cKDTree

    pairs = cKDTree(points).query_pairs(radius, output_type="ndarray")
    keep = np.ones(len(points), bool)
    if len(pairs):
        keep[pairs[:, 1]] = False
    return keep
