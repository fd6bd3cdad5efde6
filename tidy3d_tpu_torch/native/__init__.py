"""Native (C++) host-side kernels, compiled on first use and loaded via
ctypes. Falls back silently to the numpy implementations when no compiler
is available."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "geometry_core.cpp")
# beside the package, as the CUDA kernels are built (git-ignored)
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "native")


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha1(f.read()).hexdigest()[:12]
        os.makedirs(_CACHE_DIR, exist_ok=True)
        lib_path = os.path.join(_CACHE_DIR, f"geometry_core_{tag}.so")
        if not os.path.exists(lib_path):
            cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                   "-fPIC", _SRC, "-o", lib_path + ".tmp"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(lib_path + ".tmp", lib_path)
        lib = ctypes.CDLL(lib_path)
        for name in ("points_in_polygon", "polygon_sdf"):
            fn = getattr(lib, name)
            fn.restype = None
        _LIB = lib
    except Exception:  # noqa: BLE001 - any failure -> numpy fallback
        _LIB = None
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


def points_in_polygon(xs: np.ndarray, ys: np.ndarray, vertices: np.ndarray):
    """Native even-odd test; returns a bool array of xs.shape, or None if
    the native library is unavailable."""
    lib = _build_and_load()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    ys = np.ascontiguousarray(ys, dtype=np.float64)
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    out = np.empty(xs.shape, dtype=np.uint8)
    lib.points_in_polygon(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(xs.size),
        np.ascontiguousarray(v[:, 0]).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)),
        np.ascontiguousarray(v[:, 1]).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def polygon_sdf(xs: np.ndarray, ys: np.ndarray, vertices: np.ndarray):
    """Native signed distance; returns xs.shape float array or None."""
    lib = _build_and_load()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    ys = np.ascontiguousarray(ys, dtype=np.float64)
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    out = np.empty(xs.shape, dtype=np.float64)
    lib.polygon_sdf(
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(xs.size),
        np.ascontiguousarray(v[:, 0]).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)),
        np.ascontiguousarray(v[:, 1]).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(v)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
