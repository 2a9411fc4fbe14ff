"""Native (C++) asset-prep runtime: convex hull, mesh decimation, STL writer.

Port of smplsim_tpu/native: `asset_prep.cpp` is a byte-identical copy of
that package's source, compiled with g++ at first use into
``build/native/`` beside the package (a directory git ignores), named by
the hash of its source, and bound through ctypes with the same surface:
`convex_hull`, `hull_volume`, `decimate`, `write_stl`, `available`. `convex_hull` falls
back to scipy when no compiler is present; the two round differently, and a
capsule's radius follows its hull's volume, so builds that are compared
across packages assert `available()` on both sides.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "asset_prep.cpp")
_LIB = None
_LIB_ERR: str | None = None


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_cache_dir(), f"asset_prep_{digest}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                   check=True, capture_output=True)
    os.replace(tmp, so)  # atomic under concurrent builders
    return so


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.CalledProcessError) as e:  # no compiler
        _LIB_ERR = str(e)
        return None
    dp, ip, i = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int), ctypes.c_int
    lib.sm_convex_hull.argtypes = [dp, i, ip, i, ip, dp]
    lib.sm_decimate.argtypes = [dp, i, ip, i, i, dp, ip, ip, ip]
    lib.sm_write_stl.argtypes = [ctypes.c_char_p, dp, ip, i]
    for fn in (lib.sm_convex_hull, lib.sm_decimate, lib.sm_write_stl):
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def convex_hull(points: np.ndarray):
    """(n,3) points -> (faces (F,3) int32, volume). Native quickhull; scipy
    when no compiler is present."""
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    lib = _load()
    if lib is None:
        from scipy.spatial import ConvexHull

        h = ConvexHull(pts)
        return h.simplices.astype(np.int32), float(h.volume)
    cap = 8 * n + 64
    faces = np.empty((cap, 3), dtype=np.int32)
    nf = ctypes.c_int(0)
    vol = ctypes.c_double(0.0)
    rc = lib.sm_convex_hull(_dptr(pts), n, _iptr(faces), cap, ctypes.byref(nf), ctypes.byref(vol))
    if rc != 0:
        raise ValueError(f"convex_hull failed (degenerate input?), rc={rc}")
    return faces[: nf.value].copy(), float(vol.value)


def hull_volume(points: np.ndarray) -> float:
    return convex_hull(points)[1]


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int):
    """Quadric edge-collapse to ~target_faces. Returns (verts', faces')."""
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_LIB_ERR}")
    ov = np.empty_like(v)
    of = np.empty_like(f)
    onv, onf = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.sm_decimate(_dptr(v), v.shape[0], _iptr(f), f.shape[0], int(target_faces),
                         _dptr(ov), ctypes.byref(onv), _iptr(of), ctypes.byref(onf))
    if rc != 0:
        raise ValueError(f"decimate failed rc={rc}")
    return ov[: onv.value].copy(), of[: onf.value].copy()


def write_stl(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native lib unavailable: {_LIB_ERR}")
    rc = lib.sm_write_stl(path.encode(), _dptr(v), _iptr(f), f.shape[0])
    if rc != 0:
        raise IOError(f"write_stl({path}) failed rc={rc}")
    return path
