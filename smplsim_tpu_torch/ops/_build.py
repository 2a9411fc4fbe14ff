"""Builds the port's CUDA kernels with nvcc at first use and loads them.

Each source under ``csrc/`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/kernels/`` beside the package
(a directory git ignores). All sources are compiled in parallel the first
time any kernel is asked for; a library is named by the hash of its source
and of the shared headers (``csrc/*.cuh``), so an edited source is rebuilt
and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
SOURCES = ("chol_solve.cu", "cho_factor_solve.cu", "newton_qp.cu", "solve_lower.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "chol_solve_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "chol_solve_f64": (_P, _P, _P, _P, _I, _I, _I, _P),
    "chol_solve_tiled_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "chol_solve_tiled_f64": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "chol_solve_tiled_attrs": (_I, _P),
    "chol_solve_tiled_occupancy": (_I, _I, _I, _I, _P),
    "cho_factor_solve_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cho_factor_solve_f64": (_P, _P, _P, _P, _I, _I, _I, _P),
    "cholesky_f32": (_P, _P, _I, _I, _P),
    "cholesky_f64": (_P, _P, _I, _I, _P),
    "cholesky_warp_f32": (_P, _P, _I, _I, _P),
    "cholesky_warp_f64": (_P, _P, _I, _I, _P),
    "cholesky_tiled_f32": (_P, _P, _I, _I, _P),
    "cholesky_tiled_f64": (_P, _P, _I, _I, _P),
    "cholesky_attrs": (_I, _P),
    "solve_lower_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "solve_lower_f64": (_P, _P, _P, _I, _I, _I, _I, _P),
    "solve_lower_attrs": (_I, _P),
    "cho_factor_solve_attrs": (_I, _P),
    "newton_qp_f32": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P),
    "newton_qp_f64": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P),
    "newton_qp_warp_f32": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P),
    "newton_qp_warp_f64": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_double, _P),
    "newton_qp_warp_attrs": (_I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [src] + sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh")):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{src[:-3]}_{digest[:16]}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library (one nvcc per source, all at once) and
    load them. Raises with the compiler's output if a build fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for src in SOURCES:
            out = _lib_path(src)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, out, tmp, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in SOURCES:
            lib = ctypes.CDLL(_lib_path(src))
            for name, argtypes in _SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[src] = lib
        return _libs


def kernel(src: str, name: str):
    """The C entry point `name` of the library built from `src`."""
    return getattr(build_all()[src], name)


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
