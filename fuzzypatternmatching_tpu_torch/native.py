"""ctypes binding for the repository's native data-plane library
(``native/fpm_native.cpp``, built into ``native/libfpm_native.so``).

The port's own copy of ``fuzzypatternmatching_tpu/native.py``, reduced to
the two entry points the port calls: the multi-rank R-MAT generator and the
CSR builder. The library is found next to the package (``<repo>/native``),
and built with ``make`` on first use when only the source is there. Every
caller has a NumPy path that gives the same arrays, so the port works
without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libfpm_native.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO_PATH):
        src = os.path.join(_NATIVE_DIR, "fpm_native.cpp")
        if os.path.exists(src):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "libfpm_native.so"],
                    check=True,
                    capture_output=True,
                )
            except (subprocess.CalledProcessError, FileNotFoundError):
                return None
    if not os.path.exists(_SO_PATH):
        return None
    lib = ctypes.CDLL(_SO_PATH)
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.fpm_rmat_generate_ranks.argtypes = [
        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, u64p, u64p,
    ]
    lib.fpm_rmat_generate_ranks.restype = None
    lib.fpm_build_csr.argtypes = [
        u64p, u64p, ctypes.c_uint64, ctypes.c_uint64, i64p, i64p, i64p, i64p,
    ]
    lib.fpm_build_csr.restype = ctypes.c_uint64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def rmat_all_ranks_native(
    scale: int,
    n_ranks: int,
    edges_per_vertex: int = 16,
    scramble: bool = True,
    undirected: bool = True,
    base_seed: int = 5489,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    d: float = 0.05,
):
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    per_rank = (edges_per_vertex << scale) // n_ranks
    stride = 2 * per_rank if undirected else per_rank
    src = np.empty(n_ranks * stride, dtype=np.uint64)
    dst = np.empty(n_ranks * stride, dtype=np.uint64)
    lib.fpm_rmat_generate_ranks(
        base_seed, scale, per_rank, n_ranks, a, b, c, d,
        int(scramble), int(undirected), src, dst,
    )
    return src, dst


def build_csr_native(src: np.ndarray, dst: np.ndarray, num_vertices: int):
    """Returns (row_ptr, cols, rev, raw_degree) matching csr.from_edges."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    src = np.ascontiguousarray(src, dtype=np.uint64)
    dst = np.ascontiguousarray(dst, dtype=np.uint64)
    n = src.shape[0]
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    rev = np.empty(n, dtype=np.int64)
    deg = np.zeros(num_vertices, dtype=np.int64)
    m = lib.fpm_build_csr(src, dst, n, num_vertices, row_ptr, cols, rev, deg)
    return row_ptr, cols[:m].copy(), rev[:m].copy(), deg
