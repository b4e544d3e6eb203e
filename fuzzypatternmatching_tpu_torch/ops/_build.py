"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``; ``build_all`` runs one
nvcc per source, all at once. The library lands in
``fuzzypatternmatching_tpu_torch/_build/`` (ignored by git), named by a hash
of the source and the flags, so a changed source is rebuilt and an unchanged
one is built once. Nothing is built at import time: the first CUDA call that
needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel: build_logs
]

_P = ctypes.c_void_p
_SIGNATURES = {
    "lcc_superstep": {
        "fpm_pack_alive": [
            _P, ctypes.c_int64, _P, ctypes.c_int64, _P, ctypes.c_int64,
            ctypes.c_int32, _P,
        ],
        "fpm_rev_alive_lookup": [
            _P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P, ctypes.c_int64, _P,
        ],
        "fpm_gather_accept_or": [
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P,
        ],
        "fpm_pack_sends": [
            _P, ctypes.c_int64, _P, ctypes.c_int64, _P, ctypes.c_int64,
            ctypes.c_int32, _P,
        ],
        "fpm_gather_payload": [
            _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P, _P, _P, _P,
            ctypes.c_int32, _P,
        ],
        "fpm_map_alive": [
            _P, _P, _P, _P, ctypes.c_int64, _P, ctypes.c_int64, _P, _P, _P, _P,
        ],
    },
    "lcc_fused": {
        # code, code_bytes, code_tv, code_count, then the common tail
        "fpm_init_superstep": [
            _P, ctypes.c_int32, _P, ctypes.c_int64,
            _P, ctypes.c_int32, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int64, _P,
            ctypes.c_int32, _P, _P, _P, _P,
        ],
        # adj, alive_rev, alive, tp_flag, then the common tail: table,
        # buckets, segments, seg_rows, seg_start, own_seg, tv, V, template,
        # ranks, new_tv, new_alive, stats, stream
        "fpm_continuation_superstep": [
            _P, _P, _P, _P,
            _P, ctypes.c_int32, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int64, _P,
            ctypes.c_int32, _P, _P, _P, _P,
        ],
        # the counting rule's: cls after the mode's own inputs, then the
        # common tail (its template words with the requirement table)
        "fpm_init_superstep_counting": [
            _P, ctypes.c_int32, _P, ctypes.c_int64, _P,
            _P, ctypes.c_int32, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int64, _P,
            ctypes.c_int32, _P, _P, _P, _P,
        ],
        "fpm_continuation_superstep_counting": [
            _P, _P, _P, _P, _P,
            _P, ctypes.c_int32, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int64, _P,
            ctypes.c_int32, _P, _P, _P, _P,
        ],
    },
    "nlcc_frontier": {
        "fpm_expand_count": [
            _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _P,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _P, _P, _P,
        ],
        "fpm_expand_write": [
            _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _P,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _P, _P, _P, _P, _P,
        ],
        "fpm_bit_plane": [_P, ctypes.c_int64, ctypes.c_int32, _P, ctypes.c_int64, _P],
        "fpm_plane_summary": [_P, ctypes.c_int64, ctypes.c_int32, _P, ctypes.c_int64, _P],
        "fpm_plane_count": [
            _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _P, _P, ctypes.c_int32, ctypes.c_int64,
            _P, _P, _P, _P, _P,
        ],
        "fpm_plane_write": [
            _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _P, _P, _P, _P, _P, _P, _P,
        ],
        "fpm_forward_winners": [
            _P, ctypes.c_int64, _P, _P, ctypes.c_int64, _P, _P, ctypes.c_int64,
            _P, _P,
        ],
        "fpm_forward_winners_part": [
            _P, ctypes.c_int64, _P, _P, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, _P, _P, _P, _P, _P, _P, _P,
        ],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _so_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _build_missing(names) -> None:
    """Build the libraries of ``names`` not built yet, one nvcc per source,
    all started together."""
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = f"{_so_path(name)}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _so_path(name))
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all() -> None:
    """Build (in parallel) and load every kernel library."""
    _build_missing(_SIGNATURES)
    for name in _SIGNATURES:
        library(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _build_missing([name])
    lib = ctypes.CDLL(_so_path(name))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
