"""Page-cache advice for memmapped graph arrays — cache_utilities.hpp.

The reference wraps ``madvise`` so construction and search phases can tell
the OS how the mmap'd graph will be read (advise_vector_rand
cache_utilities.hpp:76). ``graph/storage.py`` advises its shard memmaps as
read sequentially. numpy memmaps don't expose their mmap object, so the
advice goes through libc on the array's address range, page-aligned.

Failures are silently ignored (advice is advisory; platforms without
madvise just skip it) — same stance as the reference's helpers.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import mmap

import numpy as np

_ADVICE = {
    "normal": 0,   # MADV_NORMAL
    "random": 1,   # MADV_RANDOM
    "sequential": 2,  # MADV_SEQUENTIAL
    "willneed": 3,  # MADV_WILLNEED
    "dontneed": 4,  # MADV_DONTNEED
}

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                                use_errno=True)
        except OSError:
            _libc = False
    return _libc


def advise(arr: np.ndarray, advice: str) -> bool:
    """madvise the pages backing ``arr`` (a np.memmap or any array whose
    buffer is page-backed). Returns True when the call was issued."""
    libc = _get_libc()
    if not libc or not isinstance(arr, np.memmap):
        return False
    adv = _ADVICE[advice]
    addr = arr.ctypes.data
    length = arr.nbytes
    page = mmap.PAGESIZE
    aligned = addr - (addr % page)
    length += addr - aligned
    try:
        return libc.madvise(
            ctypes.c_void_p(aligned), ctypes.c_size_t(length), ctypes.c_int(adv)
        ) == 0
    except Exception:
        return False
