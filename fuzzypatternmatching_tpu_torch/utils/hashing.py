"""Vectorized vertex-id scramble hashes.

Bit-exact NumPy ports of the hash family used to scramble RMAT vertex ids
(reference: include/havoqgt/detail/hash.hpp:65-140). All functions operate on
uint64 arrays and are fully vectorized. The port's own copy of
``fuzzypatternmatching_tpu/utils/hashing.py``.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint64(0xFFFFFFFF)
_U16 = np.uint64(0xFFFF)
_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash32(a: np.ndarray) -> np.ndarray:
    """Robert Jenkins' 32-bit integer hash (hash.hpp:65-74)."""
    a = a.astype(np.uint32)
    with np.errstate(over="ignore"):
        a = (a + np.uint32(0x7ED55D16)) + (a << np.uint32(12))
        a = (a ^ np.uint32(0xC761C23C)) ^ (a >> np.uint32(19))
        a = (a + np.uint32(0x165667B1)) + (a << np.uint32(5))
        a = (a + np.uint32(0xD3A2646C)) ^ (a << np.uint32(9))
        a = (a + np.uint32(0xFD7046C5)) + (a << np.uint32(3))
        a = (a ^ np.uint32(0xB55A4F09)) ^ (a >> np.uint32(16))
    return a


def hash16(a: np.ndarray) -> np.ndarray:
    """16-bit variant (hash.hpp:76-85)."""
    a = a.astype(np.uint16)
    with np.errstate(over="ignore"):
        a = (a + np.uint16(0x5D16)) + (a << np.uint16(6))
        a = (a ^ np.uint16(0xC23C)) ^ (a >> np.uint16(9))
        a = (a + np.uint16(0x67B1)) + (a << np.uint16(5))
        a = (a + np.uint16(0x646C)) ^ (a << np.uint16(7))
        a = (a + np.uint16(0x46C5)) + (a << np.uint16(3))
        a = (a ^ np.uint16(0x4F09)) ^ (a >> np.uint16(8))
    return a


def _shifted_n_hash32(inp: np.ndarray, n: int) -> np.ndarray:
    """hash.hpp:87-100 — hash the 32-bit window starting at bit n in place."""
    n64 = np.uint64(n)
    to_hash = (inp >> n64) & _U32
    to_hash = hash32(to_hash).astype(np.uint64)
    mask = (_U32 << n64) & _U64
    return (inp & ~mask) | ((to_hash << n64) & _U64)


def _shifted_n_hash16(inp: np.ndarray, n: int) -> np.ndarray:
    """hash.hpp:102-115 — 16-bit window variant."""
    n64 = np.uint64(n)
    to_hash = (inp >> n64) & _U16
    to_hash = hash16(to_hash).astype(np.uint64)
    mask = (_U16 << n64) & _U64
    return (inp & ~mask) | ((to_hash << n64) & _U64)


def hash_nbits(inp: np.ndarray, n: int) -> np.ndarray:
    """Permute the low-n bits of each value (hash.hpp:117-140).

    Used by the RMAT generator with n == vertex_scale
    (rmat_edge_generator.hpp:255-258). Requires 16 < n (matches the
    reference's assertion) and vectorizes over uint64 arrays.
    """
    inp = np.asarray(inp, dtype=np.uint64)
    if n == 32:
        return hash32(inp).astype(np.uint64)
    if n > 32:
        m = n - 32
        for i in range(0, m + 1):
            inp = _shifted_n_hash32(inp, i)
        for i in range(m, -1, -1):
            inp = _shifted_n_hash32(inp, i)
        return inp
    if n <= 16:
        raise ValueError("hashing fewer than 17 bits is not supported")
    m = n - 16
    for i in range(0, m + 1):
        inp = _shifted_n_hash16(inp, i)
    for i in range(m, -1, -1):
        inp = _shifted_n_hash16(inp, i)
    return inp
