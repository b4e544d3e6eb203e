"""Lazy-state helpers for the driver's compact continuation.

BucketedLccEngine (engine/lcc_bucketed.py) holds between-iteration states
as pure host data: ``tv_np`` + sorted original CSR edge ids (the alive
set) + TP-mark edge ids. These helpers normalize the ids and merge TP
marks exactly as the JAX package's ``engine/lazy_state.py`` does, so the
two engines stay in step.
"""

from __future__ import annotations

import numpy as np


def normalized_edge_ids(edge_ids) -> np.ndarray:
    """Sorted int64 edge ids — ascending ids == CSR row-major pair order."""
    return np.sort(np.asarray(edge_ids, dtype=np.int64))


def normalized_flag_ids(flag_ids):
    return None if flag_ids is None else np.asarray(flag_ids, dtype=np.int64)


def merged_flag_ids(prev, tp_marks) -> np.ndarray:
    """Union of a lazy state's TP-mark ids with freshly marked edge ids."""
    base = prev if prev is not None else np.empty(0, dtype=np.int64)
    if not tp_marks:
        return base
    return np.union1d(base, np.asarray(list(tp_marks), dtype=np.int64))
