"""Legacy walk-clone "fuzzy pattern matching" prototype (the port's own copy
of ``fuzzypatternmatching_tpu/algorithms/fuzzy_walk.py``: host numpy, the
same ranks).

Re-expresses the reference's random-walker kernel
(include/havoqgt/fuzzy_pattern_matching.hpp:50-240, driver
src/run_fuzzy_pattern_matching.cpp) as vectorized frontier supersteps:
walkers start at every vertex whose label matches ``walk_labels[0]``, clone
along all edges subject to the pre-clone history rules of ``walk_indices``
(entry ``k == p``: position p must be a new vertex; ``k < p``: position p
must equal the vertex at position k — fuzzy_pattern_matching.hpp:178-200),
check the label on arrival, and every vertex on a fully matched walk gets
its rank incremented once per occurrence per matched walk
(fuzzy_pattern_matching.hpp:146-153).
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import Graph

MAX_WALK = 15  # max_walk_history_size (fuzzy_pattern_matching.hpp:11)


def fuzzy_walk_ranks(
    graph: Graph,
    labels: np.ndarray,
    walk_labels: np.ndarray,
    walk_indices: np.ndarray,
    batch_size: int = 1 << 16,
) -> np.ndarray:
    """Per-vertex match ranks of the label walk over the full adjacency."""
    L = len(walk_labels)
    if L > MAX_WALK:
        raise ValueError(f"walk length {L} exceeds the history cap {MAX_WALK}")
    labels = np.asarray(labels, dtype=np.uint64)
    v = graph.num_vertices
    rank = np.zeros(v, dtype=np.int64)
    starts = np.nonzero(labels == np.uint64(walk_labels[0]))[0].astype(
        np.int64
    )
    ptr, cols = graph.row_ptr, graph.cols

    for lo in range(0, max(len(starts), 1), batch_size):
        batch = starts[lo : lo + batch_size]
        if len(batch) == 0 or L == 1:
            rank += np.bincount(batch, minlength=v)
            continue
        history = batch[:, None]
        cur = batch
        for p in range(1, L):
            cnt = ptr[cur + 1] - ptr[cur]
            rep = np.repeat(np.arange(len(cur), dtype=np.int64), cnt)
            offs = np.arange(int(cnt.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(cnt) - cnt, cnt
            )
            nbr = cols[ptr[cur][rep] + offs].astype(np.int64)
            hist_r = history[rep]
            # pre-clone history rules (sender side)
            k = int(walk_indices[p])
            if k == p:
                keep = ~np.any(hist_r == nbr[:, None], axis=1)
            elif k < p:
                keep = hist_r[:, k] == nbr
            else:
                keep = np.zeros(len(nbr), dtype=bool)
            nbr, hist_r = nbr[keep], hist_r[keep]
            # arrival label check (receiver side)
            ok = labels[nbr] == np.uint64(walk_labels[p])
            cur = nbr[ok]
            history = np.hstack([hist_r[ok], cur[:, None]])
            if len(cur) == 0:
                break
        else:
            # full matches: every history vertex, once per occurrence
            for col in history.T:
                rank += np.bincount(col, minlength=v)
    return rank
