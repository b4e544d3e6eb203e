"""CSR graph structure (the port's own copy of
``fuzzypatternmatching_tpu/graph/csr.py``; the same arrays, bit for bit).

* Adjacency is stored deduplicated (unique (u,v) pairs). The reference keeps
  duplicate edges in its CSR but collapses them in the algorithm's
  per-vertex ``vertex_active_edges_map`` (keyed by neighbor id), so the
  deduplicated adjacency carries exactly the algorithm-visible edge set.
  ``raw_degree`` preserves the duplicate-inclusive degree used for
  degree-based labels (vertex_data_db_degree.hpp:109).
* ``rev_edge`` maps each directed edge (u,v) to the index of (v,u) — the
  receiver-centric superstep kernels read the sender-side edge-active flag
  of the reverse edge instead of exchanging mailbox messages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    num_vertices: int
    row_ptr: np.ndarray  # int64 [V+1]
    cols: np.ndarray  # int32/int64 [E] neighbor vertex ids (deduplicated)
    rev_edge: np.ndarray  # int64 [E] index of the reverse edge, -1 if absent
    raw_degree: np.ndarray  # int64 [V] duplicate-inclusive degree
    edge_row: np.ndarray  # int32/int64 [E] source vertex of each edge

    @property
    def num_edges(self) -> int:
        return int(self.cols.shape[0])


def from_edges(
    src: np.ndarray, dst: np.ndarray, num_vertices: int | None = None,
    use_native: bool = True,
) -> Graph:
    """Build a Graph from a directed edge stream (duplicates allowed).

    For undirected graphs the stream must already contain both directions
    (the generators and the ingest path emit them — matching the reference's
    symmetrized streams, rmat_edge_generator.hpp:127-138). Uses the native
    C++ builder when available; the NumPy path is bit-identical.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if num_vertices is None:
        num_vertices = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    v = num_vertices

    if use_native and src.size > 0:
        from .. import native

        if native.available():
            row_ptr, cols, rev, raw_degree = native.build_csr_native(
                src, dst, v
            )
            edge_row = np.repeat(
                np.arange(v, dtype=np.int64), np.diff(row_ptr)
            )
            return Graph(
                num_vertices=v,
                row_ptr=row_ptr,
                cols=cols,
                rev_edge=rev,
                raw_degree=raw_degree,
                edge_row=edge_row,
            )

    raw_degree = np.bincount(src, minlength=v).astype(np.int64)

    # deduplicate (u,v) pairs via packed 64-bit keys
    key = src.astype(np.uint64) * np.uint64(v) + dst.astype(np.uint64)
    ukey = np.unique(key)
    usrc = (ukey // np.uint64(v)).astype(np.int64)
    udst = (ukey % np.uint64(v)).astype(np.int64)

    row_ptr = np.zeros(v + 1, dtype=np.int64)
    np.add.at(row_ptr, usrc + 1, 1)
    row_ptr = np.cumsum(row_ptr)

    # reverse-edge index: position of (dst,src) in the sorted unique keys
    rkey = udst.astype(np.uint64) * np.uint64(v) + usrc.astype(np.uint64)
    pos = np.searchsorted(ukey, rkey)
    pos_clipped = np.minimum(pos, len(ukey) - 1)
    rev = np.where(ukey[pos_clipped] == rkey, pos_clipped, -1).astype(np.int64)

    return Graph(
        num_vertices=v,
        row_ptr=row_ptr,
        cols=udst,
        rev_edge=rev,
        raw_degree=raw_degree,
        edge_row=usrc,
    )


def degree_labels(graph: Graph) -> np.ndarray:
    """Default vertex metadata: ``ceil(log2(degree+1))``
    (reference: vertex_data_db_degree.hpp:109, the log2 branch)."""
    d = graph.raw_degree.astype(np.float64)
    return np.ceil(np.log2(d + 1.0)).astype(np.uint64)

