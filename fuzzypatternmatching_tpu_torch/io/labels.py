"""Vertex/edge metadata loading — the vertex_data_db equivalent.

The reference loads per-vertex labels from all files matching ``<base>*``
(each line ``vertex data``; include/havoqgt/vertex_data_db.hpp:137-165,
169-196) delivered by a visitor traversal; with no ``-v`` flag it derives
labels from degrees (vertex_data_db_degree.hpp:109). Here labels land in a
dense array directly.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..graph.csr import Graph, degree_labels


def load_vertex_labels(base: str, num_vertices: int) -> np.ndarray:
    """Read labels from every file matching ``<base>*``."""
    labels = np.zeros(num_vertices, dtype=np.uint64)
    files = sorted(glob.glob(base + "*"))
    if not files:
        raise FileNotFoundError(f"no vertex data files match {base}*")
    for path in files:
        if not os.path.isfile(path):
            continue
        data = np.loadtxt(path, dtype=np.uint64, ndmin=2)
        if data.size == 0:
            continue
        labels[data[:, 0].astype(np.int64)] = data[:, 1]
    return labels


def resolve_labels(
    graph: Graph, vertex_data_base: str | None, stored: np.ndarray | None
) -> np.ndarray:
    """Priority: explicit ``-v`` files > labels stored in the graph DB >
    degree labels (the reference's default, beta.cpp:358-370)."""
    if vertex_data_base:
        return load_vertex_labels(vertex_data_base, graph.num_vertices)
    if stored is not None:
        return np.asarray(stored, dtype=np.uint64)
    return degree_labels(graph)
