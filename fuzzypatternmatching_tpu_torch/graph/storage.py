"""Reading a stored graph DB into one global CSR.

The port's own copy of the read path of ``fuzzypatternmatching_tpu/graph/
storage.py``: ``load`` and what it calls. A DB is a directory with a JSON
header (``meta.json``: uuid, format version, shard count, sizes,
``clean_close``) and one shard per contiguous vertex block: a directory of
raw ``.npy`` arrays (format v2) or one ``.npz`` file (format v1). Writing a
DB stays with the JAX package's ``storage.save``; the two formats are the
same files.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.page_cache import advise
from .csr import Graph

_FORMAT_VERSION = 2


def _read_meta(base: str) -> dict:
    with open(os.path.join(base, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") not in (1, _FORMAT_VERSION):
        raise ValueError(f"graph DB version mismatch: {meta.get('version')}")
    if not meta.get("clean_close", False):
        raise ValueError("graph DB corrupt: not closed cleanly")
    return meta


def _load_v1(base: str, meta: dict):
    n = meta["num_shards"]
    v = meta["num_vertices"]
    row_parts, col_parts, rev_parts, deg_parts = [], [], [], []
    lab_parts, ed_parts = [], []
    for r in range(n):
        path = os.path.join(base, f"shard_{r}_of_{n}.npz")
        if not os.path.exists(path):
            raise ValueError(f"graph DB corrupt: missing shard {r} of {n}")
        z = np.load(path)
        e_lo = int(z["edge_start"])
        row_parts.append(z["row_ptr"][:-1] + e_lo)
        col_parts.append(z["cols"])
        rev_parts.append(z["rev_edge"])
        deg_parts.append(z["raw_degree"])
        if meta["has_labels"]:
            lab_parts.append(z["labels"])
        if meta["has_edge_data"]:
            ed_parts.append(z["edge_data"])
    cols = np.concatenate(col_parts)
    row_ptr = np.concatenate(
        row_parts + [np.array([cols.shape[0]], dtype=np.int64)]
    )
    graph = Graph(
        num_vertices=v,
        row_ptr=row_ptr,
        cols=cols,
        rev_edge=np.concatenate(rev_parts),
        raw_degree=np.concatenate(deg_parts),
        edge_row=np.repeat(np.arange(v, dtype=np.int64), np.diff(row_ptr)),
    )
    labels = np.concatenate(lab_parts) if meta["has_labels"] else None
    edge_data = np.concatenate(ed_parts) if meta["has_edge_data"] else None
    return graph, labels, edge_data


def _load_v2(base: str, meta: dict):
    n = meta["num_shards"]
    v = meta["num_vertices"]
    e = meta["num_edges"]
    edge_starts = meta["edge_starts"]
    row_parts, col_parts, rev_parts, deg_parts = [], [], [], []
    lab_parts, ed_parts = [], []
    for r in range(n):
        d = os.path.join(base, f"shard_{r}_of_{n}")
        if not os.path.isdir(d):
            raise ValueError(f"graph DB corrupt: missing shard {r} of {n}")
        # edge-sized arrays are memmapped and read once, front to back
        for name, parts in (
            ("cols", col_parts),
            ("rev_edge", rev_parts),
            ("edge_data", ed_parts if meta["has_edge_data"] else None),
        ):
            if parts is None:
                continue
            arr = np.load(os.path.join(d, f"{name}.npy"), mmap_mode="r")
            advise(arr, "sequential")
            parts.append(arr)
        row_parts.append(
            np.load(os.path.join(d, "row_ptr.npy"))[:-1] + edge_starts[r]
        )
        deg_parts.append(np.load(os.path.join(d, "raw_degree.npy")))
        if meta["has_labels"]:
            lab_parts.append(np.load(os.path.join(d, "labels.npy")))

    def cat(parts):
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    row_ptr = np.concatenate(row_parts + [np.array([e], dtype=np.int64)])
    graph = Graph(
        num_vertices=v,
        row_ptr=row_ptr,
        cols=cat(col_parts),
        rev_edge=cat(rev_parts),
        raw_degree=np.concatenate(deg_parts),
        edge_row=np.repeat(np.arange(v, dtype=np.int64), np.diff(row_ptr)),
    )
    labels = np.concatenate(lab_parts) if meta["has_labels"] else None
    edge_data = cat(ed_parts) if meta["has_edge_data"] else None
    return graph, labels, edge_data


def load(base: str) -> tuple[Graph, np.ndarray | None, np.ndarray | None]:
    """Materialize the global graph from shard files, validating the
    header: returns (graph, labels or None, edge data or None)."""
    meta = _read_meta(base)
    if meta["version"] == 1:
        return _load_v1(base, meta)
    return _load_v2(base, meta)
