"""Persistent sharded graph storage — the distributed_db equivalent.

The port's own copy of ``fuzzypatternmatching_tpu/graph/storage.py``: the
same files, byte for byte. A DB is a directory with a JSON header
(``meta.json``: uuid, format version, shard count, sizes, ``clean_close``,
the validation fields of distributed_db.hpp:88-93, 258-286, 353-359) and
one shard per contiguous vertex block: a directory of raw ``.npy`` arrays
(format v2) or one ``.npz`` file (format v1, read only).

* ``save`` / ``write_shard`` / ``write_meta`` — write a DB (the header is
  written dirty first and clean last).
* ``load`` — materialize the global CSR on this host.
* ``open_db`` — per-shard open (db_open analog, distributed_db.hpp:258-286):
  every edge-sized array stays a lazy ``np.memmap``, read through the
  edge-range accessors (``cols_range`` etc.); no global CSR is built.
* ``transfer`` — copy a DB to or from backup storage
  (distributed_db.hpp:106-186).
"""

from __future__ import annotations

import json
import os
import shutil
import uuid as uuid_mod

import numpy as np

from ..utils.page_cache import advise
from .csr import Graph

_FORMAT_VERSION = 2


def _meta_path(base: str) -> str:
    return os.path.join(base, "meta.json")


def _shard_dir(base: str, r: int, n: int) -> str:
    # mirrors the reference's "<base>_<rank>_of_<size>" naming
    return os.path.join(base, f"shard_{r}_of_{n}")


def write_shard(
    base: str,
    r: int,
    n: int,
    row_ptr: np.ndarray,
    cols: np.ndarray,
    rev_edge: np.ndarray,
    raw_degree: np.ndarray,
    labels: np.ndarray | None = None,
    edge_data: np.ndarray | None = None,
) -> None:
    """Write one shard's arrays (row_ptr is block-local, starting at 0)."""
    d = _shard_dir(base, r, n)
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "row_ptr.npy"), np.asarray(row_ptr, np.int64))
    np.save(os.path.join(d, "cols.npy"), np.asarray(cols, np.int64))
    np.save(os.path.join(d, "rev_edge.npy"), np.asarray(rev_edge, np.int64))
    np.save(os.path.join(d, "raw_degree.npy"), np.asarray(raw_degree, np.int64))
    if labels is not None:
        np.save(os.path.join(d, "labels.npy"), labels)
    if edge_data is not None:
        np.save(os.path.join(d, "edge_data.npy"), edge_data)


def write_meta(
    base: str,
    num_shards: int,
    num_vertices: int,
    num_edges: int,
    edge_starts: list[int],
    has_labels: bool,
    has_edge_data: bool,
    clean_close: bool,
) -> dict:
    block = -(-num_vertices // num_shards)
    meta = {
        "uuid": str(uuid_mod.uuid4()),
        "version": _FORMAT_VERSION,
        "num_shards": num_shards,
        "num_vertices": num_vertices,
        "num_edges": num_edges,
        "block_size": block,
        "edge_starts": [int(x) for x in edge_starts],
        "has_labels": has_labels,
        "has_edge_data": has_edge_data,
        "clean_close": clean_close,
    }
    with open(_meta_path(base), "w") as f:
        json.dump(meta, f)
    return meta


def save(
    graph: Graph,
    base: str,
    num_shards: int = 1,
    labels: np.ndarray | None = None,
    edge_data: np.ndarray | None = None,
) -> None:
    """Partition the graph into ``num_shards`` contiguous vertex blocks and
    write one shard directory per block plus the validated header."""
    os.makedirs(base, exist_ok=True)
    v = graph.num_vertices
    block = -(-v // num_shards)
    edge_starts = [
        int(graph.row_ptr[min(r * block, v)]) for r in range(num_shards)
    ]
    write_meta(
        base, num_shards, v, graph.num_edges, edge_starts,
        labels is not None, edge_data is not None, clean_close=False,
    )
    for r in range(num_shards):
        lo, hi = min(r * block, v), min((r + 1) * block, v)
        e_lo, e_hi = int(graph.row_ptr[lo]), int(graph.row_ptr[hi])
        write_shard(
            base, r, num_shards,
            row_ptr=graph.row_ptr[lo : hi + 1] - graph.row_ptr[lo],
            cols=graph.cols[e_lo:e_hi],
            rev_edge=graph.rev_edge[e_lo:e_hi],
            raw_degree=graph.raw_degree[lo:hi],
            labels=None if labels is None else labels[lo:hi],
            edge_data=None if edge_data is None else edge_data[e_lo:e_hi],
        )
    write_meta(
        base, num_shards, v, graph.num_edges, edge_starts,
        labels is not None, edge_data is not None, clean_close=True,
    )


def _read_meta(base: str) -> dict:
    with open(_meta_path(base)) as f:
        meta = json.load(f)
    if meta.get("version") not in (1, _FORMAT_VERSION):
        raise ValueError(f"graph DB version mismatch: {meta.get('version')}")
    if not meta.get("clean_close", False):
        raise ValueError("graph DB corrupt: not closed cleanly")
    return meta


class GraphDb:
    """Per-shard open of a stored graph (db_open analog).

    Vertex-sized arrays (``row_ptr``, ``raw_degree``, labels) are assembled
    eagerly — they are small. Edge-sized arrays stay per-shard ``np.memmap``s
    served through the edge-range accessors; no global CSR exists."""

    def __init__(self, base: str):
        meta = _read_meta(base)
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(
                "open_db requires a format-v2 graph DB (re-save or rebuild)"
            )
        self.meta = meta
        self.base = base
        self.num_vertices = meta["num_vertices"]
        self.num_edges = meta["num_edges"]
        self.num_shards = n = meta["num_shards"]
        self.block = meta["block_size"]
        self.edge_starts = np.array(
            meta["edge_starts"] + [self.num_edges], dtype=np.int64
        )
        self._cols = []
        self._rev = []
        self._edata = []
        row_parts, deg_parts, lab_parts = [], [], []
        for r in range(n):
            d = _shard_dir(base, r, n)
            if not os.path.isdir(d):
                raise ValueError(f"graph DB corrupt: missing shard {r} of {n}")
            self._cols.append(
                np.load(os.path.join(d, "cols.npy"), mmap_mode="r")
            )
            self._rev.append(
                np.load(os.path.join(d, "rev_edge.npy"), mmap_mode="r")
            )
            # cache_utilities.hpp advice: bulk chunk scans read
            # sequentially; point lookups (_at) are correct either way
            advise(self._cols[-1], "sequential")
            advise(self._rev[-1], "sequential")
            if meta["has_edge_data"]:
                self._edata.append(
                    np.load(os.path.join(d, "edge_data.npy"), mmap_mode="r")
                )
                advise(self._edata[-1], "sequential")
            row_parts.append(
                np.load(os.path.join(d, "row_ptr.npy"))[:-1]
                + self.edge_starts[r]
            )
            deg_parts.append(np.load(os.path.join(d, "raw_degree.npy")))
            if meta["has_labels"]:
                lab_parts.append(np.load(os.path.join(d, "labels.npy")))
        self.row_ptr = np.concatenate(
            row_parts + [np.array([self.num_edges], dtype=np.int64)]
        )
        self.raw_degree = np.concatenate(deg_parts)
        self.labels = np.concatenate(lab_parts) if meta["has_labels"] else None

    # -- edge-range reads over the shard memmaps --

    def _range(self, parts, lo: int, hi: int) -> np.ndarray:
        out = []
        s = int(np.searchsorted(self.edge_starts, lo, side="right")) - 1
        while lo < hi:
            send = int(self.edge_starts[s + 1])
            take = min(hi, send)
            out.append(parts[s][lo - self.edge_starts[s] : take - self.edge_starts[s]])
            lo = take
            s += 1
        if not out:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(out) if len(out) > 1 else np.asarray(out[0])

    def cols_range(self, lo: int, hi: int) -> np.ndarray:
        return self._range(self._cols, lo, hi)

    def rev_range(self, lo: int, hi: int) -> np.ndarray:
        return self._range(self._rev, lo, hi)

    def _at(self, parts, ids: np.ndarray) -> np.ndarray:
        out = np.empty(len(ids), dtype=np.int64)
        shard_of = np.searchsorted(self.edge_starts, ids, side="right") - 1
        for s in np.unique(shard_of):
            m = shard_of == s
            out[m] = parts[s][ids[m] - self.edge_starts[s]]
        return out

    def cols_at(self, ids: np.ndarray) -> np.ndarray:
        return self._at(self._cols, ids)

    def edge_row_at(self, ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.row_ptr, ids, side="right") - 1

    def edge_row_range(self, lo: int, hi: int) -> np.ndarray:
        if hi <= lo:
            return np.empty(0, dtype=np.int64)
        vlo = int(np.searchsorted(self.row_ptr, lo, side="right")) - 1
        vhi = int(np.searchsorted(self.row_ptr, hi - 1, side="right"))
        bounds = np.clip(self.row_ptr[vlo : vhi + 1], lo, hi)
        return np.repeat(
            np.arange(vlo, vhi, dtype=np.int64), np.diff(bounds)
        )

    def degree(self, v: int) -> int:
        return int(self.raw_degree[v])

    def to_graph(self) -> Graph:
        """Materialize the global CSR (what ``load`` returns)."""
        cols = self.cols_range(0, self.num_edges)
        rev = self.rev_range(0, self.num_edges)
        return Graph(
            num_vertices=self.num_vertices,
            row_ptr=self.row_ptr,
            cols=cols,
            rev_edge=rev,
            raw_degree=self.raw_degree,
            edge_row=np.repeat(
                np.arange(self.num_vertices, dtype=np.int64),
                np.diff(self.row_ptr),
            ),
        )


def open_db(base: str) -> GraphDb:
    """Per-shard open without materializing the global CSR."""
    return GraphDb(base)


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


def transfer(src_base: str, dst_base: str) -> None:
    """Copy a graph DB directory (distributed_db::transfer,
    distributed_db.hpp:106-186), validating the source header first."""
    with open(_meta_path(src_base)) as f:
        meta = json.load(f)
    if not meta.get("clean_close", False):
        raise ValueError("refusing to transfer a dirty graph DB")
    os.makedirs(dst_base, exist_ok=True)
    for name in os.listdir(src_base):
        s = os.path.join(src_base, name)
        d = os.path.join(dst_base, name)
        if os.path.isdir(s):
            shutil.copytree(s, d, dirs_exist_ok=True)
        else:
            shutil.copyfile(s, d)
