"""Chunked graph-DB construction with bounded host memory (the port's own
copy of ``fuzzypatternmatching_tpu/graph/build.py``; the same shard files,
byte for byte).

The reference builds its distributed CSR in chunked passes over the edge
stream — count degrees, exchange by owner, partition low/high edges —
never holding the whole stream on one rank
(impl/delegate_partitioned_graph.ipp:398-608). This module is the
equivalent for the shard-file DB (graph/storage.py):

* **Pass A (spill):** stream the edge source (R-MAT generator or edge-list
  chunks); append each directed edge's packed key ``u*V + v`` to a
  per-(shard, rank) spill file, shard = ``u // block`` — the owner
  partition. Degrees accumulate in one V-sized array. Peak memory: one
  generation chunk + V-sized arrays. The R-MAT path runs in native C++
  (fpm_rmat_spill_shards, rank-parallel).
* **Pass B1 (dedupe):** per shard, read its spills (~E/num_shards keys),
  sort, unique → the shard's CSR slice (cols + local row_ptr), written to
  the v2 shard directory plus a temporary sorted-key file.
* **Pass B2 (reverse index):** per shard, group reverse keys by owner and
  binary-search each owner's (memmapped) sorted key file → global
  rev_edge ids. Peak memory: ~5 edge-sized arrays of ONE shard.

The result is byte-identical to ``storage.save(from_edges(...))`` with the
same shard count (cross-tested), but peak memory is O(V + E/num_shards)
instead of O(E): R-MAT s24+ builds on hosts that could never materialize
the stream.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile

import numpy as np

from . import storage
from .csr import Graph  # noqa: F401  (re-exported for callers)
from ..utils.log_step import LogStep


def _degree_labels_from(deg: np.ndarray) -> np.ndarray:
    return np.ceil(np.log2(deg.astype(np.float64) + 1.0)).astype(np.uint64)


def _spill_python(spill_dir, chunk_iter, num_shards, block, num_vertices,
                  suffix="0"):
    """Generic pass A: spill (src, dst) chunks by owner shard. ``suffix``
    disambiguates writers sharing one spill dir (multi-process build)."""
    deg = np.zeros(num_vertices, dtype=np.int64)
    files = [
        open(os.path.join(spill_dir, f"spill_{s}_{suffix}.bin"), "wb")
        for s in range(num_shards)
    ]
    vv = np.uint64(num_vertices)
    try:
        for src, dst in chunk_iter:
            src = np.asarray(src, dtype=np.uint64)
            dst = np.asarray(dst, dtype=np.uint64)
            deg += np.bincount(
                src.astype(np.int64), minlength=num_vertices
            )
            keys = src * vv + dst
            owner = (src // np.uint64(block)).astype(np.int64)
            order = np.argsort(owner, kind="stable")
            keys_s = keys[order]
            bounds = np.searchsorted(owner[order], np.arange(num_shards + 1))
            for s in range(num_shards):
                lo, hi = bounds[s], bounds[s + 1]
                if hi > lo:
                    files[s].write(keys_s[lo:hi].tobytes())
    finally:
        for f in files:
            f.close()
    return deg


def _iter_rmat_chunks(scale, n_ranks, edges_per_vertex, scramble, undirected,
                      base_seed, chunk_edges=1 << 20, rank_lo=0,
                      rank_hi=None):
    from ..generators.rmat import RmatParams, generate_edges

    per_rank = (edges_per_vertex << scale) // n_ranks
    for r in range(rank_lo, n_ranks if rank_hi is None else rank_hi):
        remaining = per_rank
        seed = base_seed + 3 * r
        # generate_edges consumes the rank's mt19937 stream sequentially;
        # chunk by re-running with a bounded edge budget is NOT possible
        # (no skip-ahead), so the python fallback generates the whole rank
        # (still 1/n_ranks of the stream) and slices it into chunks.
        src, dst = generate_edges(
            RmatParams(
                seed=seed, vertex_scale=scale, edge_count=per_rank,
                scramble=scramble, undirected=undirected,
            )
        )
        for lo in range(0, len(src), chunk_edges):
            yield src[lo : lo + chunk_edges], dst[lo : lo + chunk_edges]
        del src, dst
        remaining = 0


def _dedupe_and_write(base, spill_dir, num_shards, num_vertices, block,
                      deg, labels, keydir, shards=None):
    """Pass B1: per-shard sort/unique -> shard dir + sorted-key temp file.
    Returns the processed shards' edge counts (``shards=None`` = all; a
    multi-process build hands each process a disjoint subset)."""
    counts = []
    vv = np.uint64(num_vertices)
    for s in range(num_shards) if shards is None else shards:
        parts = []
        for name in sorted(os.listdir(spill_dir)):
            if name.startswith(f"spill_{s}_"):
                parts.append(
                    np.fromfile(os.path.join(spill_dir, name), dtype=np.uint64)
                )
        keys = (
            np.unique(np.concatenate(parts))
            if parts
            else np.empty(0, dtype=np.uint64)
        )
        del parts
        counts.append(len(keys))
        np.save(os.path.join(keydir, f"keys_{s}.npy"), keys)
        rows = (keys // vv).astype(np.int64)
        cols = (keys % vv).astype(np.int64)
        del keys
        vlo, vhi = min(s * block, num_vertices), min(
            (s + 1) * block, num_vertices
        )
        row_counts = np.bincount(rows - vlo, minlength=vhi - vlo)
        row_ptr = np.zeros(vhi - vlo + 1, dtype=np.int64)
        np.cumsum(row_counts, out=row_ptr[1:])
        d = storage._shard_dir(base, s, num_shards)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "row_ptr.npy"), row_ptr)
        np.save(os.path.join(d, "cols.npy"), cols)
        np.save(os.path.join(d, "raw_degree.npy"), deg[vlo:vhi])
        if labels is not None:
            np.save(os.path.join(d, "labels.npy"), labels[vlo:vhi])
    return counts


def _reverse_pass(base, num_shards, num_vertices, block, edge_starts, keydir,
                  shards=None):
    """Pass B2: global reverse-edge ids via per-owner binary search over the
    memmapped sorted key files (``shards=None`` = all)."""
    vv = np.uint64(num_vertices)
    for s in range(num_shards) if shards is None else shards:
        keys_s = np.load(os.path.join(keydir, f"keys_{s}.npy"), mmap_mode="r")
        rows = (keys_s // vv).astype(np.int64)
        cols = (keys_s % vv).astype(np.int64)
        rkeys = cols.astype(np.uint64) * vv + rows.astype(np.uint64)
        owner = cols // block
        rev = np.full(len(rows), -1, dtype=np.int64)
        for o in range(num_shards):
            m = owner == o
            if not m.any():
                continue
            keys_o = np.load(
                os.path.join(keydir, f"keys_{o}.npy"), mmap_mode="r"
            )
            q = rkeys[m]
            pos = np.searchsorted(keys_o, q)
            posc = np.minimum(pos, max(len(keys_o) - 1, 0))
            found = (
                keys_o[posc] == q if len(keys_o) else np.zeros(len(q), bool)
            )
            rev[m] = np.where(found, edge_starts[o] + posc, -1)
        d = storage._shard_dir(base, s, num_shards)
        np.save(os.path.join(d, "rev_edge.npy"), rev)


def build_db_from_chunks(
    base: str,
    chunk_iter,
    num_vertices: int,
    num_shards: int = 4,
    with_degree_labels: bool = True,
    labels: np.ndarray | None = None,
) -> None:
    """Build a v2 graph DB from an iterator of (src, dst) chunk pairs with
    O(V + E/num_shards) peak memory."""
    os.makedirs(base, exist_ok=True)
    block = -(-num_vertices // num_shards)
    spill_dir = tempfile.mkdtemp(dir=base, prefix=".spill_")
    keydir = tempfile.mkdtemp(dir=base, prefix=".keys_")
    try:
        with LogStep("spill edge stream by owner shard (pass A)"):
            deg = _spill_python(
                spill_dir, chunk_iter, num_shards, block, num_vertices
            )
        if labels is None and with_degree_labels:
            labels = _degree_labels_from(deg)
        with LogStep("per-shard dedupe + CSR slices (pass B1)"):
            counts = _dedupe_and_write(
                base, spill_dir, num_shards, num_vertices, block, deg, labels,
                keydir,
            )
        shutil.rmtree(spill_dir)
        spill_dir = None
        edge_starts = np.zeros(num_shards, dtype=np.int64)
        np.cumsum(counts[:-1], out=edge_starts[1:])
        with LogStep("reverse-edge index (pass B2)"):
            _reverse_pass(
                base, num_shards, num_vertices, block, edge_starts, keydir
            )
        storage.write_meta(
            base, num_shards, num_vertices, int(np.sum(counts)),
            list(edge_starts), labels is not None, False, clean_close=True,
        )
    finally:
        if spill_dir is not None:
            shutil.rmtree(spill_dir, ignore_errors=True)
        shutil.rmtree(keydir, ignore_errors=True)


# --------------------------------------------------------------------------
# Multi-process (multi-host) construction.
#
# The reference builds the graph with P ranks in parallel: each rank scans
# its own slice of the edge stream and the per-owner counts/edges move
# through owner-partitioned mpi_all_to_all exchanges
# (impl/delegate_partitioned_graph.ipp:398-608, 274-379). Here the
# exchange is materialized on the shared filesystem: every process spills
# its stream slice into per-OWNER-shard files (the all-to-all's send
# buffers ARE the files), a barrier replaces the collective's implicit
# synchronization, and each owner process then consumes exactly its
# shards' files. On a multi-host run the spill dir lives on a shared
# filesystem (NFS); locally it is one directory. The result is byte-identical
# to the single-host build: pass B sorts the union of spill files, so the
# partitioning of keys across writers is invisible.


class _BuildPeerFailure(RuntimeError):
    pass


def _file_barrier(markers: str, phase: str, pid: int, nproc: int,
                  timeout: float = 3600.0) -> None:
    """All-process rendezvous via marker files on the shared filesystem
    (the MPI_Barrier analog for the construction pipeline)."""
    import time as _time

    open(os.path.join(markers, f"{phase}_{pid}"), "w").close()
    deadline = _time.monotonic() + timeout
    while True:
        if not os.path.isdir(markers):
            return  # rank 0 already finished cleanup => barrier passed
        names = set(os.listdir(markers))
        fails = [n for n in names if n.startswith(f"{phase}_FAIL_")]
        if fails:
            raise _BuildPeerFailure(
                f"peer process failed in phase {phase}: {fails}"
            )
        if all(f"{phase}_{q}" in names for q in range(nproc)):
            return
        if _time.monotonic() > deadline:
            raise TimeoutError(
                f"barrier {phase}: only {sorted(names)} after {timeout}s"
            )
        _time.sleep(0.05)


def _mark_failed(markers: str, phase: str, pid: int) -> None:
    try:
        open(os.path.join(markers, f"{phase}_FAIL_{pid}"), "w").close()
    except OSError:
        pass


def build_db_from_chunks_distributed(
    base: str,
    chunk_iter,
    num_vertices: int,
    process_id: int,
    num_processes: int,
    num_shards: int = 4,
    with_degree_labels: bool = True,
    labels: np.ndarray | None = None,
    timeout: float = 3600.0,
) -> None:
    """One process's share of a P-process graph build. ``chunk_iter``
    must yield THIS process's slice of the edge stream ((src, dst) chunk
    pairs); the slices must partition the full stream. Every process calls
    this with the same ``base`` (shared filesystem); the shard dirs that
    result are byte-identical to ``build_db_from_chunks`` on one host."""

    def spill(spill_dir):
        return _spill_python(
            spill_dir, chunk_iter, num_shards,
            -(-num_vertices // num_shards), num_vertices,
            suffix=f"p{process_id}",
        )

    _dist_build_common(
        base, spill, num_vertices, process_id, num_processes, num_shards,
        with_degree_labels, labels, timeout,
    )


def _dist_build_common(base, spill_fn, num_vertices, pid, nproc, num_shards,
                       with_degree_labels, labels, timeout):
    block = -(-num_vertices // num_shards)
    work = os.path.join(base, ".dist_build")
    spill_dir = os.path.join(work, "spill")
    keydir = os.path.join(work, "keys")
    markers = os.path.join(work, "markers")
    for d in (spill_dir, keydir, markers):
        os.makedirs(d, exist_ok=True)
    my_shards = [s for s in range(num_shards) if s % nproc == pid]
    try:
        with LogStep(f"[p{pid}] spill stream slice by owner shard (pass A)"):
            deg_part = spill_fn(spill_dir)
        np.save(os.path.join(work, f"deg_{pid}.npy"), deg_part)
        _file_barrier(markers, "A", pid, nproc, timeout)

        deg = np.zeros(num_vertices, dtype=np.int64)
        for q in range(nproc):
            deg += np.load(os.path.join(work, f"deg_{q}.npy"))
        if labels is None and with_degree_labels:
            labels = _degree_labels_from(deg)
        elif labels is not None:
            # Explicitly passed labels must be IDENTICAL on every process
            # (each writes only its owned shards, so divergent label
            # arrays would silently yield divergent shard dirs).
            # Cross-check a content hash via the work dir before any shard
            # is written.
            h = hashlib.sha256(
                np.ascontiguousarray(np.asarray(labels)).tobytes()
            ).hexdigest()
            with open(os.path.join(work, f"labels_hash_{pid}"), "w") as f:
                f.write(h)
            _file_barrier(markers, "LH", pid, nproc, timeout)
            for q in range(nproc):
                with open(os.path.join(work, f"labels_hash_{q}")) as f:
                    other = f.read().strip()
                if other != h:
                    raise ValueError(
                        f"labels mismatch: process {pid} hash {h[:12]} != "
                        f"process {q} hash {other[:12]} — every process "
                        "must pass an identical full-V labels array"
                    )
        with LogStep(f"[p{pid}] owned-shard dedupe + CSR slices (pass B1)"):
            _dedupe_and_write(
                base, spill_dir, num_shards, num_vertices, block, deg,
                labels, keydir, shards=my_shards,
            )
        _file_barrier(markers, "B1", pid, nproc, timeout)

        counts = [
            int(np.load(
                os.path.join(keydir, f"keys_{s}.npy"), mmap_mode="r"
            ).shape[0])
            for s in range(num_shards)
        ]
        edge_starts = np.zeros(num_shards, dtype=np.int64)
        np.cumsum(counts[:-1], out=edge_starts[1:])
        with LogStep(f"[p{pid}] owned-shard reverse-edge index (pass B2)"):
            _reverse_pass(
                base, num_shards, num_vertices, block, edge_starts, keydir,
                shards=my_shards,
            )
        _file_barrier(markers, "B2", pid, nproc, timeout)

        if pid == 0:
            storage.write_meta(
                base, num_shards, num_vertices, int(np.sum(counts)),
                list(edge_starts), labels is not None, False,
                clean_close=True,
            )
        _file_barrier(markers, "META", pid, nproc, timeout)
        if pid == 0:
            shutil.rmtree(work, ignore_errors=True)
    except _BuildPeerFailure:
        raise
    except BaseException:
        _mark_failed(markers, "A", pid)
        _mark_failed(markers, "LH", pid)
        _mark_failed(markers, "B1", pid)
        _mark_failed(markers, "B2", pid)
        _mark_failed(markers, "META", pid)
        raise


def build_rmat_db_distributed(
    base: str,
    scale: int,
    process_id: int,
    num_processes: int,
    n_ranks: int = 4,
    num_shards: int = 4,
    edges_per_vertex: int = 16,
    scramble: bool = True,
    undirected: bool = True,
    base_seed: int = 5489,
    with_degree_labels: bool = True,
    timeout: float = 3600.0,
) -> None:
    """One process's share of a P-process R-MAT DB build: this process
    generates generator ranks [pid*R/P, (pid+1)*R/P) of the n_ranks
    stream (each rank's mt19937 stream depends only on its absolute rank
    id) and spills them by owner shard; passes B1/B2 run on the shards
    this process owns (s % P == pid). Byte-identical to
    ``build_rmat_db`` with the same parameters."""
    from .. import native

    os.makedirs(base, exist_ok=True)
    num_vertices = 1 << scale
    block = -(-num_vertices // num_shards)
    r_lo = process_id * n_ranks // num_processes
    r_hi = (process_id + 1) * n_ranks // num_processes

    def spill(spill_dir):
        if native.available():
            return native.rmat_spill_shards_native(
                spill_dir, scale, n_ranks, num_shards, block,
                edges_per_vertex=edges_per_vertex, scramble=scramble,
                undirected=undirected, base_seed=base_seed,
                rank_lo=r_lo, rank_hi=r_hi,
            )
        return _spill_python(
            spill_dir,
            _iter_rmat_chunks(
                scale, n_ranks, edges_per_vertex, scramble, undirected,
                base_seed, rank_lo=r_lo, rank_hi=r_hi,
            ),
            num_shards, block, num_vertices, suffix=f"p{process_id}",
        )

    _dist_build_common(
        base, spill, num_vertices, process_id, num_processes, num_shards,
        with_degree_labels, None, timeout,
    )


def build_rmat_db(
    base: str,
    scale: int,
    n_ranks: int = 4,
    num_shards: int = 4,
    edges_per_vertex: int = 16,
    scramble: bool = True,
    undirected: bool = True,
    base_seed: int = 5489,
    with_degree_labels: bool = True,
) -> None:
    """Stream-build the R-MAT graph DB (generate_rmat.cpp:202-205 stream)
    with bounded memory; native C++ generation when available."""
    from .. import native

    os.makedirs(base, exist_ok=True)
    num_vertices = 1 << scale
    block = -(-num_vertices // num_shards)

    if not native.available():
        build_db_from_chunks(
            base,
            _iter_rmat_chunks(
                scale, n_ranks, edges_per_vertex, scramble, undirected,
                base_seed,
            ),
            num_vertices,
            num_shards,
            with_degree_labels=with_degree_labels,
        )
        return

    spill_dir = tempfile.mkdtemp(dir=base, prefix=".spill_")
    keydir = tempfile.mkdtemp(dir=base, prefix=".keys_")
    try:
        with LogStep("R-MAT stream spill by owner shard (native, pass A)"):
            deg = native.rmat_spill_shards_native(
                spill_dir, scale, n_ranks, num_shards, block,
                edges_per_vertex=edges_per_vertex, scramble=scramble,
                undirected=undirected, base_seed=base_seed,
            )
        labels = _degree_labels_from(deg) if with_degree_labels else None
        with LogStep("per-shard dedupe + CSR slices (pass B1)"):
            counts = _dedupe_and_write(
                base, spill_dir, num_shards, num_vertices, block, deg, labels,
                keydir,
            )
        shutil.rmtree(spill_dir)
        spill_dir = None
        edge_starts = np.zeros(num_shards, dtype=np.int64)
        np.cumsum(counts[:-1], out=edge_starts[1:])
        with LogStep("reverse-edge index (pass B2)"):
            _reverse_pass(
                base, num_shards, num_vertices, block, edge_starts, keydir
            )
        storage.write_meta(
            base, num_shards, num_vertices, int(np.sum(counts)),
            list(edge_starts), labels is not None, False, clean_close=True,
        )
    finally:
        if spill_dir is not None:
            shutil.rmtree(spill_dir, ignore_errors=True)
        shutil.rmtree(keydir, ignore_errors=True)
