"""Classic graph algorithms over a mesh of shards.

The port of ``fuzzypatternmatching_tpu/algorithms/frontier_sharded.py``
(the reference's all-rank BFS / CC / PageRank / k-core / SSSP drivers).
The layout is the JAX module's:

* **the edges are partitioned** into n contiguous CSR chunks of about E/n
  (the chunking of the mesh LCC engine, hub rows split across shards), so
  each superstep's relaxation is E/n per shard;
* **the V-sized state is replicated** on every shard: each shard reduces
  its chunk's contributions into a V-sized partial (``scatter_reduce_`` /
  ``index_add_``), and one ``pmin`` / ``psum`` over the mesh combines the
  partials, so every shard holds the same new state;
* convergence is a ``pmax`` of the shards' changed flags, read once per
  iteration.

Each function keeps the JAX name, arguments and numpy results, and takes
``device`` (default ``"cuda"``; a missing card raises) for the mesh it
builds when none is given. The fixpoints equal ``algorithms/frontier.py``
(PageRank's float sums come in another order). The chunks are cut exactly
(the JAX module pads each to E/n with a sentinel vertex).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import Mesh

_INF = 2**31 - 1


def _mesh_for(mesh: Mesh | None, num_devices: int | None, device) -> Mesh:
    if mesh is not None:
        return mesh
    from ..utils.dist import build_mesh

    return build_mesh(num_devices=num_devices, device=device)


def _chunked_csr(graph, mesh: Mesh, extra: np.ndarray | None = None):
    """Per shard (col int32, edge row int64, extra or None) of its
    contiguous edge chunk, on the shard's device."""
    e, n = graph.num_edges, mesh.n
    ec = max(-(-e // n), 1)
    out = []
    for r, dev in zip(mesh.shard_ids, mesh.devices):
        lo, hi = r * ec, min((r + 1) * ec, e)
        hi = max(hi, lo)
        col = torch.from_numpy(np.asarray(graph.cols_range(lo, hi), dtype=np.int32)).to(dev)
        row = torch.from_numpy(np.asarray(graph.edge_row_range(lo, hi), dtype=np.int64)).to(dev)
        ext = None if extra is None else torch.from_numpy(np.ascontiguousarray(extra[lo:hi])).to(dev)
        out.append((col, row, ext))
    return out


def _replicated(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    return [t.to(d) for d in mesh.devices]


def _changed(mesh: Mesh, flags: list[torch.Tensor]) -> bool:
    return bool(mesh.pmax([f.to(torch.int32) for f in flags])[0])


def breadth_first_search(
    graph, source: int, mesh: Mesh | None = None,
    num_devices: int | None = None, device="cuda",
):
    """Levels and parents (breadth_first_search.hpp:196-204): the parent is
    the smallest-id neighbour on a shortest path."""
    mesh = _mesh_for(mesh, num_devices, device)
    v = graph.num_vertices
    chunks = _chunked_csr(graph, mesh)
    level0 = torch.full((v,), _INF, dtype=torch.int32)
    parent0 = torch.full((v,), -1, dtype=torch.int32)
    level0[source] = 0
    parent0[source] = source
    level, parent = _replicated(mesh, level0), _replicated(mesh, parent0)
    while True:
        lcs, parts = [], []
        for (col, row, _), lv in zip(chunks, level):
            lc = lv[col]
            cand = torch.where(lc < _INF, lc, _INF - 1) + 1
            lcs.append(lc)
            parts.append(torch.full_like(lv, _INF).scatter_reduce_(0, row, cand, "amin"))
        new_level = [torch.minimum(lv, m) for lv, m in zip(level, mesh.pmin(parts))]
        pparts = []
        for (col, row, _), lc, nl in zip(chunks, lcs, new_level):
            is_par = (lc < _INF) & (lc + 1 == nl[row])
            pcand = torch.where(is_par, col, v)
            pparts.append(torch.full_like(nl, _INF).scatter_reduce_(0, row, pcand, "amin"))
        improved = [nl < lv for nl, lv in zip(new_level, level)]
        parent = [
            torch.where(imp, np_, p)
            for imp, np_, p in zip(improved, mesh.pmin(pparts), parent)
        ]
        changed = _changed(mesh, [imp.any() for imp in improved])
        level = new_level
        if not changed:
            return level[0].cpu().numpy(), parent[0].cpu().numpy()


def connected_components(
    graph, mesh: Mesh | None = None, num_devices: int | None = None, device="cuda",
):
    """Min-label propagation (connected_components.hpp:121)."""
    mesh = _mesh_for(mesh, num_devices, device)
    chunks = _chunked_csr(graph, mesh)
    comp = _replicated(mesh, torch.arange(graph.num_vertices, dtype=torch.int32))
    while True:
        parts = [
            torch.full_like(c, _INF).scatter_reduce_(0, row, c[col], "amin")
            for (col, row, _), c in zip(chunks, comp)
        ]
        new = [torch.minimum(c, m) for c, m in zip(comp, mesh.pmin(parts))]
        changed = _changed(mesh, [(a < c).any() for a, c in zip(new, comp)])
        comp = new
        if not changed:
            return comp[0].cpu().numpy()


def pagerank(
    graph, damping: float = 0.85, iterations: int = 20,
    mesh: Mesh | None = None, num_devices: int | None = None, device="cuda",
):
    """Power iteration (page_rank.hpp:167): per-shard partial receive sums,
    summed over the mesh. float32, as in the JAX package."""
    mesh = _mesh_for(mesh, num_devices, device)
    v = graph.num_vertices
    chunks = _chunked_csr(graph, mesh)
    deg = _replicated(mesh, torch.from_numpy(np.diff(graph.row_ptr).astype(np.float32)))
    pr = _replicated(mesh, torch.full((v,), 1.0 / v, dtype=torch.float32))
    for _ in range(iterations):
        parts = []
        for (col, row, _), p, d in zip(chunks, pr, deg):
            contrib = torch.where(d > 0, p / d, 0.0)
            parts.append(torch.zeros_like(p).index_add_(0, row, contrib[col]))
        pr = [
            (1.0 - damping) / v
            + damping * (recv + torch.where(d == 0, p, 0.0).sum() / v)
            for recv, p, d in zip(mesh.psum(parts), pr, deg)
        ]
    return pr[0].cpu().numpy()


def kth_core(
    graph, k: int, mesh: Mesh | None = None,
    num_devices: int | None = None, device="cuda",
):
    """Iterative peel (kth_core.hpp:130): a vertex stays while it has at
    least k alive neighbours."""
    mesh = _mesh_for(mesh, num_devices, device)
    chunks = _chunked_csr(graph, mesh)
    alive = _replicated(mesh, torch.ones(graph.num_vertices, dtype=torch.bool))
    while True:
        parts = [
            torch.zeros(a.shape[0], dtype=torch.int32, device=a.device).index_add_(
                0, row, (a[col] & a[row]).to(torch.int32)
            )
            for (col, row, _), a in zip(chunks, alive)
        ]
        new = [a & (d >= k) for a, d in zip(alive, mesh.psum(parts))]
        changed = _changed(mesh, [(x != a).any() for x, a in zip(new, alive)])
        alive = new
        if not changed:
            return alive[0].cpu().numpy()


def sssp(
    graph, source: int, weights: np.ndarray, mesh: Mesh | None = None,
    num_devices: int | None = None, device="cuda",
):
    """Bellman-Ford (single_source_shortest_path.hpp): relaxing v reads the
    reverse edge's weight (sender side), or the edge's own where it has no
    reverse; float32 as in the JAX package."""
    mesh = _mesh_for(mesh, num_devices, device)
    v = graph.num_vertices
    e = graph.num_edges
    rev = np.asarray(graph.rev_range(0, e))
    w_in = np.where(rev >= 0, weights[np.maximum(rev, 0)], weights).astype(np.float32)
    chunks = _chunked_csr(graph, mesh, extra=w_in)
    dist0 = torch.full((v,), torch.inf, dtype=torch.float32)
    dist0[source] = 0.0
    dist = _replicated(mesh, dist0)
    while True:
        parts = []
        for (col, row, w), d in zip(chunks, dist):
            dc = d[col]
            cand = torch.where(dc < torch.inf, dc + w, torch.inf)
            parts.append(torch.full_like(d, torch.inf).scatter_reduce_(0, row, cand, "amin"))
        new = [torch.minimum(d, m) for d, m in zip(dist, mesh.pmin(parts))]
        changed = _changed(mesh, [(a < d).any() for a, d in zip(new, dist)])
        dist = new
        if not changed:
            return dist[0].cpu().numpy()
