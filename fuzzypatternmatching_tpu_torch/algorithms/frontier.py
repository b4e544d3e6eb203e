"""Classic graph algorithms as dense torch supersteps on the CSR.

The port of ``fuzzypatternmatching_tpu/algorithms/frontier.py`` (the
reference's visitor-queue algorithms: include/havoqgt/
breadth_first_search.hpp, connected_components.hpp, page_rank.hpp,
kth_core.hpp, single_source_shortest_path.hpp, triangle_count.hpp). Each
asynchronous visitor traversal is an edge-parallel relaxation iterated to
its fixpoint: for vertex v's CSR row, ``col[e]`` are the senders, and every
segment reduction runs over the edge's row (``graph.edge_row``) with
``scatter_reduce_`` / ``index_add_``. An empty segment keeps what
``jax.ops.segment_min`` / ``segment_sum`` give it: the dtype's largest value
(``2^31 - 1``, ``+inf``) and 0.

Each function keeps the JAX name, arguments and numpy return values and
takes ``device`` (``"cuda"`` by default; a CUDA device that is missing
raises). ``lax.while_loop`` is a Python loop that reads the step's changed
flag once per iteration; both packages run the same Jacobi schedule, so
the fixpoints are the same values bit for bit (PageRank's float sums come
in another order). The JAX package ran all of this in XLA and numpy, not
Pallas: the steps are plain torch. ``last_stats`` keeps the iteration
count of each algorithm's last call (and the triangle count's wedges and
chunks).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import Graph

_INF = 2**31 - 1

# Wedges a triangle-count chunk enumerates at most. A wedge takes about 60
# bytes of int64 temporaries, so a chunk at the default takes about 4 GB.
WEDGE_CHUNK = 1 << 26

last_stats: dict[str, dict] = {}


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available")
    return dev


def _device_csr(graph: Graph, dev: torch.device):
    """(col int32 [E], edge row int64 [E], degree int64 [V]) on ``dev``.
    The row (``graph.edge_row``) is expanded from ``row_ptr`` on the device
    rather than uploaded; it indexes every segment reduction, which torch
    wants in int64."""
    row_ptr = torch.from_numpy(np.asarray(graph.row_ptr, dtype=np.int64)).to(dev)
    deg = row_ptr[1:] - row_ptr[:-1]
    erow = torch.repeat_interleave(
        torch.arange(graph.num_vertices, device=dev), deg,
        output_size=graph.num_edges,
    )
    col = torch.from_numpy(np.asarray(graph.cols, dtype=np.int32)).to(dev)
    return col, erow, deg


def _fixpoint(step, state) -> tuple:
    """Apply ``step`` until it reports no change; ``(state, iterations)``.
    One host read of the changed flag per iteration."""
    it = 0
    while True:
        *state, changed = step(*state)
        it += 1
        if not bool(changed):
            return state, it


def _bfs_step(col, erow, level, parent):
    lc = level.index_select(0, col)
    reach = lc < _INF
    # level + 1, with unreached senders at INF (no int32 wrap-around)
    cand = torch.where(reach, lc, _INF - 1) + 1
    new_level = level.scatter_reduce(0, erow, cand, "amin", include_self=True)
    # parent = the smallest neighbour id at new_level - 1
    is_par = reach & (cand == new_level.index_select(0, erow))
    pcand = torch.where(is_par, col, level.shape[0])
    new_parent = torch.full_like(parent, _INF).scatter_reduce_(
        0, erow, pcand, "amin", include_self=True
    )
    improved = new_level < level
    return new_level, torch.where(improved, new_parent, parent), improved.any()


def breadth_first_search(graph: Graph, source: int, device="cuda"):
    """Levels + parents from ``source`` (breadth_first_search.hpp:196-204).

    Parent choice is deterministic: the smallest-id neighbor on a shortest
    path (the reference keeps whichever visitor arrived first)."""
    dev = _device(device)
    v = graph.num_vertices
    col, erow, _ = _device_csr(graph, dev)
    level = torch.full((v,), _INF, dtype=torch.int32, device=dev)
    parent = torch.full((v,), -1, dtype=torch.int32, device=dev)
    level[source] = 0
    parent[source] = source
    (level, parent), it = _fixpoint(
        lambda lv, p: _bfs_step(col, erow, lv, p), (level, parent)
    )
    last_stats["bfs"] = {"iterations": it}
    return level.cpu().numpy(), parent.cpu().numpy()


def _cc_step(col, erow, comp):
    new = comp.scatter_reduce(
        0, erow, comp.index_select(0, col), "amin", include_self=True
    )
    return new, (new < comp).any()


def connected_components(graph: Graph, device="cuda"):
    """Min-label propagation (connected_components.hpp:121)."""
    dev = _device(device)
    col, erow, _ = _device_csr(graph, dev)
    comp = torch.arange(graph.num_vertices, dtype=torch.int32, device=dev)
    (comp,), it = _fixpoint(lambda c: _cc_step(col, erow, c), (comp,))
    last_stats["cc"] = {"iterations": it}
    return comp.cpu().numpy()


def _pagerank_step(col, erow, out_deg, pr, damping: float):
    v = pr.shape[0]
    contrib = torch.where(out_deg > 0, pr / out_deg, 0.0)
    recv = torch.zeros_like(pr).index_add_(0, erow, contrib.index_select(0, col))
    dangling = torch.where(out_deg == 0, pr, 0.0).sum()
    return (1.0 - damping) / v + damping * (recv + dangling / v)


def pagerank(graph: Graph, damping: float = 0.85, iterations: int = 20,
             device="cuda"):
    """Power iteration (page_rank.hpp:167). Contributions flow along the
    symmetric edges; dangling mass is redistributed uniformly. float32, as
    in the JAX package; the sums are atomic on the card, so their order
    (and the last bits) vary."""
    dev = _device(device)
    v = graph.num_vertices
    col, erow, deg = _device_csr(graph, dev)
    out_deg = deg.to(torch.float32)
    pr = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        pr = _pagerank_step(col, erow, out_deg, pr, damping)
    last_stats["pagerank"] = {"iterations": iterations}
    return pr.cpu().numpy()


def _kcore_step(col, erow, alive, k: int):
    # alive neighbours per row; JAX also ANDs the row's own bit into each
    # edge, which changes the count of dead rows only (they stay dead)
    deg = torch.zeros(alive.shape[0], dtype=torch.int32, device=alive.device)
    deg.index_add_(0, erow, alive.index_select(0, col).to(torch.int32))
    new = alive & (deg >= k)
    return new, (new != alive).any()


def kth_core(graph: Graph, k: int, device="cuda"):
    """Iterative peel: alive vertices need >= k alive neighbors
    (kth_core.hpp:130)."""
    dev = _device(device)
    col, erow, _ = _device_csr(graph, dev)
    alive = torch.ones(graph.num_vertices, dtype=torch.bool, device=dev)
    (alive,), it = _fixpoint(lambda a: _kcore_step(col, erow, a, k), (alive,))
    last_stats["kcore"] = {"iterations": it}
    return alive.cpu().numpy()


def _sssp_step(col, erow, w, dist):
    dc = dist.index_select(0, col)
    cand = torch.where(dc < torch.inf, dc + w, torch.inf)
    new = dist.scatter_reduce(0, erow, cand, "amin", include_self=True)
    return new, (new < dist).any()


def sssp(graph: Graph, source: int, weights: np.ndarray, device="cuda"):
    """Bellman-Ford edge relaxation (single_source_shortest_path.hpp).
    ``weights[e]`` is the weight of directed edge e; relaxing v uses the
    reverse edge's weight (sender-side), falling back to the slot's own
    weight for asymmetric inputs. float32 relaxation, as in the JAX
    package: the same fixpoint values. The JAX package gathers the reverse
    weights on the host and then casts to float32; casting first and
    gathering on the device gives the same values (at s21 the host gather
    took 1.8 s of a 2.0 s call on the card's host)."""
    dev = _device(device)
    col, erow, _ = _device_csr(graph, dev)
    w32 = torch.from_numpy(np.asarray(weights, dtype=np.float32)).to(dev)
    rev = torch.from_numpy(np.asarray(graph.rev_edge, dtype=np.int64)).to(dev)
    w = torch.where(rev >= 0, w32[rev.clamp(min=0)], w32)
    del w32, rev
    dist = torch.full((graph.num_vertices,), torch.inf, dtype=torch.float32, device=dev)
    dist[source] = 0.0
    (dist,), it = _fixpoint(lambda d: _sssp_step(col, erow, w, d), (dist,))
    last_stats["sssp"] = {"iterations": it}
    return dist.cpu().numpy()


def _oriented(graph: Graph, dev: torch.device):
    """The degree-oriented graph: keep (u, w) with (deg u, u) < (deg w, w).
    Returns (deg, sorted keys u*V + w, oriented neighbours, per-slot end of
    the slot's row), all int64 on ``dev``."""
    v = graph.num_vertices
    col, rows, deg = _device_csr(graph, dev)
    cols = col.to(torch.int64)
    du, dw = deg[rows], deg[cols]
    keep = (du < dw) | ((du == dw) & (rows < cols))
    keys = torch.sort(rows[keep] * v + cols[keep]).values
    del col, rows, cols, du, dw, keep
    orow = keys // v
    optr = torch.zeros(v + 1, dtype=torch.int64, device=dev)
    optr[1:] = torch.cumsum(torch.bincount(orow, minlength=v), 0)
    return deg, keys, keys - orow * v, optr[orow + 1]


def triangle_count(graph: Graph, wedge_chunk: int = WEDGE_CHUNK,
                   device="cuda") -> int:
    """Global triangle count (triangle_count.hpp): degree-orient the edges
    (low (deg, id) -> high), enumerate each vertex's oriented-neighbour
    pairs on the device in chunks of at most ``wedge_chunk`` wedges, and
    close each wedge by membership of its oriented closing edge in the
    sorted keys (``torch.searchsorted``). Work is the sum of oriented
    degree squared (the O(E^1.5) forward algorithm).

    A wedge is an oriented slot s and a later slot of its row: slot s owns
    ``row_end[s] - s - 1`` wedges, and wedge ids run over the slots in
    order, so a chunk is a range of wedge ids that may start or end inside
    a slot. All index arithmetic is integer; the count accumulates in int64
    on the device and is read once."""
    if wedge_chunk < 1:
        raise ValueError(f"wedge_chunk must be positive, got {wedge_chunk}")
    dev = _device(device)
    v = graph.num_vertices
    deg, keys, onbr, row_end = _oriented(graph, dev)
    n_keys = keys.shape[0]
    slots = torch.arange(n_keys, dtype=torch.int64, device=dev)
    per_slot = row_end - slots - 1
    w_end = torch.cumsum(per_slot, 0)
    w_start = w_end - per_slot
    wedges = int(w_end[-1]) if n_keys else 0
    starts = torch.arange(0, wedges, wedge_chunk, dtype=torch.int64, device=dev)
    ends = torch.clamp(starts + wedge_chunk, max=wedges)
    # the slots holding each chunk's first and last wedge
    first = torch.searchsorted(w_end, starts, right=True)
    last = torch.searchsorted(w_end, ends - 1, right=True)
    bounds = torch.stack([starts, ends, first, last], 1).cpu().tolist()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for w0, w1, s0, s1 in bounds:
        cnt = (torch.clamp(w_end[s0 : s1 + 1], max=w1)
               - torch.clamp(w_start[s0 : s1 + 1], min=w0))
        slot = torch.repeat_interleave(slots[s0 : s1 + 1], cnt, output_size=w1 - w0)
        off = torch.arange(w0, w1, dtype=torch.int64, device=dev) - w_start[slot]
        a = onbr[slot]
        b = onbr[slot + 1 + off]
        del off, slot
        # the closing edge, oriented by (deg, id) like the keys
        a_low = (deg[a] < deg[b]) | ((deg[a] == deg[b]) & (a < b))
        q = torch.where(a_low, a * v + b, b * v + a)
        del a, b, a_low
        pos = torch.clamp(torch.searchsorted(keys, q), max=n_keys - 1)
        total += (keys[pos] == q).sum()
    last_stats["triangles"] = {"wedges": wedges, "chunks": len(bounds)}
    return int(total)
