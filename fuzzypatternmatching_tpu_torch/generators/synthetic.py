"""Other synthetic edge streams.

* ``upper_triangle``: deterministic test stream of all (i, j), i < j pairs
  over small vertex ranges, optionally symmetrized — the reference's
  upper_triangle_edge_generator.hpp test generator.
* ``preferential_attachment``: Barabasi-Albert-style stream, same
  DISTRIBUTION as the reference (kept for quick synthetic graphs).
* ``preferential_attachment_exact``: bit-exact port of the reference's
  parallel PA algorithm (gen_preferential_attachment_edge_list.hpp:70-220 /
  detail/preferential_attachment.hpp:68-150): per-rank mt19937 streams
  seeded ``base_seed*rank + rank``, boost uniform_int/uniform_01 draw
  algorithms, pointer-slot resolution (the MPI pointer-jumping rounds
  converge to the same fixpoint as direct chasing), optional rewire pass
  (seed ``base_seed + 3*rank``) and the hash_nbits node scramble.
  The reference never invokes this generator from a driver, so parameters
  are free; the stream for any (node_scale, edge_scale, beta, prob_rewire,
  n_ranks, base_seed) is byte-identical to what the reference would emit.

The port's own copy of ``fuzzypatternmatching_tpu/generators/synthetic.py``.
"""

from __future__ import annotations

import numpy as np

from ..utils.hashing import hash_nbits


def upper_triangle(num_vertices: int, undirected: bool = True):
    idx = np.triu_indices(num_vertices, k=1)
    src = idx[0].astype(np.int64)
    dst = idx[1].astype(np.int64)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src, dst


class _Mt19937Stream:
    """Raw boost::mt19937 32-bit output stream (init_genrand seeding —
    identical to numpy RandomState; verified by the R-MAT conformance
    suite), consumed one draw at a time with block refills."""

    def __init__(self, seed: int, block: int = 4096):
        self._rs = np.random.RandomState(seed & 0xFFFFFFFF)
        self._block = block
        self._buf = np.empty(0, dtype=np.uint64)
        self._pos = 0

    def next(self) -> int:
        if self._pos >= len(self._buf):
            self._buf = self._rs.randint(
                0, 2**32, size=self._block, dtype=np.uint32
            ).astype(np.uint64)
            self._pos = 0
        v = int(self._buf[self._pos])
        self._pos += 1
        return v

    def uniform_01(self) -> float:
        """boost uniform_01 over mt19937: draw / 2**32 as double."""
        return self.next() * 2.0**-32


_U64_MAX = (1 << 64) - 1
_BRANGE = 0xFFFFFFFF  # mt19937 max - min


def _uniform_int(stream: _Mt19937Stream, range_: int) -> int:
    """boost::random::uniform_int_distribution(0, range_) over mt19937 —
    the exact generate_uniform_int algorithm
    (boost/random/uniform_int_distribution.hpp): bucket rejection when the
    engine range covers the target, multi-draw composition otherwise."""
    if range_ == 0:
        return 0
    if range_ <= _BRANGE:
        # brange == numeric_limits<base_unsigned>::max() branch
        bucket_size = _BRANGE // (range_ + 1)
        if _BRANGE % (range_ + 1) == range_:
            bucket_size += 1
        while True:
            r = stream.next() // bucket_size
            if r <= range_:
                return r
    while True:
        if range_ == _U64_MAX:
            limit = range_ // (_BRANGE + 1)
            if range_ % (_BRANGE + 1) == _BRANGE:
                limit += 1
        else:
            limit = (range_ + 1) // (_BRANGE + 1)
        result = 0
        mult = 1
        while mult <= limit:
            result = (result + stream.next() * mult) & _U64_MAX
            if (mult * _BRANGE) & _U64_MAX == (range_ - mult + 1) & _U64_MAX:
                return result
            mult = (mult * (_BRANGE + 1)) & _U64_MAX
        inc = _uniform_int(stream, range_ // mult)
        if _U64_MAX // mult < inc:
            continue
        inc = (inc * mult) & _U64_MAX
        result = (result + inc) & _U64_MAX
        if result < inc:
            continue
        if result > range_:
            continue
        return result


def _pa_calc_source(i: int, k: int, koffset: int) -> int:
    # preferential_attachment.hpp:113-123
    if i + 1 > koffset:
        return (i - koffset) // k + k + 1
    return int(np.floor(-0.5 + np.sqrt(0.25 + 2.0 * i) + 1.0))


def _pa_calc_target(i: int) -> int:
    # preferential_attachment.hpp:126-136 (only valid for i < koffset)
    tmp = -0.5 + np.sqrt(0.25 + 2.0 * i) + 1.0
    return int((tmp - np.floor(tmp)) * np.floor(tmp))


_PTR = 1 << 63


def preferential_attachment_exact(
    node_scale: int,
    edge_scale: int,
    beta: float,
    prob_rewire: float = 0.0,
    n_ranks: int = 1,
    base_seed: int = 5489,
    scramble: bool = True,
):
    """Bit-exact reference PA stream. Returns (src, dst) uint64 arrays in
    global edge-index order (the concatenation order of the reference's
    round-robin rank-local arrays, re-interleaved)."""
    n_nodes = 1 << node_scale
    m_edges = 1 << edge_scale
    k = m_edges // n_nodes
    if k < 1:
        raise ValueError("edge_scale must be >= node_scale")
    koffset = k * (k + 1) // 2
    alpha = (beta / k + 1.0) / (beta / k + 2.0)
    firsts = np.zeros(m_edges, dtype=np.uint64)
    seconds = np.zeros(m_edges, dtype=np.uint64)
    edges_per_rank = m_edges // n_ranks

    for r in range(n_ranks):
        stream = _Mt19937Stream(base_seed * r + r)
        for i_local in range(edges_per_rank):
            i = r + i_local * n_ranks
            first = _pa_calc_source(i, k, koffset)
            if i >= koffset:
                rand = _uniform_int(stream, i - 1) * 2
                if stream.uniform_01() > alpha:
                    rand += 1
                if rand % 2 == 0:
                    second = _pa_calc_source(rand // 2, k, koffset)
                else:
                    er = rand // 2
                    second = (
                        _pa_calc_target(er) if er < koffset else er | _PTR
                    )
            else:
                second = _pa_calc_target(i)
            firsts[i] = first
            seconds[i] = second

    # pointer resolution: the reference's MPI pointer-jumping rounds
    # (gen_...hpp:105-190) converge to the chase fixpoint; pointers always
    # reference strictly earlier edges, so this terminates
    while True:
        m = (seconds & np.uint64(_PTR)) != 0
        if not m.any():
            break
        seconds[m] = seconds[(seconds[m] & np.uint64(_PTR - 1)).astype(np.int64)]

    if prob_rewire > 0.0:
        for r in range(n_ranks):
            rng = _Mt19937Stream(base_seed + 3 * r)
            for i_local in range(edges_per_rank):
                i = r + i_local * n_ranks
                if rng.uniform_01() < prob_rewire:
                    # gcc evaluates the pair-constructor args right-to-left
                    # (gen_...hpp:204: EdgeType(rand_node(rng),
                    # rand_node(rng)); order is unspecified pre-C++17 — we
                    # match the reference's actual gcc builds)
                    second = _uniform_int(rng, n_nodes - 1)
                    firsts[i] = _uniform_int(rng, n_nodes - 1)
                    seconds[i] = second

    firsts %= np.uint64(n_nodes)
    seconds %= np.uint64(n_nodes)
    if scramble:
        firsts = hash_nbits(firsts, node_scale)
        seconds = hash_nbits(seconds, node_scale)
    return firsts, seconds


def preferential_attachment(
    num_vertices: int,
    edges_per_vertex: int = 4,
    seed: int = 5489,
    beta: float = 1.0,
    undirected: bool = True,
):
    """Sequential PA stream (the reference parallelizes this with a
    fix-up pass over unresolved slots; the sequential form is the same
    distribution)."""
    rng = np.random.RandomState(seed)
    k = edges_per_vertex
    m0 = k + 1  # seed clique size
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    # seed: clique over the first m0 vertices
    s0, d0 = np.triu_indices(m0, k=1)
    srcs.append(s0.astype(np.int64))
    dsts.append(d0.astype(np.int64))
    # flat endpoint pool for degree-proportional sampling
    pool = np.concatenate([s0, d0]).astype(np.int64).tolist()
    for v in range(m0, num_vertices):
        targets = []
        while len(targets) < k:
            if rng.rand() < beta and pool:
                t = pool[rng.randint(len(pool))]
            else:
                t = rng.randint(v)
            if t != v:
                targets.append(t)
        for t in targets:
            pool.append(v)
            pool.append(t)
        srcs.append(np.full(k, v, dtype=np.int64))
        dsts.append(np.array(targets, dtype=np.int64))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src, dst
