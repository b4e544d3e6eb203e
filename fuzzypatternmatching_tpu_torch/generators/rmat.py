"""Bit-exact, vectorized R-MAT edge stream.

Reproduces the reference generator stream exactly
(reference: include/havoqgt/rmat_edge_generator.hpp:218-261 and
src/generate_rmat.cpp:202-205):

* per-rank boost::mt19937 seeded with ``5489 + 3*rank``,
* boost::uniform_01 over mt19937, which is ``draw / 2**32`` in float64,
* per edge: ``scale`` levels, each consuming exactly 5 draws
  (quadrant pick + 4 noise perturbations of a/b/c/d),
* optional low-``scale``-bit scramble via ``hash_nbits``,
* undirected output emits each generated edge in both directions,
  interleaved: (u0,v0),(v0,u0),(u1,v1),...

``numpy.random.RandomState(seed).randint(0, 2**32, dtype=uint32)`` produces
the identical mt19937 output stream (init_genrand seeding), verified against
the canonical mt19937 test vectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.hashing import hash_nbits

_INV_2_32 = float(2.0**-32)


@dataclass(frozen=True)
class RmatParams:
    """Parameters matching rmat_edge_generator's constructor."""

    seed: int
    vertex_scale: int
    edge_count: int  # number of *generated* edges (pre-symmetrization)
    a: float = 0.57
    b: float = 0.19
    c: float = 0.19
    d: float = 0.05
    scramble: bool = True
    undirected: bool = True

    @property
    def max_vertex_id(self) -> int:
        return (1 << self.vertex_scale) - 1


def _generate_block(params: RmatParams, draws: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run the quadrant walk for a block of edges.

    ``draws`` has shape (n_edges, scale, 5) of uint32: the mt19937 outputs in
    consumption order (rmat_edge_generator.hpp:218-254).
    """
    n = draws.shape[0]
    scale = params.vertex_scale
    u = np.zeros(n, dtype=np.uint64)
    v = np.zeros(n, dtype=np.uint64)
    ra = np.full(n, params.a, dtype=np.float64)
    rb = np.full(n, params.b, dtype=np.float64)
    rc = np.full(n, params.c, dtype=np.float64)
    rd = np.full(n, params.d, dtype=np.float64)
    step = np.uint64(1 << (scale - 1))
    for j in range(scale):
        p = draws[:, j, 0].astype(np.float64) * _INV_2_32
        ab = ra + rb
        abc = ab + rc
        in_b = (p >= ra) & (p < ab)
        in_c = (p >= ab) & (p < abc)
        in_d = p >= abc
        v += np.where(in_b | in_d, step, np.uint64(0))
        u += np.where(in_c | in_d, step, np.uint64(0))
        step >>= np.uint64(1)
        # noise perturbation: each value scaled by 0.9 + 0.2*U(0,1), then
        # renormalized with d absorbing the rounding slack
        ra = ra * (0.9 + 0.2 * (draws[:, j, 1].astype(np.float64) * _INV_2_32))
        rb = rb * (0.9 + 0.2 * (draws[:, j, 2].astype(np.float64) * _INV_2_32))
        rc = rc * (0.9 + 0.2 * (draws[:, j, 3].astype(np.float64) * _INV_2_32))
        rd = rd * (0.9 + 0.2 * (draws[:, j, 4].astype(np.float64) * _INV_2_32))
        s = ra + rb + rc + rd
        ra = ra / s
        rb = rb / s
        rc = rc / s
        rd = 1.0 - ra - rb - rc
    if params.scramble:
        u = hash_nbits(u, scale)
        v = hash_nbits(v, scale)
    return u, v


def generate_edges(params: RmatParams, chunk_edges: int = 1 << 20) -> tuple[np.ndarray, np.ndarray]:
    """Generate the full directed edge stream for one rank.

    Returns (src, dst) uint64 arrays. With ``undirected=True`` the length is
    ``2*edge_count`` with both directions interleaved in reference stream
    order (rmat_edge_generator.hpp:127-138).
    """
    rs = np.random.RandomState(params.seed)
    us, vs = [], []
    remaining = params.edge_count
    while remaining > 0:
        n = min(remaining, chunk_edges)
        draws = rs.randint(0, 2**32, size=(n, params.vertex_scale, 5), dtype=np.uint32)
        u, v = _generate_block(params, draws)
        us.append(u)
        vs.append(v)
        remaining -= n
    u = np.concatenate(us) if len(us) != 1 else us[0]
    v = np.concatenate(vs) if len(vs) != 1 else vs[0]
    if not params.undirected:
        return u, v
    src = np.empty(2 * u.size, dtype=np.uint64)
    dst = np.empty(2 * u.size, dtype=np.uint64)
    src[0::2] = u
    src[1::2] = v
    dst[0::2] = v
    dst[1::2] = u
    return src, dst


def rmat_all_ranks(
    scale: int,
    n_ranks: int,
    edges_per_vertex: int = 16,
    scramble: bool = True,
    undirected: bool = True,
    base_seed: int = 5489,
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """The full multi-rank stream of generate_rmat.cpp:202-205.

    edges/rank = ``edges_per_vertex * 2**scale / n_ranks``; rank r seeds with
    ``base_seed + 3*r``. Returns concatenated (src, dst). Uses the native
    C++ generator when available (bit-identical stream).
    """
    if use_native:
        from .. import native

        if native.available():
            return native.rmat_all_ranks_native(
                scale=scale,
                n_ranks=n_ranks,
                edges_per_vertex=edges_per_vertex,
                scramble=scramble,
                undirected=undirected,
                base_seed=base_seed,
            )
    per_rank = (edges_per_vertex << scale) // n_ranks
    parts = [
        generate_edges(
            RmatParams(
                seed=base_seed + 3 * r,
                vertex_scale=scale,
                edge_count=per_rank,
                scramble=scramble,
                undirected=undirected,
            )
        )
        for r in range(n_ranks)
    ]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    return src, dst
