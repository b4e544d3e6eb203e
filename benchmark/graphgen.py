"""The benchmark's graph: an R-MAT edge stream drawn on the device, its
vertex ids permuted by the run's seed, and the CSR built there by sort.

The stream follows the upstream generator's distribution
(rmat_edge_generator.hpp:218-261, generate_rmat.cpp:202-205): per edge and
level one uniform picks the quadrant from (a, b, c, d), four more scale
a, b, c and d by 0.9 + 0.2 U(0, 1) before they are renormalised with d
taking the rounding slack; each edge goes into the stream in both
directions. The draws come from a fixed generator seed (the configuration's
``stream_seed``), so every run draws the same multiset of edges; ``--seed``
only draws a permutation of the vertex ids (a Graph500-style scramble).
Every seed therefore gives an isomorphic graph: the same work under new ids.

The CSR has the fields and dtypes of the port's ``graph.csr.from_edges``:
duplicates counted in ``raw_degree`` and removed from ``cols``, rows sorted,
``rev_edge`` the index of each edge's reverse.
"""

from __future__ import annotations

import numpy as np
import torch

# edges drawn per block: a fixed constant, so the stream does not depend on
# the memory at hand
BLOCK_EDGES = 1 << 23


def rmat_stream(gen: dict, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(u, v) int64 of the ``edge_factor << scale`` generated edges."""
    scale = int(gen["scale"])
    n = int(gen["edge_factor"]) << scale
    a, b, c, d = (float(gen[k]) for k in ("a", "b", "c", "d"))
    g = torch.Generator(device=device)
    g.manual_seed(int(gen["stream_seed"]))
    us, vs = [], []
    for lo in range(0, n, BLOCK_EDGES):
        m = min(BLOCK_EDGES, n - lo)
        u = torch.zeros(m, dtype=torch.int64, device=device)
        v = torch.zeros(m, dtype=torch.int64, device=device)
        ra = torch.full((m,), a, dtype=torch.float64, device=device)
        rb = torch.full((m,), b, dtype=torch.float64, device=device)
        rc = torch.full((m,), c, dtype=torch.float64, device=device)
        rd = torch.full((m,), d, dtype=torch.float64, device=device)
        for j in range(scale):
            p, n1, n2, n3, n4 = torch.rand(
                (5, m), generator=g, dtype=torch.float64, device=device
            )
            ab = ra + rb
            abc = ab + rc
            right = ((p >= ra) & (p < ab)) | (p >= abc)
            down = p >= ab
            step = 1 << (scale - 1 - j)
            v += right.to(torch.int64) * step
            u += down.to(torch.int64) * step
            ra = ra * (0.9 + 0.2 * n1)
            rb = rb * (0.9 + 0.2 * n2)
            rc = rc * (0.9 + 0.2 * n3)
            rd = rd * (0.9 + 0.2 * n4)
            s = ra + rb + rc + rd
            ra, rb, rc = ra / s, rb / s, rc / s
            rd = 1.0 - ra - rb - rc
        us.append(u)
        vs.append(v)
    return torch.cat(us), torch.cat(vs)


def csr_from_stream(
    src: torch.Tensor, dst: torch.Tensor, num_vertices: int
) -> dict[str, torch.Tensor]:
    """The CSR of a directed stream (duplicates allowed), built by sort on
    the stream's device."""
    V = num_vertices
    raw_degree = torch.bincount(src, minlength=V)
    ukey = torch.unique(src * V + dst)  # sorted
    usrc = torch.div(ukey, V, rounding_mode="floor")
    udst = ukey - usrc * V
    row_ptr = torch.zeros(V + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(usrc, minlength=V), 0, out=row_ptr[1:])
    rkey = udst * V + usrc
    pos = torch.searchsorted(ukey, rkey).clamp_(max=max(len(ukey) - 1, 0))
    rev = torch.where(ukey[pos] == rkey, pos, torch.full_like(pos, -1))
    return {
        "row_ptr": row_ptr, "cols": udst, "rev_edge": rev,
        "raw_degree": raw_degree, "edge_row": usrc,
    }


def permuted_stream(gen: dict, seed: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The undirected stream (both directions) under the permutation of the
    vertex ids that ``seed`` draws."""
    u, v = rmat_stream(gen, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    perm = torch.randperm(1 << int(gen["scale"]), generator=g, device=device)
    u, v = perm[u], perm[v]
    return torch.cat([u, v]), torch.cat([v, u])


def build_graph(gen: dict, seed: int, device: torch.device) -> dict[str, np.ndarray]:
    """The configuration's graph under the permutation that ``seed`` draws:
    CSR fields as host int64 arrays, and ``labels``, the degree labels
    ``ceil(log2(raw_degree + 1))`` as uint64."""
    V = 1 << int(gen["scale"])
    src, dst = permuted_stream(gen, seed, device)
    csr = csr_from_stream(src, dst, V)
    del src, dst
    out = {k: t.cpu().numpy() for k, t in csr.items()}
    out["num_vertices"] = V
    out["labels"] = np.ceil(
        np.log2(out["raw_degree"].astype(np.float64) + 1.0)
    ).astype(np.uint64)
    return out
