"""The port's classic algorithms (fuzzypatternmatching_tpu_torch/algorithms/
frontier.py, on the CPU) against the JAX package's on the same graphs: the
3x5 grid and the disconnected graphs of tests/test_algorithms.py, K4, the
two-triangle graph, the three random graphs of
test_triangle_count_random_vs_bruteforce, a random graph of mostly one-way
edges (no reverse edge: SSSP falls back to the slot's own weight), and
R-MAT s10 (4 ranks, unscrambled, with isolated vertices; weights from
default_rng(7)).

BFS levels and parents, components, k-cores, SSSP distances and triangle
counts are held exactly (float32 distances bit for bit, NaN-aware);
PageRank with rtol=1e-5, atol=1e-6, since its float32 sums run in another
order. The port builds its own Graph from the same edge stream."""

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu.algorithms import frontier as jax_frontier
from fuzzypatternmatching_tpu.generators.rmat import RmatParams, generate_edges
from fuzzypatternmatching_tpu.graph import csr as jax_csr
from fuzzypatternmatching_tpu_torch.algorithms import frontier
from fuzzypatternmatching_tpu_torch.graph import csr


def _undirected(pairs):
    src = [u for u, v in pairs] + [v for u, v in pairs]
    dst = [v for u, v in pairs] + [u for u, v in pairs]
    return np.array(src), np.array(dst)


def _random_pairs(seed, v=40, draws=150):
    rng = np.random.RandomState(seed)
    pairs = set()
    for _ in range(draws):
        a, b = rng.randint(0, v, 2)
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    return sorted(pairs)


def _rmat_s10():
    parts = [
        generate_edges(RmatParams(seed=5489 + 3 * r, vertex_scale=10,
                                  edge_count=(16 << 10) // 4, scramble=False))
        for r in range(4)
    ]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), 1 << 10)


def _edges(name):
    """(src, dst, V) of each test graph."""
    if name == "grid_3x5":
        return (*jax_csr.grid_graph(3, 5), 15)
    if name == "disconnected":
        return (*_undirected([(0, 1), (2, 3)]), 4)
    if name == "components_self_loop":
        return (*_undirected([(0, 1), (1, 2), (3, 4), (5, 5)]), 7)
    if name == "two_triangles":
        return (*_undirected([(0, 1), (1, 2), (2, 0), (2, 3), (3, 4), (4, 2)]), 5)
    if name == "k4":
        return (*_undirected([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]), 4)
    if name == "one_way_edges":
        # a directed stream: most edges have no reverse (rev_edge -1)
        pairs = _random_pairs(5, draws=90)
        src, dst = _undirected(pairs[:10])
        return (np.concatenate([src, [a for a, _ in pairs[10:]]]),
                np.concatenate([dst, [b for _, b in pairs[10:]]]), 40)
    if name.startswith("random_"):
        return (*_undirected(_random_pairs(int(name[-1]))), 40)
    assert name == "rmat_s10"
    return _rmat_s10()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These graphs are tiny: on the CPU, torch's thread pool costs more
    than the work (repeat_interleave takes ~9 ms a call on 8 threads and
    ~0.01 ms on one, which the 1,117 chunks of rmat_s10 at wedge_chunk=97
    feel)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAPHS = ["grid_3x5", "disconnected", "components_self_loop", "two_triangles",
          "k4", "random_0", "random_1", "random_2", "one_way_edges", "rmat_s10"]


@pytest.fixture(scope="module", params=GRAPHS)
def graphs(request):
    """(port Graph, JAX Graph, per-edge weights) of one test graph."""
    src, dst, v = _edges(request.param)
    g = csr.from_edges(src, dst, num_vertices=v)
    gj = jax_csr.from_edges(src, dst, num_vertices=v)
    assert np.array_equal(g.cols, gj.cols) and np.array_equal(g.row_ptr, gj.row_ptr)
    w = np.random.default_rng(7).random(g.num_edges).astype(np.float32)
    return g, gj, w


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")


def test_bfs_equals_jax(graphs):
    g, gj, _ = graphs
    for source in (0, g.num_vertices - 1):
        level, parent = frontier.breadth_first_search(g, source, device="cpu")
        want_level, want_parent = jax_frontier.breadth_first_search(gj, source)
        _same(level, want_level)
        _same(parent, want_parent)
    assert frontier.last_stats["bfs"]["iterations"] >= 1


def test_connected_components_equal_jax(graphs):
    g, gj, _ = graphs
    _same(frontier.connected_components(g, device="cpu"),
          jax_frontier.connected_components(gj))


@pytest.mark.parametrize("k", [2, 4])
def test_kth_core_equals_jax(graphs, k):
    g, gj, _ = graphs
    _same(frontier.kth_core(g, k, device="cpu"), jax_frontier.kth_core(gj, k))


def test_pagerank_close_to_jax(graphs):
    g, gj, _ = graphs
    got = frontier.pagerank(g, device="cpu")
    want = jax_frontier.pagerank(gj)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    got = frontier.pagerank(g, 0.5, 7, device="cpu")
    np.testing.assert_allclose(got, jax_frontier.pagerank(gj, 0.5, 7), rtol=1e-5, atol=1e-6)


def test_sssp_equals_jax(graphs):
    g, gj, w = graphs
    for weights in (w, np.ones(g.num_edges)):
        _same(frontier.sssp(g, 0, weights, device="cpu"),
              jax_frontier.sssp(gj, 0, weights))


def test_triangle_count_equals_jax(graphs):
    g, gj, _ = graphs
    want = jax_frontier.triangle_count(gj)
    assert frontier.triangle_count(g, device="cpu") == want
    assert frontier.triangle_count(g, wedge_chunk=97, device="cpu") == want
    stats = frontier.last_stats["triangles"]
    assert stats["chunks"] == -(-stats["wedges"] // 97)


@pytest.mark.parametrize("chunk", [1, 7, 54, 1000])
def test_triangle_chunks_split_inside_a_row(chunk):
    """Chunks that start and end inside a slot's wedges: in K12 every
    vertex has degree 11, so vertex 0's oriented row holds all 11 others
    (55 wedges, its first slot 10 of them); C(12, 3) = 220 triangles."""
    src, dst = _undirected([(a, b) for a in range(12) for b in range(a + 1, 12)])
    g = csr.from_edges(src, dst, num_vertices=12)
    gj = jax_csr.from_edges(src, dst, num_vertices=12)
    assert jax_frontier.triangle_count(gj) == 220
    assert frontier.triangle_count(g, wedge_chunk=chunk, device="cpu") == 220
    stats = frontier.last_stats["triangles"]
    assert stats["wedges"] == 220 and stats["chunks"] == -(-220 // chunk)


def test_empty_graph():
    g = csr.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), num_vertices=3)
    level, parent = frontier.breadth_first_search(g, 1, device="cpu")
    assert level.tolist() == [2**31 - 1, 0, 2**31 - 1] and parent.tolist() == [-1, 1, -1]
    assert frontier.triangle_count(g, device="cpu") == 0
    assert frontier.connected_components(g, device="cpu").tolist() == [0, 1, 2]
    with pytest.raises(ValueError):
        frontier.triangle_count(g, wedge_chunk=0, device="cpu")


def test_default_device_is_the_card():
    """Every algorithm runs on the card unless the CPU is asked for, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, dst, v = _edges("k4")
    g = csr.from_edges(src, dst, num_vertices=v)
    for call in (
        lambda: frontier.breadth_first_search(g, 0),
        lambda: frontier.connected_components(g),
        lambda: frontier.pagerank(g),
        lambda: frontier.kth_core(g, 2),
        lambda: frontier.sssp(g, 0, np.ones(g.num_edges)),
        lambda: frontier.triangle_count(g),
    ):
        with pytest.raises(RuntimeError):
            call()
