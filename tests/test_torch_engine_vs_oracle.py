"""The north-star contract on the port itself: the port's MatchEngine
(``device="cpu"``) against the port's own MatchOracle
(``fuzzypatternmatching_tpu_torch/engine/oracle.py``), on the cases of
tests/test_engine_vs_oracle.py, each on the bucketed engine, the flat
engine and the mesh engine on 2 CPU shards.

Both sides get the port's graphs, patterns and constraints, built with the
port's own modules from the same numpy arrays as the JAX test's. The
comparison is that test's: the convergence trace (itr, phase, step, active
vertices, active edges, messages), the found flags, the iterations, the
final active sets and the enumerated subgraphs. Every value is an integer
or a flag: exact equality. The oracle runs once per case.
"""

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.oracle import MatchOracle
from fuzzypatternmatching_tpu_torch.generators.rmat import RmatParams, generate_edges
from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
    NonLocalConstraint,
    load_nonlocal_constraints,
)
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

import test_oracle as jo
from test_engine_vs_oracle import selected_constraint as jax_selected_constraint
from test_engine_vs_oracle import tds_selected_constraint as jax_tds_selected_constraint
from test_engine_vs_oracle import uniform_path_nem as jax_uniform_path_nem
from test_pattern import write_tree_pattern
from test_torch_counting import port_constraint, port_pattern

ENGINES = ["bucketed", "flat", "sharded"]

EDGE_PATTERN = port_pattern(jo.EDGE_PATTERN)
PATH_PATTERN = port_pattern(jo.PATH_PATTERN)
TRI_PATTERN = port_pattern(jo.TRI_PATTERN)
UNI_PATTERN = port_pattern(jo.make_pattern([(0, 1), (1, 0)], [1, 1], diameter=2))
TRI456_PATTERN = port_pattern(jo.make_pattern(
    [(0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1)], [4, 5, 6], diameter=2
))


def cycle():
    return port_constraint(jo.cycle_constraint())


def path():
    return port_constraint(jo.path_constraint())


def tds():
    return port_constraint(jo.tds_constraint())


def selected():
    return port_constraint(jax_selected_constraint())


def uniform_nem():
    return port_constraint(jax_uniform_path_nem())


def tds_selected(**kw):
    return port_constraint(jax_tds_selected_constraint(**kw))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def graph_of(pairs, v):
    src, dst = jo.undirected(pairs)
    return from_edges(src, dst, num_vertices=v)


def random_graph(seed, v, e):
    rng = np.random.RandomState(seed)
    u = rng.randint(0, v, size=e)
    w = rng.randint(0, v, size=e)
    return from_edges(np.concatenate([u, w]), np.concatenate([w, u]), num_vertices=v)


def rmat_s11():
    parts = [
        generate_edges(RmatParams(seed=5489 + 3 * r, vertex_scale=11,
                                  edge_count=(16 << 11) // 4, scramble=False))
        for r in range(4)
    ]
    return from_edges(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        num_vertices=1 << 11,
    )


def tree_corpus(tmp_path):
    prefix = write_tree_pattern(tmp_path)
    return load_pattern_graph(prefix), load_nonlocal_constraints(prefix)


SQUARE = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _case(name, tmp_path):
    """(graph, labels, [(pattern, constraints), ...]) of a JAX test case."""
    lab = lambda *x: np.array(x, dtype=np.uint64)  # noqa: E731
    if name == "single_edge":
        return graph_of([(0, 1)], 2), lab(1, 2), [(EDGE_PATTERN, [])]
    if name == "pruning":
        return graph_of([(0, 1), (2, 3)], 4), lab(1, 2, 2, 9), [(EDGE_PATTERN, [])]
    if name == "cycle_triangle":
        return graph_of([(0, 1), (1, 2), (2, 0)], 3), lab(1, 2, 3), [(TRI_PATTERN, [cycle()])]
    if name == "cycle_fails_on_path":
        return graph_of([(0, 1), (1, 2)], 3), lab(1, 2, 3), [(TRI_PATTERN, [cycle()])]
    if name == "path_square":
        return graph_of(SQUARE, 4), lab(1, 2, 1, 2), [(PATH_PATTERN, [path()])]
    if name == "tds_square":
        return graph_of(SQUARE, 4), lab(1, 2, 1, 2), [(PATH_PATTERN, [tds()])]
    if name.startswith("random_tree_"):
        g = random_graph(int(name.rsplit("_", 1)[1]), 96, 400)
        return g, degree_labels(g), [tree_corpus(tmp_path)]
    if name.startswith("random_labels_"):
        seed = int(name.rsplit("_", 1)[1])
        g = random_graph(seed, 48, 160)
        labels = np.random.RandomState(seed + 100).randint(1, 4, size=48).astype(np.uint64)
        return g, labels, [(TRI_PATTERN, [cycle()]), (PATH_PATTERN, [path(), tds()])]
    if name == "rmat_s11_tree":
        g = rmat_s11()
        return g, degree_labels(g), [tree_corpus(tmp_path)]
    if name == "selected_validates":
        return graph_of(SQUARE, 4), lab(1, 2, 1, 2), [(PATH_PATTERN, [path(), selected()])]
    if name == "selected_prunes":
        return graph_of(SQUARE, 4), lab(1, 2, 1, 2), [(PATH_PATTERN, [selected()])]
    if name == "tds_selected_path":
        return graph_of(SQUARE, 4), lab(1, 1, 1, 1), [(UNI_PATTERN, [uniform_nem(), tds_selected()])]
    if name == "tds_selected_cycle":
        return graph_of([(0, 1), (1, 2), (2, 0)], 3), lab(1, 1, 1), [
            (UNI_PATTERN, [uniform_nem(), tds_selected(valid_cycle=True, cycle_length=2)])
        ]
    if name == "nonselected_tds_clears":
        return graph_of(SQUARE, 4), lab(1, 2, 1, 2), [(PATH_PATTERN, [path(), tds(), selected()])]
    if name.startswith("tds_selected_random_"):
        g = random_graph(int(name.rsplit("_", 1)[1]), 32, 96)
        return g, np.ones(32, dtype=np.uint64), [(UNI_PATTERN, [uniform_nem(), tds_selected()])]
    if name == "rmat_cyclic":
        g = rmat_s11()
        c = NonLocalConstraint(
            labels=lab(4, 5, 6, 4), indices=np.array([0, 1, 2, 0], dtype=np.int64),
            cycle_length=2, valid_cycle=True, interleave_lcc=True, selected_vertices=False,
        )
        return g, degree_labels(g), [(TRI456_PATTERN, [c])]
    raise KeyError(name)


CASES = (
    ["single_edge", "pruning", "cycle_triangle", "cycle_fails_on_path", "path_square",
     "tds_square"]
    + [f"random_tree_{s}" for s in range(5)]
    + ["random_labels_10", "random_labels_11", "rmat_s11_tree", "selected_validates",
       "selected_prunes", "tds_selected_path", "tds_selected_cycle",
       "nonselected_tds_clears"]
    + [f"tds_selected_random_{s}" for s in (20, 21, 22)]
    + ["rmat_cyclic"]
)

# what the JAX test asserts beyond the oracle's equality
EXTRA = {
    "selected_validates": lambda r: r.pattern_found == [True, True] and len(r.active_vertices) == 4,
    "selected_prunes": lambda r: r.pattern_found == [False] and r.active_vertices == {},
    "tds_selected_path": lambda r: r.pattern_found == [True, True] and len(r.subgraphs[1]) > 0,
    "tds_selected_cycle": lambda r: r.pattern_found[1] is False,
    "nonselected_tds_clears": lambda r: r.pattern_found[2] is False and r.active_vertices == {},
    "rmat_cyclic": lambda r: r.iterations >= 1,
}

_oracle_cache: dict = {}


def trace(r):
    return (
        [(x.itr, x.phase, x.step, x.active_vertices, x.active_edges, x.messages) for x in r.rows],
        r.pattern_found, r.iterations, r.active_vertices, r.active_edges,
        {k: sorted(v) for k, v in r.subgraphs.items()},
    )


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", CASES)
def test_engine_equals_oracle(case, engine, tmp_path):
    g, labels, runs = _case(case, tmp_path)
    for i, (pattern, constraints) in enumerate(runs):
        key = (case, i)
        if key not in _oracle_cache:
            _oracle_cache[key] = trace(MatchOracle(g, labels, pattern, constraints).run())
        kw = {"mesh": build_mesh(shards=2, device="cpu")} if engine == "sharded" else {}
        r = MatchEngine(
            g, labels, pattern, constraints, lcc_engine=engine, device="cpu", **kw
        ).run()
        got, want = trace(r), _oracle_cache[key]
        assert got[0] == want[0]  # rows, messages included
        assert got[1:] == want[1:]
        if case in EXTRA:
            assert EXTRA[case](r)
