"""Counting-LCC on the port (fuzzypatternmatching_tpu_torch) on the CPU,
against the JAX package: the mirror of tests/test_counting.py for the
port's flat and bucketed engines.

* the requirement table of the port's PatternGraph;
* the single-class-instance prune;
* random graphs (seeds 0, 1, 4) against the JAX ``MatchOracle`` with
  ``counting=True`` and the JAX ``MatchEngine``; counting with edge
  metadata against the oracle; the golden tree_s13 graph in every NLCC
  placement, compact on and off;
* one superstep at a time from a JAX engine's state (``state_from_jax``) on
  R-MAT s10 with split hubs and 4 ranks: tv, alive and the per-rank
  counters after each superstep.

The comparison covers every PhaseRow (itr, phase, step, av, ae, messages
and the per-rank counters), ``pattern_found``, the iterations, the active
sets and the subgraphs. Every value is an integer or a flag: exact
equality. The JAX engines get the JAX package's graphs and patterns, the
port its own, built from the same numpy arrays.
"""

import os
import sys
import tempfile

import numpy as np
import pytest

from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.engine.lcc import LccEngine as JaxLccEngine
from fuzzypatternmatching_tpu.engine.lcc_bucketed import (
    BucketedLccEngine as JaxBucketedEngine,
)
from fuzzypatternmatching_tpu.engine.oracle import MatchOracle
from fuzzypatternmatching_tpu.graph.csr import degree_labels
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu.pattern.pattern_graph import PatternGraph as JaxPatternGraph
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.lcc import LccEngine
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.graph import csr
from fuzzypatternmatching_tpu_torch.pattern import builtin
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
    NonLocalConstraint,
)
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import PatternGraph

from test_engine_vs_oracle import _random_graph
from test_oracle import PATH_PATTERN, path_constraint, undirected
from test_torch_lcc_bucketed import _rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_golden import build_config as jax_build_config  # noqa: E402

ENGINES = ["flat", "bucketed"]


# ------------------------------------------------------------ converters


def port_graph(gj) -> csr.Graph:
    """The port's Graph holding the arrays of a JAX package Graph."""
    return csr.Graph(
        gj.num_vertices, gj.row_ptr.copy(), gj.cols.copy(), gj.rev_edge.copy(),
        gj.raw_degree.copy(), gj.edge_row.copy(),
    )


def port_pattern(pj) -> PatternGraph:
    return PatternGraph(
        vertex_count=pj.vertex_count, edge_count=pj.edge_count,
        row_ptr=pj.row_ptr.copy(), cols=pj.cols.copy(),
        vertex_data=pj.vertex_data.copy(), diameter=pj.diameter,
        edges_bitset=pj.edges_bitset.copy(),
        edges_bitset_optional=pj.edges_bitset_optional.copy(),
        edges_bitset_all=pj.edges_bitset_all.copy(),
        min_optional_edge_count=pj.min_optional_edge_count.copy(),
        edge_data=None if pj.edge_data is None else pj.edge_data.copy(),
    )


def port_constraint(cj) -> NonLocalConstraint:
    return NonLocalConstraint(
        labels=cj.labels.copy(), indices=cj.indices.copy(),
        cycle_length=cj.cycle_length, valid_cycle=cj.valid_cycle,
        interleave_lcc=cj.interleave_lcc,
        selected_vertices=cj.selected_vertices,
        enumeration=cj.enumeration.copy(), aggregation=cj.aggregation.copy(),
        is_tds=cj.is_tds,
    )


def run_port(gj, labels, pj, cjs, **kw):
    """The port's MatchEngine on the CPU over the JAX objects' arrays."""
    return MatchEngine(
        port_graph(gj), labels, port_pattern(pj),
        [port_constraint(c) for c in cjs], device="cpu", **kw,
    ).run()


def rows(result, per_rank=True):
    return [
        (r.itr, r.phase, r.step, r.active_vertices, r.active_edges, r.messages)
        + (
            ({k: np.asarray(x).tolist() for k, x in (r.per_rank or {}).items()},)
            if per_rank else ()
        )
        for r in result.rows
    ]


def results_equal(a, b, per_rank=True):
    """Every PhaseRow (the per-rank counters unless the reference has none),
    the found flags, iterations, active sets and subgraphs."""
    assert rows(a, per_rank) == rows(b, per_rank)
    assert a.pattern_found == b.pattern_found
    assert a.iterations == b.iterations
    assert a.active_vertices == b.active_vertices
    assert a.active_edges == b.active_edges
    assert {k: sorted(v) for k, v in a.subgraphs.items()} == {
        k: sorted(v) for k, v in b.subgraphs.items()
    }


def _path_121(cls=PatternGraph):
    """Template 0-1-2 with labels 1-2-1: the middle vertex needs TWO
    distinct label-1 neighbors under counting, one class under base."""
    return cls(
        vertex_count=3,
        edge_count=4,
        row_ptr=np.array([0, 1, 3, 4]),
        cols=np.array([1, 0, 2, 1]),
        vertex_data=np.array([1, 2, 1], dtype=np.uint64),
        diameter=2,
    )


# ------------------------------------------------------------------ tests


def test_neighbor_label_counts_table():
    classes, req = _path_121().neighbor_label_counts()
    assert list(classes) == [1, 2]
    assert req[1, 0] == 2 and req[1, 1] == 0
    assert req[0, 1] == 1 and req[2, 1] == 1
    classes_j, req_j = _path_121(JaxPatternGraph).neighbor_label_counts()
    assert np.array_equal(classes, classes_j) and np.array_equal(req, req_j)


@pytest.mark.parametrize("engine", ENGINES)
def test_counting_prunes_single_class_instance(engine):
    # path a(1)-b(2): base LCC keeps b (heard class 1); counting kills it
    # (needs 2 distinct label-1 neighbors), which then kills a too
    src, dst = undirected([(0, 1)])
    g = csr.from_edges(src, dst, num_vertices=2)
    labels = np.array([1, 2], dtype=np.uint64)
    pat = _path_121()
    kw = dict(lcc_engine=engine, device="cpu")
    base = MatchEngine(g, labels, pat, [], **kw).run()
    cnt = MatchEngine(g, labels, pat, [], counting=True, **kw).run()
    assert len(base.active_vertices) == 2
    assert len(cnt.active_vertices) == 0

    # a(1)-b(2)-c(1): both modes keep everything
    src, dst = undirected([(0, 1), (1, 2)])
    g3 = csr.from_edges(src, dst, num_vertices=3)
    labels3 = np.array([1, 2, 1], dtype=np.uint64)
    cnt3 = MatchEngine(g3, labels3, pat, [], counting=True, **kw).run()
    assert len(cnt3.active_vertices) == 3


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_counting_engine_matches_counting_oracle(seed, engine):
    gj = _random_graph(seed, v=48, e=200)
    rng = np.random.RandomState(seed + 3)
    labels = rng.randint(1, 3, size=48).astype(np.uint64)
    cs = [path_constraint()]
    o = MatchOracle(gj, labels, PATH_PATTERN, cs, counting=True).run()
    kw = dict(lcc_engine=engine, num_ranks=2, nlcc_mode="host")
    e = run_port(gj, labels, PATH_PATTERN, cs, counting=True, **kw)
    results_equal(e, o, per_rank=False)
    ej = JaxMatchEngine(gj, labels, PATH_PATTERN, cs, counting=True, **kw).run()
    results_equal(e, ej)
    # and counting must prune at least as hard as base mode
    b = run_port(gj, labels, PATH_PATTERN, cs, lcc_engine=engine)
    assert set(e.active_vertices) <= set(b.active_vertices)


@pytest.mark.parametrize("engine", ENGINES)
def test_counting_with_metadata_matches_oracle(engine):
    """Counting composed with edge-metadata constraints (the acc_i gate is
    the per-(p, i, value) allow mask)."""
    from test_edge_metadata import graph_meta, meta_pattern

    src, dst = undirected([(0, 1), (1, 2), (1, 3), (3, 4)])
    gj = jax_from_edges(src, dst, num_vertices=5)
    labels = np.array([1, 2, 1, 1, 2], dtype=np.uint64)
    pat = meta_pattern(
        [(0, 1), (1, 0), (1, 2), (2, 1)], [1, 2, 1], [5, 5, 5, 5], diameter=2
    )
    ed = graph_meta(gj, {(0, 1): 5, (1, 2): 5, (1, 3): 6, (3, 4): 5})
    o = MatchOracle(gj, labels, pat, [], counting=True, edge_data=ed).run()
    for compact in (True, False):
        e = run_port(gj, labels, pat, [], lcc_engine=engine, counting=True,
                     edge_data=ed, compact=compact)
        results_equal(e, o, per_rank=False)
    assert len(e.active_vertices) > 0


@pytest.fixture(scope="module")
def tree_s13_counting():
    """The golden tree_s13 configuration (the port's, and the JAX
    package's from tools/make_golden.py) and the JAX engine's counting
    result."""
    corpus = os.path.join(REPO, "examples", "patterns", "0", "pattern")
    g, labels, pattern, constraints = golden.build_config(13, corpus)
    gj, labels_j, pj, cjs = jax_build_config(13, corpus)
    rj = JaxMatchEngine(gj, labels_j, pj, cjs, num_ranks=4, counting=True).run()
    return g, labels, pattern, constraints, rj


@pytest.mark.parametrize("mode", ["auto", "device", "host"])
@pytest.mark.parametrize(
    "engine, compact",
    [("bucketed", True), ("bucketed", False), ("flat", False)],
    ids=["bucketed-compact", "bucketed-full", "flat"],
)
def test_counting_tree_s13_every_placement(tree_s13_counting, engine, compact, mode):
    g, labels, pattern, constraints, rj = tree_s13_counting
    r = MatchEngine(
        g, labels, pattern, constraints, num_ranks=4, lcc_engine=engine,
        nlcc_mode=mode, nlcc_device_min=1 << 10, counting=True,
        compact=compact, device="cpu",
    ).run()
    results_equal(r, rj)
    assert r.traversed_edges == rj.traversed_edges
    assert (len(r.active_vertices), len(r.active_edges)) == (12, 22)


# ------------------------------------------------- superstep by superstep


@pytest.fixture(scope="module")
def rmat_s10():
    src, dst = _rmat_edges(10)
    gj = jax_from_edges(src, dst, num_vertices=1 << 10)
    with tempfile.TemporaryDirectory() as tmp:
        pj, _ = jax_builtin.load_tree_pattern(tmp)
        pt, _ = builtin.load_tree_pattern(tmp + "/port")
    return gj, degree_labels(gj), pj, pt


def superstep_pairs(rmat, kind, **kw):
    """(JAX engine, port engine) over the same s10 graph and tree pattern:
    bucketed with split hubs (max_width 16) or flat; 4 ranks."""
    gj, labels, pj, pt = rmat
    if kind == "bucketed":
        jx = JaxBucketedEngine(gj, labels, pj, num_ranks=4, max_width=16, **kw)
        po = BucketedLccEngine(
            port_graph(gj), labels, pt, device="cpu", num_ranks=4, max_width=16, **kw
        )
        assert any(len(b.seg_rows) != len(b.rows) for b in po.buckets)
    else:
        jx = JaxLccEngine(gj, labels, pj, num_ranks=4, **kw)
        po = LccEngine(port_graph(gj), labels, pt, num_ranks=4, device="cpu", **kw)
    return jx, po


def assert_supersteps_from_jax(jx, po, steps=6):
    """The global init superstep on both engines, then ``steps`` supersteps
    one at a time, each continuing the JAX engine's state in the port
    through ``state_from_jax`` (with a token-passing mark on every 5th
    alive edge): equal tv, alive and per-rank counters after each. Returns
    the number of supersteps in which a vertex died."""
    st_j, rows_j, died_j = jx.lcc_call(jx.init_state(), True, n_steps=1)
    st_p, rows_p, died_p = po.lcc_call(po.init_state(), True, n_steps=1)
    died = 0
    for step in range(steps + 1):
        assert [r[:3] for r in rows_j] == [r[:3] for r in rows_p], step
        for key in ("av", "ae", "msg"):
            assert np.array_equal(rows_j[0][3][key], rows_p[0][3][key]), (step, key)
        assert died_j == died_p, step
        tv, alive = (np.asarray(x) for x in jx.state_to_global(st_j))
        tv_p, alive_p = po.state_to_global(st_p)
        assert np.array_equal(tv, tv_p), step
        assert np.array_equal(alive, alive_p), step
        died += int(died_j)
        if step == steps:
            break
        flag = np.zeros_like(alive)
        flag[np.nonzero(alive)[0][::5]] = True
        st_j = jx.state_from_global(tv, alive, flag)
        # the JAX state's own arrays: slot order (bucketed) or edge order
        arrays = (st_j.tv, getattr(st_j, "alive", None), st_j.tp_flag)
        if arrays[1] is None:
            arrays = (st_j.tv, st_j.edge_alive, st_j.tp_flag)
        st_p = po.state_from_jax(*(np.asarray(a) for a in arrays))
        st_j, rows_j, died_j = jx.lcc_call(st_j, False, n_steps=1)
        st_p, rows_p, died_p = po.lcc_call(st_p, False, n_steps=1)
    return died


@pytest.mark.parametrize("kind", ["bucketed", "flat"])
def test_counting_supersteps_from_jax_state(rmat_s10, kind):
    jx, po = superstep_pairs(rmat_s10, kind, counting=True)
    assert assert_supersteps_from_jax(jx, po) > 0
