"""The torch BucketedLccEngine against the JAX BucketedLccEngine on the CPU,
both in its default mode and with its Pallas superstep in interpret mode:
same slot layout, same per-superstep rows (with per-rank counters), same
died flag, same tv and alive sets — all integers, compared exactly. Each
engine gets its own package's Graph and PatternGraph, built from the same
numpy edges and pattern files."""

import dataclasses

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu.engine.lcc_bucketed import (
    BucketedLccEngine as JaxEngine,
)
from fuzzypatternmatching_tpu.generators.rmat import RmatParams, generate_edges
from fuzzypatternmatching_tpu.graph.csr import degree_labels
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.pattern.pattern_graph import (
    load_pattern_graph as jax_load_pattern_graph,
)
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import (
    BucketedLccEngine,
)
from fuzzypatternmatching_tpu_torch.engine.result import stats_rows
from fuzzypatternmatching_tpu_torch.graph.csr import Graph, from_edges
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import (
    PatternGraph,
    load_pattern_graph,
)

from test_fuzzy import write_fuzzy_pattern
from test_pattern import write_tree_pattern

JAX_MODES = {
    "xla": {},
    "pallas": {"use_pallas": True, "pallas_interpret": True},
}
CONFIGS = {
    "s10": {"num_ranks": 1},
    "split_hubs": {"num_ranks": 1, "max_width": 16},
    "ranks4": {"num_ranks": 4},
}


def _rmat_edges(scale):
    """tests/test_bucketed.py recipe: 4-rank unscrambled R-MAT stream."""
    parts = [
        generate_edges(
            RmatParams(seed=5489 + 3 * r, vertex_scale=scale,
                       edge_count=(16 << scale) // 4, scramble=False)
        )
        for r in range(4)
    ]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    return src, dst


@pytest.fixture(scope="module")
def graph():
    """(JAX graph, labels, port graph) from the same numpy edges."""
    src, dst = _rmat_edges(10)
    g = jax_from_edges(src, dst, num_vertices=1 << 10)
    gt = from_edges(src, dst, num_vertices=1 << 10)
    assert isinstance(gt, Graph)
    return g, degree_labels(g), gt


def _patterns(prefix):
    """(JAX pattern, port pattern) from the same files."""
    pt = load_pattern_graph(prefix)
    assert isinstance(pt, PatternGraph)
    return jax_load_pattern_graph(prefix), pt


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _patterns(write_tree_pattern(tmp_path_factory.mktemp("t")))


def _engines(graph, patterns, jax_mode="xla", **kw):
    g, labels, gt = graph
    jx = JaxEngine(g, labels, patterns[0], **JAX_MODES[jax_mode], **kw)
    pt = BucketedLccEngine(gt, labels, patterns[1], device="cpu", **kw)
    return jx, pt


def _same_rows(rows_j, rows_t):
    assert [r[:3] for r in rows_j] == [r[:3] for r in rows_t]
    for rj, rt in zip(rows_j, rows_t):
        for key in ("av", "ae", "msg"):
            assert np.array_equal(rj[3][key], rt[3][key])


def _same_state(jx, st_j, pt, st_t):
    tv_j, al_j = jx.state_to_global(st_j)
    tv_t, al_t = pt.state_to_global(st_t)
    assert tv_t.dtype == np.uint32
    assert np.array_equal(np.asarray(tv_j), tv_t)
    assert np.array_equal(np.asarray(al_j), al_t)
    for a, b in zip(jx.alive_pairs(st_j), pt.alive_pairs(st_t)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_slot_layout_matches_jax(graph, tree, config):
    jx, pt = _engines(graph, tree, **CONFIGS[config])
    assert pt.num_slots == jx.num_slots
    assert np.array_equal(pt._edge_to_slot, jx._edge_to_slot)
    assert len(pt.buckets) == len(jx.buckets)
    for bt, bj in zip(pt.buckets, jx.buckets):
        assert bt.slot_base == bj.slot_base
        assert np.array_equal(bt.adj, bj.adj)
        assert np.array_equal(bt.rev, bj.rev)
        assert np.array_equal(bt.seg_id, bj.seg_id)
    if config == "split_hubs":
        assert any(len(b.seg_rows) != len(b.rows) for b in pt.buckets)


@pytest.mark.parametrize("jax_mode", sorted(JAX_MODES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_init_and_continuation_match_jax(graph, tree, config, jax_mode):
    jx, pt = _engines(graph, tree, jax_mode, **CONFIGS[config])
    st_j, rows_j, died_j = jx.lcc_call(jx.init_state(), True)
    st_t, rows_t, died_t = pt.lcc_call(pt.init_state(), True)
    assert len(rows_t) == tree[1].diameter
    _same_rows(rows_j, rows_t)
    assert died_j == died_t
    _same_state(jx, st_j, pt, st_t)

    st_j2, rows_j2, died_j2 = jx.lcc_call(st_j, False)
    st_t2, rows_t2, died_t2 = pt.lcc_call(st_t, False)
    _same_rows(rows_j2, rows_t2)
    assert died_j2 == died_t2
    _same_state(jx, st_j2, pt, st_t2)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_single_init_superstep_matches_jax(graph, tree, config):
    """The compact path's first call: the global init superstep alone
    (JAX rebuilds tv and the pairs on the host; the port downloads them)."""
    jx, pt = _engines(graph, tree, **CONFIGS[config])
    st_j, rows_j, died_j = jx.lcc_call(jx.init_state(), True, n_steps=1)
    st_t, rows_t, died_t = pt.lcc_call(pt.init_state(), True, n_steps=1)
    _same_rows(rows_j, rows_t)
    assert died_j == died_t
    assert np.array_equal(jx.tv_host(st_j), pt.tv_host(st_t))
    for a, b in zip(jx.alive_pairs(st_j), pt.alive_pairs(st_t)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("jax_mode", sorted(JAX_MODES))
def test_continuation_from_jax_state(graph, tree, jax_mode):
    """Both engines continue from the same mid-search JAX state, with a
    token-passing mark on one alive edge."""
    jx, pt = _engines(graph, tree, jax_mode, num_ranks=4)
    st_j, _, _ = jx.lcc_call(jx.init_state(), True, n_steps=3)
    tv = np.asarray(st_j.tv)
    alive = np.asarray(st_j.alive)
    flag = np.zeros_like(alive)
    flag[np.nonzero(alive)[0][:2]] = True
    st_t = pt.state_from_jax(tv, alive, flag)
    tv_g, alive_g = jx.state_to_global(st_j)
    st_g = pt.state_from_global(tv_g, alive_g, flag[jx._edge_to_slot])
    for a, b in ((st_t.tv, st_g.tv), (st_t.alive, st_g.alive), (st_t.tp_flag, st_g.tp_flag)):
        assert np.array_equal(a.numpy(), b.numpy())
    st_j = jx.state_from_global(tv_g, alive_g, flag[jx._edge_to_slot])
    st_j2, rows_j, died_j = jx.lcc_call(st_j, False, n_steps=4)
    st_t2, rows_t, died_t = pt.lcc_call(st_t, False, n_steps=4)
    _same_rows(rows_j, rows_t)
    assert died_j == died_t
    _same_state(jx, st_j2, pt, st_t2)


def test_lazy_state_and_updates_match_jax(graph, tree):
    """state_from_edge_ids + with_updates (tv change and TP marks): the JAX
    engine's lazy and eager states against the port's one device state,
    then a full call from each."""
    jx, pt = _engines(graph, tree, num_ranks=2)
    st_j, _, _ = jx.lcc_call(jx.init_state(), True)
    tv, edge_alive = jx.state_to_global(st_j)
    tv = np.asarray(tv).copy()
    eids = np.nonzero(np.asarray(edge_alive))[0]
    marks = [int(e) for e in eids[::7]]
    tv[np.nonzero(tv)[0][::5]] = 0  # sources deleted by an NLCC pass
    for lazy in (True, False):
        sj = jx.state_from_edge_ids(tv, eids, lazy=lazy)
        stt = pt.state_from_edge_ids(tv, eids)
        for a, b in zip(jx.alive_pairs(sj), pt.alive_pairs(stt)):
            assert np.array_equal(a, b)
        sj = jx.with_updates(sj, tv, marks)
        stt = pt.with_updates(stt, tv, marks)
        sj2, rows_j, died_j = jx.lcc_call(sj, False)
        st2, rows_t, died_t = pt.lcc_call(stt, False)
        _same_rows(rows_j, rows_t)
        assert died_j == died_t
        _same_state(jx, sj2, pt, st2)


@pytest.mark.parametrize("ranks", [1, 4])
def test_stats_rows_per_superstep(ranks):
    """``stats_rows``, which every LCC engine's lcc_call uses: each row's
    per-rank counts are copies of its slices and sum to its totals; the
    died flag is any superstep's last column."""
    rng = np.random.default_rng(ranks)
    st = rng.integers(0, 50, size=(3, 3 * ranks + 1), dtype=np.int64)
    st[:, -1] = [0, 1, 0]
    rows, died = stats_rows(st, ranks)
    assert died is True and stats_rows(st[[0, 2]], ranks)[1] is False
    assert len(rows) == 3
    for row, (av, ae, msgs, per) in zip(st.copy(), rows):
        for k, part in enumerate(("av", "ae", "msg")):
            assert per[part].tolist() == row[k * ranks:(k + 1) * ranks].tolist()
        assert (av, ae, msgs) == tuple(int(row[k * ranks:(k + 1) * ranks].sum()) for k in range(3))
        per["av"][:] = -1
    assert (st >= 0).all()
    assert stats_rows(np.zeros((0, 3 * ranks + 1), np.int64), ranks) == ([], False)


def test_fuzzy_optional_edges_match_jax(graph, tmp_path):
    """A template with optional edges and a minimum count: the keep mask's
    bit-count loop."""
    g, labels, gt = graph
    fuzzy = _patterns(write_fuzzy_pattern(tmp_path, require_optional=True))
    assert (fuzzy[1].min_optional_edge_count > 0).any()
    lab = np.minimum(labels, 3)
    jx, pt = _engines((g, lab, gt), fuzzy, num_ranks=2)
    st_j, rows_j, died_j = jx.lcc_call(jx.init_state(), True)
    st_t, rows_t, died_t = pt.lcc_call(pt.init_state(), True)
    _same_rows(rows_j, rows_t)
    assert died_j == died_t
    _same_state(jx, st_j, pt, st_t)


def test_unported_modes_raise(graph, tree):
    """Counting and edge metadata are ported: both modes build. What the
    engine still refuses is a template of more than 16 vertices (tv holds
    16 bits)."""
    _, labels, gt = graph
    pattern = tree[1]
    allow = np.zeros((2, pattern.vertex_count), dtype=np.uint32)
    eng = BucketedLccEngine(
        gt, labels, pattern, device="cpu", counting=True,
        edge_meta=(allow, np.zeros(gt.num_edges, dtype=np.int64)),
    )
    assert eng.counting and eng.meta_allow is not None
    assert all(d.meta.dtype == torch.uint8 and d.cls is not None for d in eng._dev)
    big = dataclasses.replace(pattern, vertex_count=17)
    with pytest.raises(ValueError):
        BucketedLccEngine(gt, labels, big, device="cpu")
