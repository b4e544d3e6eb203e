"""The port's own copies of the JAX package's host-side numpy modules
against their originals: on the same seeded inputs each copy gives what the
original gives (the R-MAT stream and its scramble, the CSR, the pattern
loaders, the NLCC/TDS walks, the result trees, the graph DB reader, the
label and lazy-state helpers). Everything compared is an integer array,
count or file: exact equality."""

import json
import os
import sys

import numpy as np
import pytest

from fuzzypatternmatching_tpu.engine import lazy_state as jax_lazy
from fuzzypatternmatching_tpu.engine import nlcc as jax_nlcc
from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.generators import rmat as jax_rmat
from fuzzypatternmatching_tpu.graph import csr as jax_csr
from fuzzypatternmatching_tpu.graph import storage as jax_storage
from fuzzypatternmatching_tpu.io import labels as jax_labels
from fuzzypatternmatching_tpu.io import results as jax_results
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu.pattern import nonlocal_constraint as jax_nlc
from fuzzypatternmatching_tpu.pattern import pattern_graph as jax_pg
from fuzzypatternmatching_tpu.utils import hashing as jax_hashing
from fuzzypatternmatching_tpu_torch import golden, native
from fuzzypatternmatching_tpu_torch.engine import lazy_state, nlcc
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.generators import rmat
from fuzzypatternmatching_tpu_torch.graph import csr, storage
from fuzzypatternmatching_tpu_torch.io import labels as port_labels
from fuzzypatternmatching_tpu_torch.io import results
from fuzzypatternmatching_tpu_torch.pattern import builtin, nonlocal_constraint
from fuzzypatternmatching_tpu_torch.pattern import pattern_graph
from fuzzypatternmatching_tpu_torch.utils import hashing

from test_golden_results import _tree_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPORA = {
    "tree": os.path.join(REPO, "examples", "patterns", "0", "pattern"),
    "cycle": os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern"),
}
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_golden import build_config as jax_build_config  # noqa: E402


def _same_arrays(a, b):
    for name in ("num_vertices", "row_ptr", "cols", "rev_edge", "raw_degree", "edge_row"):
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            assert np.array_equal(x, y), name
        else:
            assert x == y, name


@pytest.mark.parametrize("n", [17, 20, 24, 32, 40])
def test_hash_nbits_equals_original(n):
    x = np.random.RandomState(n).randint(0, 1 << min(n, 62), size=5000, dtype=np.int64)
    assert np.array_equal(
        hashing.hash_nbits(x.astype(np.uint64), n),
        jax_hashing.hash_nbits(x.astype(np.uint64), n),
    )


@pytest.mark.parametrize(
    "scale, scramble", [(11, False), (17, True)], ids=["s11", "s17_scrambled"]
)
def test_generate_edges_equals_original(scale, scramble):
    kw = dict(seed=5489 + 3, vertex_scale=scale, edge_count=20000, scramble=scramble)
    got = rmat.generate_edges(rmat.RmatParams(**kw))
    want = jax_rmat.generate_edges(jax_rmat.RmatParams(**kw))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint64
        assert np.array_equal(g, w)


@pytest.mark.parametrize(
    "scale, scramble", [(11, False), (17, True)], ids=["s11", "s17_scrambled"]
)
@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
def test_rmat_all_ranks_equals_original(scale, scramble, use_native):
    if use_native and not native.available():
        pytest.fail("the native library does not load")
    kw = dict(edges_per_vertex=1 if scale == 17 else 16, scramble=scramble)
    got = rmat.rmat_all_ranks(scale, 4, use_native=use_native, **kw)
    want = jax_rmat.rmat_all_ranks(scale, 4, use_native=False, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g, np.uint64), np.asarray(w, np.uint64))


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
def test_from_edges_and_degree_labels_equal_original(use_native):
    src, dst = jax_rmat.rmat_all_ranks(11, 4, use_native=False, scramble=False)
    g = csr.from_edges(src, dst, num_vertices=1 << 11, use_native=use_native)
    gj = jax_csr.from_edges(src, dst, num_vertices=1 << 11, use_native=use_native)
    assert isinstance(g, csr.Graph) and g.num_edges == gj.num_edges
    _same_arrays(g, gj)
    lab, lab_j = csr.degree_labels(g), jax_csr.degree_labels(gj)
    assert lab.dtype == lab_j.dtype and np.array_equal(lab, lab_j)


def _same_pattern(p, pj):
    for name in ("vertex_count", "edge_count", "diameter"):
        assert getattr(p, name) == getattr(pj, name)
    for name in (
        "row_ptr", "cols", "vertex_data", "edges_bitset",
        "edges_bitset_optional", "edges_bitset_all", "min_optional_edge_count",
    ):
        x, y = getattr(p, name), getattr(pj, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (p.edge_data is None) == (pj.edge_data is None)
    if p.edge_data is not None:
        assert np.array_equal(p.edge_data, pj.edge_data)


def _same_constraints(cs, cjs):
    assert len(cs) == len(cjs)
    for c, cj in zip(cs, cjs):
        for name in ("cycle_length", "valid_cycle", "interleave_lcc",
                     "selected_vertices", "is_tds"):
            assert getattr(c, name) == getattr(cj, name), name
        for name in ("labels", "indices", "enumeration", "aggregation"):
            x, y = getattr(c, name), getattr(cj, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_pattern_loaders_equal_original(corpus):
    prefix = CORPORA[corpus]
    p = pattern_graph.load_pattern_graph(prefix)
    pj = jax_pg.load_pattern_graph(prefix)
    _same_pattern(p, pj)
    labels = np.arange(12, dtype=np.uint64)
    assert np.array_equal(p.label_match_bitset(labels), pj.label_match_bitset(labels))
    _same_constraints(
        nonlocal_constraint.load_nonlocal_constraints(prefix, p.vertex_data),
        jax_nlc.load_nonlocal_constraints(prefix, pj.vertex_data),
    )


def test_load_tree_pattern_equals_original(tmp_path):
    p, cs = builtin.load_tree_pattern(str(tmp_path / "port"))
    pj, cjs = jax_builtin.load_tree_pattern(str(tmp_path / "jax"))
    _same_pattern(p, pj)
    _same_constraints(cs, cjs)
    assert builtin.RMAT_LOG2_TREE == jax_builtin.RMAT_LOG2_TREE


@pytest.fixture(scope="module")
def golden_meta():
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        return json.load(f)


def _configs(golden_meta, name):
    cfg = golden_meta["configs"][name]
    corpus = os.path.join(REPO, cfg["corpus"])
    return golden.build_config(cfg["scale"], corpus), jax_build_config(cfg["scale"], corpus)


@pytest.mark.parametrize("name", ["tree_s13", "cycle_s13"])
def test_golden_config_equals_make_golden(golden_meta, name):
    (g, lab, p, cs), (gj, lab_j, pj, cjs) = _configs(golden_meta, name)
    _same_arrays(g, gj)
    assert np.array_equal(lab, lab_j)
    _same_pattern(p, pj)
    _same_constraints(cs, cjs)


def _same_outcome(o, oj):
    assert o.messages == oj.messages
    assert np.array_equal(o.sources, oj.sources)
    assert np.array_equal(o.validated, oj.validated)
    assert o.edge_marks == oj.edge_marks
    assert np.array_equal(o.msg_per_rank, oj.msg_per_rank)
    assert (o.subgraphs is None) == (oj.subgraphs is None)
    if o.subgraphs is not None:
        assert np.array_equal(o.subgraphs, oj.subgraphs)


@pytest.mark.parametrize("name", ["tree_s13", "cycle_s13"])
def test_nlcc_walks_equal_original(golden_meta, name):
    """Every constraint of the corpus, in the driver's order, on the state
    after the first LCC call: run_nem/run_tds messages, winners (validated
    sources, cycle edge marks, forwarded sets), subgraphs and the source
    invalidation."""
    (g, labels, p, cs), (_, _, _, cjs) = _configs(golden_meta, name)
    nr = golden_meta["num_ranks"]
    lcc = BucketedLccEngine(g, labels, p, device="cpu", num_ranks=nr)
    st, _, _ = lcc.lcc_call(lcc.init_state(), True)
    tv = lcc.tv_host(st).copy()
    arow, acol = lcc.alive_pairs(st)
    assert len(arow) > 0
    v = g.num_vertices
    tv_j = tv.copy()
    acsr = nlcc.AliveCsr.from_pairs(arow, acol, tv != 0, v)
    acsr_j = jax_nlcc.AliveCsr.from_pairs(arow, acol, tv_j != 0, v)
    assert np.array_equal(acsr.ptr, acsr_j.ptr) and np.array_equal(acsr.col, acsr_j.col)
    fw, fw_j = nlcc.ForwardedSets.empty(), jax_nlcc.ForwardedSets.empty()
    kinds = set()
    for c, cj in zip(cs, cjs):
        fw.reset_for(c, labels, tv, v)
        fw_j.reset_for(cj, labels, tv_j, v)
        cands = np.nonzero(labels == c.labels[0])[0].astype(np.int64)
        if c.is_tds:
            kinds.add("tds")
            o = nlcc.run_tds(acsr, labels, tv, c, v, source_batch=64,
                             num_ranks=nr, forwarded=fw, candidates=cands)
            oj = jax_nlcc.run_tds(acsr_j, labels, tv_j, cj, v, source_batch=64,
                                  num_ranks=nr, forwarded=fw_j, candidates=cands)
        else:
            kinds.add("nem")
            o = nlcc.run_nem(acsr, labels, tv, c, v, num_ranks=nr,
                             forwarded=fw, candidates=cands)
            oj = jax_nlcc.run_nem(acsr_j, labels, tv_j, cj, v, num_ranks=nr,
                                  forwarded=fw_j, candidates=cands)
        _same_outcome(o, oj)
        assert np.array_equal(fw.keys, fw_j.keys)
        assert nlcc.invalidate_sources(tv, c, o) == jax_nlcc.invalidate_sources(tv_j, cj, oj)
        assert np.array_equal(tv, tv_j)
    assert kinds == {"nem", "tds"}


@pytest.mark.parametrize("name", ["tree_s13", "cycle_s13"])
def test_write_results_trees_equal_original(golden_meta, name, tmp_path):
    """Byte for byte, wall-clock fields included: the same MatchResult
    written by both writers."""
    (g, labels, p, cs), _ = _configs(golden_meta, name)
    nr = golden_meta["num_ranks"]
    r = MatchEngine(g, labels, p, cs, num_ranks=nr, device="cpu").run()
    args = (r, labels, nr, p.edge_count, p.vertex_count, len(cs))
    results.write_results(str(tmp_path / "port"), 0, *args)
    jax_results.write_results(str(tmp_path / "jax"), 0, *args)
    files = sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "port")
        for d, _, fs in os.walk(tmp_path / "port") for f in fs
    )
    assert len(files) > 10
    for rel in files:
        with open(tmp_path / "port" / rel, "rb") as a, open(tmp_path / "jax" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    assert _tree_files(str(tmp_path / "port")) == _tree_files(str(tmp_path / "jax"))


def _rmat_graph_and_extras(scale=9):
    src, dst = jax_rmat.rmat_all_ranks(scale, 4, use_native=False, scramble=False)
    gj = jax_csr.from_edges(src, dst, num_vertices=1 << scale)
    labels = jax_csr.degree_labels(gj)
    edata = np.arange(gj.num_edges, dtype=np.int64) % 7
    return gj, labels, edata


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("extras", [False, True], ids=["bare", "labels_edge_data"])
def test_storage_load_reads_a_jax_written_db(tmp_path, num_shards, extras):
    gj, labels, edata = _rmat_graph_and_extras()
    db = str(tmp_path / "db")
    kw = dict(labels=labels, edge_data=edata) if extras else {}
    jax_storage.save(gj, db, num_shards=num_shards, **kw)
    g, lab, ed = storage.load(db)
    g_j, lab_j, ed_j = jax_storage.load(db)
    assert isinstance(g, csr.Graph)
    for name in ("num_vertices", "row_ptr", "cols", "rev_edge", "raw_degree", "edge_row"):
        assert np.array_equal(np.asarray(getattr(g, name)), np.asarray(getattr(g_j, name))), name
    assert np.array_equal(g.cols, gj.cols)
    for x, y in ((lab, lab_j), (ed, ed_j)):
        assert (x is None) == (y is None) == (not extras)
        if x is not None:
            assert np.array_equal(x, y)


def test_storage_load_reads_format_v1(tmp_path):
    """A format-v1 DB (one .npz per shard), written by hand from the JAX
    graph, reads as the JAX reader reads it."""
    gj, labels, edata = _rmat_graph_and_extras()
    db = tmp_path / "db"
    db.mkdir()
    n, v = 2, gj.num_vertices
    block = -(-v // n)
    starts = []
    for r in range(n):
        lo, hi = min(r * block, v), min((r + 1) * block, v)
        e_lo, e_hi = int(gj.row_ptr[lo]), int(gj.row_ptr[hi])
        starts.append(e_lo)
        np.savez(
            db / f"shard_{r}_of_{n}.npz", edge_start=e_lo,
            row_ptr=gj.row_ptr[lo : hi + 1] - e_lo, cols=gj.cols[e_lo:e_hi],
            rev_edge=gj.rev_edge[e_lo:e_hi], raw_degree=gj.raw_degree[lo:hi],
            labels=labels[lo:hi], edge_data=edata[e_lo:e_hi],
        )
    meta = {"version": 1, "num_shards": n, "num_vertices": v,
            "num_edges": gj.num_edges, "edge_starts": starts,
            "has_labels": True, "has_edge_data": True, "clean_close": True}
    (db / "meta.json").write_text(json.dumps(meta))
    got, want = storage.load(str(db)), jax_storage.load(str(db))
    _same_arrays(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    meta["clean_close"] = False
    (db / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError):
        storage.load(str(db))


def test_resolve_labels_equals_original(tmp_path):
    gj, labels, _ = _rmat_graph_and_extras()
    g = csr.Graph(gj.num_vertices, gj.row_ptr, gj.cols, gj.rev_edge,
                  gj.raw_degree, gj.edge_row)
    base = str(tmp_path / "vdata")
    for part in range(2):
        vs = np.arange(part, g.num_vertices, 2)
        np.savetxt(f"{base}_{part}", np.stack([vs, (vs * 7) % 11], axis=1), fmt="%d")
    for vbase, stored in ((None, None), (None, labels + 1), (base, None)):
        got = port_labels.resolve_labels(g, vbase, stored)
        want = jax_labels.resolve_labels(gj, vbase, stored)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_lazy_state_helpers_equal_original():
    ids = np.array([9, 3, 3, 7, 0])
    assert np.array_equal(lazy_state.normalized_edge_ids(ids), jax_lazy.normalized_edge_ids(ids))
    assert lazy_state.normalized_flag_ids(None) is None
    assert np.array_equal(lazy_state.normalized_flag_ids(ids), jax_lazy.normalized_flag_ids(ids))
    for prev, marks in ((None, []), (None, [4, 1]), (np.array([2, 5]), [5, 3])):
        assert np.array_equal(
            lazy_state.merged_flag_ids(prev, marks), jax_lazy.merged_flag_ids(prev, marks)
        )


def test_match_engine_on_jax_graph_is_refused(golden_meta):
    """MatchEngine's Graph check names the port's own Graph."""
    (g, labels, p, cs), (gj, _, _, _) = _configs(golden_meta, "tree_s13")
    with pytest.raises(TypeError):
        MatchEngine(gj, labels, p, cs, device="cpu")
    assert JaxMatchEngine is not MatchEngine
