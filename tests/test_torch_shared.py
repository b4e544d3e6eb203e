"""The port's own copies of the JAX package's host-side numpy modules
against their originals: on the same seeded inputs each copy gives what the
original gives (the R-MAT stream and its scramble, the CSR, the pattern
loaders, the NLCC/TDS walks, the result trees, the graph DB reader, the
label helpers, the TP-mark merge of the driver's host state, the oracle, the synthetic streams).
Everything compared is an integer array, count or file: exact equality."""

import json
import os
import sys

import numpy as np
import pytest

from fuzzypatternmatching_tpu.engine import lazy_state as jax_lazy
from fuzzypatternmatching_tpu.engine import nlcc as jax_nlcc
from fuzzypatternmatching_tpu.engine import oracle as jax_oracle
from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.generators import rmat as jax_rmat
from fuzzypatternmatching_tpu.generators import synthetic as jax_synthetic
from fuzzypatternmatching_tpu.graph import csr as jax_csr
from fuzzypatternmatching_tpu.graph import storage as jax_storage
from fuzzypatternmatching_tpu.io import labels as jax_labels
from fuzzypatternmatching_tpu.io import results as jax_results
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu.pattern import nonlocal_constraint as jax_nlc
from fuzzypatternmatching_tpu.pattern import pattern_graph as jax_pg
from fuzzypatternmatching_tpu.utils import hashing as jax_hashing
from fuzzypatternmatching_tpu_torch import golden, native
from fuzzypatternmatching_tpu_torch.engine import nlcc, oracle
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine, _HostState
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.generators import rmat, synthetic
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


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
def test_graph_edge_range_accessors_equal_original(use_native):
    """The edge-range accessor protocol the mesh engine reads the graph
    through: the same arrays as the JAX Graph's on random ranges and ids."""
    src, dst = jax_rmat.rmat_all_ranks(10, 4, use_native=False, scramble=False)
    g = csr.from_edges(src, dst, num_vertices=1 << 10, use_native=use_native)
    gj = jax_csr.from_edges(src, dst, num_vertices=1 << 10, use_native=use_native)
    rng = np.random.RandomState(1)
    for _ in range(20):
        lo, hi = sorted(rng.randint(0, g.num_edges + 1, size=2))
        for name in ("cols_range", "rev_range", "edge_row_range"):
            x, y = getattr(g, name)(lo, hi), getattr(gj, name)(lo, hi)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    ids = rng.randint(0, g.num_edges, size=300)
    for name in ("cols_at", "edge_row_at"):
        assert np.array_equal(getattr(g, name)(ids), getattr(gj, name)(ids)), name


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
    """The driver's host state merges TP marks as the JAX lazy state does
    (``merged_flag_ids``); the port holds no marks as an empty array."""
    empty = np.empty(0, dtype=np.int64)
    tv = np.array([3, 0, 1], dtype=np.uint32)
    for prev, marks in (
        (None, []), (None, [4, 1]), (np.array([2, 5]), [5, 3]), (np.array([2, 5]), []),
    ):
        host = _HostState(tv, empty, empty, empty if prev is None else prev)
        got = host.with_updates(tv, marks).marks
        want = jax_lazy.merged_flag_ids(prev, marks)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_match_engine_on_jax_graph_is_refused(golden_meta):
    """MatchEngine's Graph check names the port's own Graph."""
    (g, labels, p, cs), (gj, _, _, _) = _configs(golden_meta, "tree_s13")
    with pytest.raises(TypeError):
        MatchEngine(gj, labels, p, cs, device="cpu")
    assert JaxMatchEngine is not MatchEngine


def _with_edge_data(p, pj, seed):
    """Give both patterns the same per-edge metadata when their corpus has
    none (values from {7, 9, 11}, symmetric per undirected edge)."""
    if pj.edge_data is None:
        rng = np.random.RandomState(seed)
        rows = np.repeat(np.arange(pj.vertex_count), np.diff(pj.row_ptr))
        val = {}
        for a, b in zip(rows.tolist(), pj.cols.tolist()):
            val.setdefault((min(a, b), max(a, b)), int(rng.choice([7, 9, 11])))
        pj.edge_data = np.array(
            [val[(min(a, b), max(a, b))] for a, b in zip(rows.tolist(), pj.cols.tolist())],
            dtype=np.int64,
        )
        p.edge_data = pj.edge_data.copy()


@pytest.mark.parametrize("corpus", ["tree", "cycle", "fuzzy"])
def test_pattern_tables_equal_original(corpus, tmp_path):
    """neighbor_label_counts, edge_meta_tables and hop_edge_values (along
    every constraint's walk) of the port's PatternGraph against the
    original's."""
    if corpus == "tree":
        p, cs = builtin.load_tree_pattern(str(tmp_path / "port"))
        pj, _ = jax_builtin.load_tree_pattern(str(tmp_path / "jax"))
    else:
        if corpus == "fuzzy":
            from test_fuzzy import write_fuzzy_pattern

            write_fuzzy_pattern(tmp_path, require_optional=True)
            prefix = str(tmp_path / "pattern")
        else:
            prefix = CORPORA[corpus]
        p, pj = pattern_graph.load_pattern_graph(prefix), jax_pg.load_pattern_graph(prefix)
        cs = nonlocal_constraint.load_nonlocal_constraints(prefix, p.vertex_data)
    _with_edge_data(p, pj, len(corpus))
    for got, want in zip(p.neighbor_label_counts(), pj.neighbor_label_counts()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for got, want in zip(p.edge_meta_tables(), pj.edge_meta_tables()):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    walks = [c.indices for c in cs] or [np.array([0, 1, 0])]
    for idx in walks:
        assert np.array_equal(p.hop_edge_values(idx), pj.hop_edge_values(idx))
    with pytest.raises(ValueError):
        p.hop_edge_values(np.array([0, 0]))
    p.edge_data = None
    with pytest.raises(ValueError):
        p.edge_meta_tables()


@pytest.mark.parametrize("name", ["tree_s13", "cycle_s13"])
def test_nlcc_walks_with_hop_filters_equal_original(golden_meta, name):
    """AliveCsr.build with per-edge metadata codes over the state after the
    first LCC call, then every constraint with its per-hop codes (hopc):
    run_nem/run_tds of the copy against the original's."""
    (g, labels, p, cs), (gj, _, _, cjs) = _configs(golden_meta, name)
    nr = golden_meta["num_ranks"]
    lcc = BucketedLccEngine(g, labels, p, device="cpu", num_ranks=nr)
    st, _, _ = lcc.lcc_call(lcc.init_state(), True)
    tv, alive = lcc.state_to_global(st)
    v = g.num_vertices
    rng = np.random.RandomState(3)
    code = rng.choice([0, 1], p=[0.85, 0.15], size=g.num_edges).astype(np.int64)
    acsr = nlcc.AliveCsr.build(g, alive, tv != 0, meta=code)
    acsr_j = jax_nlcc.AliveCsr.build(gj, alive, tv != 0, meta=code)
    for field in ("ptr", "col", "meta"):
        assert np.array_equal(getattr(acsr, field), getattr(acsr_j, field)), field
    tv_j = tv.copy()
    fw, fw_j = nlcc.ForwardedSets.empty(), jax_nlcc.ForwardedSets.empty()
    filtered = 0
    for c, cj in zip(cs, cjs):
        hopc = np.zeros(len(c.indices) - 1, dtype=np.int64)
        fw.reset_for(c, labels, tv, v)
        fw_j.reset_for(cj, labels, tv_j, v)
        if c.is_tds:
            o = nlcc.run_tds(acsr, labels, tv, c, v, source_batch=64, num_ranks=nr,
                             forwarded=fw, hopc=hopc)
            oj = jax_nlcc.run_tds(acsr_j, labels, tv_j, cj, v, source_batch=64,
                                  num_ranks=nr, forwarded=fw_j, hopc=hopc)
            plain = nlcc.run_tds(acsr, labels, tv.copy(), c, v, source_batch=64, num_ranks=nr)
        else:
            o = nlcc.run_nem(acsr, labels, tv, c, v, num_ranks=nr, forwarded=fw, hopc=hopc)
            oj = jax_nlcc.run_nem(acsr_j, labels, tv_j, cj, v, num_ranks=nr,
                                  forwarded=fw_j, hopc=hopc)
            plain = nlcc.run_nem(acsr, labels, tv.copy(), c, v, num_ranks=nr)
        _same_outcome(o, oj)
        assert np.array_equal(fw.keys, fw_j.keys)
        filtered += int(o.messages < plain.messages)
        assert nlcc.invalidate_sources(tv, c, o) == jax_nlcc.invalidate_sources(tv_j, cj, oj)
        assert np.array_equal(tv, tv_j)
    assert filtered > 0


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("columns", [2, 3])
def test_read_edge_lists_equal_original(tmp_path, columns, use_native):
    from fuzzypatternmatching_tpu.generators import edge_list as jax_edge_list
    from fuzzypatternmatching_tpu_torch.generators import edge_list

    if use_native and not native.available():
        pytest.fail("the native library does not load")
    rng = np.random.RandomState(columns)
    paths = []
    for i, n in enumerate((50, 0, 17)):
        rows = rng.randint(0, 1000, size=(n, columns))
        path = str(tmp_path / f"edges_{i}")
        np.savetxt(path, rows, fmt="%d")
        paths.append(path)
    for undirected in (False, True):
        got = edge_list.read_edge_lists(paths, undirected=undirected, use_native=use_native)
        want = jax_edge_list.read_edge_lists(paths, undirected=undirected, use_native=use_native)
        assert (got[2] is None) == (want[2] is None) == (columns == 2)
        for x, y in zip(got, want):
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y)
        assert len(got[0]) == (67 if not undirected else 134)


def _db_files_equal(a, b):
    """Two graph DB directories hold the same files: meta.json equal but
    for its uuid, every other file byte for byte."""
    names = sorted(
        os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs
    )
    assert names == sorted(
        os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs
    )
    for rel in names:
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            x, y = fa.read(), fb.read()
        if rel == "meta.json":
            x, y = json.loads(x), json.loads(y)
            x.pop("uuid"), y.pop("uuid")
        assert x == y, rel
    return names


@pytest.mark.parametrize("num_shards", [1, 3])
@pytest.mark.parametrize("extras", [False, True], ids=["bare", "labels_edge_data"])
def test_storage_save_writes_the_jax_files(tmp_path, num_shards, extras):
    gj, labels, edata = _rmat_graph_and_extras()
    g = csr.Graph(gj.num_vertices, gj.row_ptr, gj.cols, gj.rev_edge,
                  gj.raw_degree, gj.edge_row)
    kw = dict(labels=labels, edge_data=edata) if extras else {}
    storage.save(g, str(tmp_path / "port"), num_shards=num_shards, **kw)
    jax_storage.save(gj, str(tmp_path / "jax"), num_shards=num_shards, **kw)
    names = _db_files_equal(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(names) == 1 + num_shards * (6 if extras else 4)
    storage.transfer(str(tmp_path / "port"), str(tmp_path / "copy"))
    _db_files_equal(str(tmp_path / "copy"), str(tmp_path / "jax"))
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    meta["clean_close"] = False
    (tmp_path / "port" / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError):
        storage.transfer(str(tmp_path / "port"), str(tmp_path / "dirty"))


def test_open_db_reads_what_the_jax_graphdb_reads(tmp_path):
    gj, labels, edata = _rmat_graph_and_extras()
    base = str(tmp_path / "db")
    jax_storage.save(gj, base, num_shards=3, labels=labels, edge_data=edata)
    db, db_j = storage.open_db(base), jax_storage.open_db(base)
    for name in ("num_vertices", "num_edges", "num_shards", "block"):
        assert getattr(db, name) == getattr(db_j, name)
    for name in ("row_ptr", "raw_degree", "labels", "edge_starts"):
        assert np.array_equal(getattr(db, name), getattr(db_j, name)), name
    rng = np.random.RandomState(0)
    for _ in range(20):
        lo, hi = sorted(rng.randint(0, gj.num_edges + 1, size=2))
        for name in ("cols_range", "rev_range", "edge_row_range"):
            assert np.array_equal(getattr(db, name)(lo, hi), getattr(db_j, name)(lo, hi))
    ids = rng.randint(0, gj.num_edges, size=200)
    assert np.array_equal(db.cols_at(ids), db_j.cols_at(ids))
    assert np.array_equal(db.edge_row_at(ids), db_j.edge_row_at(ids))
    assert db.degree(5) == db_j.degree(5)
    g = db.to_graph()
    assert isinstance(g, csr.Graph)
    _same_arrays(g, db_j.to_graph())


def test_build_db_from_chunks_writes_the_jax_files(tmp_path):
    """The generic (ingest-path) chunked build from raw (src, dst) chunks,
    with the numpy spill: the same shard files as the JAX build."""
    from fuzzypatternmatching_tpu.graph import build as jax_build
    from fuzzypatternmatching_tpu_torch.graph import build

    src, dst = jax_rmat.rmat_all_ranks(10, 4, use_native=False, scramble=False)

    def chunks(n=7):
        step = -(-len(src) // n)
        for lo in range(0, len(src), step):
            yield src[lo : lo + step], dst[lo : lo + step]

    build.build_db_from_chunks(str(tmp_path / "port"), chunks(), 1 << 10, num_shards=4)
    jax_build.build_db_from_chunks(str(tmp_path / "jax"), chunks(), 1 << 10, num_shards=4)
    _db_files_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_multiprocess_rmat_build_writes_the_single_process_db(tmp_path):
    """Two shares of build_rmat_db_distributed (threads here, sharing one
    output directory through the file barriers) write the DB that the JAX
    package's single-process build_rmat_db writes."""
    import threading

    from fuzzypatternmatching_tpu.graph import build as jax_build
    from fuzzypatternmatching_tpu_torch.graph import build

    base = str(tmp_path / "port")
    errors = []

    def one(pid):
        try:
            build.build_rmat_db_distributed(base, 9, pid, 2, scramble=False, timeout=60.0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(pid,)) for pid in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    jax_build.build_rmat_db(str(tmp_path / "jax"), 9, scramble=False)
    _db_files_equal(base, str(tmp_path / "jax"))


def test_rmat_spill_shards_native_equals_original(tmp_path):
    from fuzzypatternmatching_tpu import native as jax_native

    if not native.available():
        pytest.fail("the native library does not load")
    for name, mod in (("port", native), ("jax", jax_native)):
        os.makedirs(tmp_path / name)
        deg = mod.rmat_spill_shards_native(str(tmp_path / name), 10, 4, 3, 342,
                                           scramble=False, rank_lo=1, rank_hi=3)
        np.save(tmp_path / f"deg_{name}.npy", deg)
    assert np.array_equal(np.load(tmp_path / "deg_port.npy"), np.load(tmp_path / "deg_jax.npy"))
    _db_files_equal(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_log_step_prints_what_the_original_prints(monkeypatch):
    import io
    import re

    from fuzzypatternmatching_tpu.utils import log_step as jax_log_step
    from fuzzypatternmatching_tpu_torch.utils import log_step

    def shape(text):
        # numbers vary from run to run; the lines and their words do not
        return re.sub(r"\d+(\.\d+)?", "N", text)

    outs = []
    for mod in (log_step, jax_log_step):
        buf = io.StringIO()
        with mod.LogStep("pass A", out=buf):
            pass
        outs.append(buf.getvalue())
    assert shape(outs[0]) == shape(outs[1]) and "Finished: pass A" in outs[0]
    assert log_step.rss_kb()[0] > 0 and log_step.dirty_pages_kb() is not None
    monkeypatch.setenv("FPM_LOG_STEPS", "0")
    buf = io.StringIO()
    with log_step.LogStep("pass B", out=buf):
        pass
    assert buf.getvalue() == ""


def test_add_distributed_args_equals_original():
    import argparse

    from fuzzypatternmatching_tpu.utils import dist as jax_dist
    from fuzzypatternmatching_tpu_torch.utils import dist

    argv = ["--distributed", "--coordinator", "h:1", "--num-processes", "3", "--process-id", "2"]
    for args in ([], argv):
        got, want = argparse.ArgumentParser(), argparse.ArgumentParser()
        dist.add_distributed_args(got)
        jax_dist.add_distributed_args(want)
        assert vars(got.parse_args(args)) == vars(want.parse_args(args))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzzy_walk_equals_original(seed):
    from fuzzypatternmatching_tpu.algorithms import fuzzy_walk as jax_fuzzy_walk
    from fuzzypatternmatching_tpu_torch.algorithms import fuzzy_walk

    gj, _, _ = _rmat_graph_and_extras(scale=8)
    g = csr.Graph(gj.num_vertices, gj.row_ptr, gj.cols, gj.rev_edge,
                  gj.raw_degree, gj.edge_row)
    labels = np.random.RandomState(seed).randint(1, 4, size=g.num_vertices).astype(np.uint64)
    for wl, wi in (([1, 2, 3], [0, 1, 2]), ([1, 2, 1, 2], [0, 1, 2, 3]),
                   ([2, 3, 2], [0, 1, 0]), ([2], [0])):
        got = fuzzy_walk.fuzzy_walk_ranks(g, labels, np.array(wl), np.array(wi), batch_size=100)
        want = jax_fuzzy_walk.fuzzy_walk_ranks(gj, labels, np.array(wl), np.array(wi),
                                               batch_size=100)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert fuzzy_walk.MAX_WALK == jax_fuzzy_walk.MAX_WALK
    with pytest.raises(ValueError):
        fuzzy_walk.fuzzy_walk_ranks(g, labels, np.ones(16), np.arange(16))


def test_write_vertex_data_equals_original(tmp_path):
    gj, labels, _ = _rmat_graph_and_extras(scale=7)
    results.write_vertex_data(str(tmp_path / "port"), labels, gj.raw_degree, 3)
    jax_results.write_vertex_data(str(tmp_path / "jax"), labels, gj.raw_degree, 3)
    assert _db_files_equal(str(tmp_path / "port"), str(tmp_path / "jax")) == [
        f"0/all_ranks_vertex_data/vertex_data_{r}" for r in range(3)
    ]


def _result_trace(r):
    return (
        [(x.itr, x.phase, x.step, x.active_vertices, x.active_edges, x.messages,
          None if x.per_rank is None else {k: list(v) for k, v in x.per_rank.items()})
         for x in r.rows],
        r.pattern_found, r.iterations, r.active_vertices, r.active_edges,
        {k: sorted(v) for k, v in r.subgraphs.items()},
    )


@pytest.mark.parametrize(
    "name, mode",
    [("tree_s13", "plain"), ("cycle_s13", "plain"), ("tree_s13", "ranks4"),
     ("tree_s13", "counting"), ("tree_s13", "metadata")],
)
def test_oracle_equals_original(golden_meta, name, mode, tmp_path):
    """The port's MatchOracle against the JAX package's on the golden
    configurations: every PhaseRow (with the per-rank counters), the found
    flags, the iterations, the active sets and the subgraphs; with 4 output
    ranks, counting, and edge metadata (the tree corpus with its
    pattern_edge_data, every edge at 55 but every seventh at 56)."""
    (g, labels, p, cs), (gj, _, pj, cjs) = _configs(golden_meta, name)
    kw = {}
    if mode == "ranks4":
        kw = {"num_ranks": 4}
    elif mode == "counting":
        kw = {"counting": True, "num_ranks": 4}
    elif mode == "metadata":
        p, cs = builtin.load_tree_pattern(str(tmp_path / "port"))
        pj, cjs = jax_builtin.load_tree_pattern(str(tmp_path / "jax"))
        ed = np.where(np.arange(g.num_edges) % 7 == 0, 56, 55).astype(np.int64)
        ed = np.where(g.edge_row < g.cols, ed, ed[np.maximum(g.rev_edge, 0)])
        kw = {"edge_data": ed}
    got = oracle.MatchOracle(g, labels, p, cs, **kw).run()
    want = jax_oracle.MatchOracle(gj, labels, pj, cjs, **kw).run()
    assert _result_trace(got) == _result_trace(want)


def test_synthetic_streams_equal_original():
    """upper_triangle, the bit-exact preferential attachment (with rewiring
    and several ranks; its scramble needs 2^17 nodes) and the sequential
    one."""
    for und in (True, False):
        for x, y in zip(synthetic.upper_triangle(9, und), jax_synthetic.upper_triangle(9, und)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for kw in (
        dict(node_scale=5, edge_scale=8, beta=1.0, scramble=False),
        dict(node_scale=6, edge_scale=9, beta=0.5, prob_rewire=0.2, n_ranks=3,
             base_seed=11, scramble=False),
    ):
        for x, y in zip(synthetic.preferential_attachment_exact(**kw),
                        jax_synthetic.preferential_attachment_exact(**kw)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for x, y in zip(synthetic.preferential_attachment(300, 3, seed=4, beta=0.7),
                    jax_synthetic.preferential_attachment(300, 3, seed=4, beta=0.7)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
