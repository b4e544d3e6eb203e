"""Edge-metadata-constrained matching on the port
(fuzzypatternmatching_tpu_torch) on the CPU: the mirror of every case of
tests/test_edge_metadata.py that needs no reference checkout.

A data edge carrying metadata m can map onto pattern edge (p, q) only when
the pattern requires m there — per receiver bit in LCC, per traversed hop
in NLCC/TDS. Each case runs the port's flat and bucketed engines (compact
on and off, every NLCC placement) against the JAX package's oracle; the
tree corpus cases also against the JAX engines and the committed golden
trees; the CLI with ``-e <file>`` and ``-e db``; one superstep at a time
from a JAX engine's metadata-mode state (``state_from_jax``). Every value
compared is an integer or a flag: exact equality.
"""

import os
import tempfile

import numpy as np
import pytest

from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.engine.nlcc import AliveCsr as JaxAliveCsr
from fuzzypatternmatching_tpu.engine.nlcc import run_nem as jax_run_nem
from fuzzypatternmatching_tpu.engine.nlcc import run_tds as jax_run_tds
from fuzzypatternmatching_tpu.engine.oracle import MatchOracle
from fuzzypatternmatching_tpu.graph import storage as jax_storage
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.cli import run_pattern_matching
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine, _HostState
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.engine.nlcc import AliveCsr, run_nem, run_tds
from fuzzypatternmatching_tpu_torch.io.results import write_results
from fuzzypatternmatching_tpu_torch.pattern import builtin

from test_edge_metadata import EDGE_META_PATTERN, graph_meta, meta_pattern
from test_golden_results import _tree_files
from test_oracle import make_pattern, path_constraint, tds_constraint, undirected
from test_torch_counting import (
    port_constraint,
    port_graph,
    port_pattern,
    results_equal,
    run_port,
    superstep_pairs,
    assert_supersteps_from_jax,
    rmat_s10,  # noqa: F401  (fixture)
)
from test_torch_lcc_bucketed import _rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_BASE = os.path.join(REPO, "examples", "results_golden")
# (lcc_engine, compact, nlcc_mode): each LCC path, each placement
COMBOS = [
    ("flat", False, "auto"),
    ("bucketed", True, "auto"),
    ("bucketed", False, "device"),
    ("bucketed", True, "host"),
]


def assert_meta_equivalent(gj, labels, pattern, constraints, edge_data):
    """The oracle and the port's engines in every combination agree
    exactly (rows, messages, sets, found flags, subgraphs)."""
    o = MatchOracle(gj, labels, pattern, constraints, edge_data=edge_data).run()
    for eng, compact, mode in COMBOS:
        e = run_port(
            gj, labels, pattern, constraints, lcc_engine=eng, compact=compact,
            nlcc_mode=mode, edge_data=edge_data,
        )
        results_equal(e, o, per_rank=False)
    return e


# ---------------------------------------------------------- LCC semantics


def test_uniform_metadata_is_noop():
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0)])
    g = jax_from_edges(src, dst, num_vertices=4)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    pat = meta_pattern([(0, 1), (1, 0)], [1, 2], [5, 5], diameter=2)
    ed = np.full(g.num_edges, 5, dtype=np.int64)
    cons = [path_constraint(), tds_constraint()]
    r_meta = assert_meta_equivalent(g, labels, pat, cons, ed)
    r_plain = MatchOracle(g, labels, pat, cons).run()
    assert r_meta.active_vertices == r_plain.active_vertices
    assert r_meta.active_edges == r_plain.active_edges
    assert r_meta.pattern_found == r_plain.pattern_found
    assert {k: sorted(v) for k, v in r_meta.subgraphs.items()} == {
        k: sorted(v) for k, v in r_plain.subgraphs.items()
    }


def test_wrong_value_prunes_everything():
    src, dst = undirected([(0, 1)])
    g = jax_from_edges(src, dst, num_vertices=2)
    labels = np.array([1, 2], dtype=np.uint64)
    ed = np.full(g.num_edges, 6, dtype=np.int64)  # pattern requires 5
    r = assert_meta_equivalent(g, labels, EDGE_META_PATTERN, [], ed)
    assert r.active_vertices == {}
    ed5 = np.full(g.num_edges, 5, dtype=np.int64)
    r5 = assert_meta_equivalent(g, labels, EDGE_META_PATTERN, [], ed5)
    assert set(r5.active_vertices) == {0, 1}


def test_per_receiver_bit_exactness():
    """A star where each spoke's value selects WHICH template edge it can
    serve: b (via the 5-edge) may only be template 1, c (via the 6-edge)
    only template 2."""
    src, dst = undirected([(0, 1), (0, 2)])
    g = jax_from_edges(src, dst, num_vertices=3)
    labels = np.array([1, 2, 2], dtype=np.uint64)
    pat = meta_pattern(
        [(0, 1), (0, 2), (1, 0), (2, 0)], [1, 2, 2], [5, 6, 5, 6], diameter=2
    )
    r = assert_meta_equivalent(g, labels, pat, [], graph_meta(g, {(0, 1): 5, (0, 2): 6}))
    assert r.active_vertices == {0: 0b001, 1: 0b010, 2: 0b100}
    r2 = assert_meta_equivalent(g, labels, pat, [], graph_meta(g, {(0, 1): 6, (0, 2): 5}))
    assert r2.active_vertices == {0: 0b001, 1: 0b100, 2: 0b010}
    r3 = assert_meta_equivalent(g, labels, pat, [], graph_meta(g, {(0, 1): 5, (0, 2): 9}))
    assert r3.active_vertices == {}


# --------------------------------------------------------- NLCC semantics


def test_nlcc_hop_filter_blocks_wrong_edge():
    """run_nem over a pruned adjacency built by AliveCsr.build with
    metadata codes: the (1, 2) edge is poisoned, so only walks avoiding it
    validate; the port's host engine equals the JAX package's."""
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0)])
    gj = jax_from_edges(src, dst, num_vertices=4)
    g = port_graph(gj)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    tv = np.array([0b001, 0b010, 0b001, 0b010], dtype=np.uint32)
    cj = path_constraint()
    c = port_constraint(cj)
    meta_codes = graph_meta(gj, {(1, 2): 1}, default=0)  # code 1 = wrong
    alive = np.ones(g.num_edges, dtype=bool)
    acsr = AliveCsr.build(g, alive, tv != 0, meta=meta_codes)
    acsr_j = JaxAliveCsr.build(gj, alive, tv != 0, meta=meta_codes)
    for name in ("ptr", "col", "meta"):
        assert np.array_equal(getattr(acsr, name), getattr(acsr_j, name))
    hopc = np.array([0, 0])  # both hops require code 0
    out = run_nem(acsr, labels, tv, c, 4, hopc=hopc)
    ok = dict(zip(out.sources.tolist(), out.validated.tolist()))
    assert ok[0] and ok[2]
    out_j = jax_run_nem(acsr_j, labels, tv, cj, 4, hopc=hopc)
    assert out.messages == out_j.messages
    assert np.array_equal(out.validated, out_j.validated)
    out_nofilter = run_nem(acsr, labels, tv, c, 4)
    assert out_nofilter.validated.all()
    assert out_nofilter.messages > out.messages
    tds = port_constraint(tds_constraint())
    o_t = run_tds(acsr, labels, tv, tds, 4, hopc=hopc)
    o_tj = jax_run_tds(acsr_j, labels, tv, tds_constraint(), 4, hopc=hopc)
    assert o_t.messages == o_tj.messages < run_tds(acsr, labels, tv, tds, 4).messages
    assert np.array_equal(o_t.subgraphs, o_tj.subgraphs)


def test_tds_metadata_restricts_enumeration():
    """TDS on the square with one poisoned edge: enumerated walks all avoid
    it, and the subgraph set shrinks (port == oracle)."""
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0)])
    g = jax_from_edges(src, dst, num_vertices=4)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    pat = meta_pattern([(0, 1), (1, 0)], [1, 2], [5, 5], diameter=2)
    cons = [tds_constraint()]
    r_all = assert_meta_equivalent(g, labels, pat, cons, np.full(g.num_edges, 5))
    n_all = len(r_all.subgraphs.get(0, []))
    assert n_all > 0
    r_p = assert_meta_equivalent(g, labels, pat, cons, graph_meta(g, {(1, 2): 6}, default=5))
    for walk in r_p.subgraphs.get(0, []):
        for a, b in zip(walk, walk[1:]):
            assert {a, b} != {1, 2}, f"walk {walk} used the poisoned edge"
    assert len(r_p.subgraphs.get(0, [])) < n_all


# ----------------------------------------------------- random equivalence


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graphs_random_metadata(seed):
    rng = np.random.RandomState(seed)
    v, e = 40, 120
    u = rng.randint(0, v, size=e)
    w = rng.randint(0, v, size=e)
    g = jax_from_edges(np.concatenate([u, w]), np.concatenate([w, u]), num_vertices=v)
    labels = rng.randint(1, 3, size=v).astype(np.uint64)
    pat = meta_pattern(
        [(0, 1), (1, 0), (1, 2), (2, 1)], [1, 2, 1], [5, 5, 6, 6], diameter=2
    )
    val_of = {}
    for i in range(g.num_edges):
        a, b = int(g.edge_row[i]), int(g.cols[i])
        val_of.setdefault((min(a, b), max(a, b)), int(rng.choice([5, 6, 7])))
    assert_meta_equivalent(g, labels, pat, [path_constraint(), tds_constraint()],
                           graph_meta(g, val_of))


# ------------------------------------------------------------------- CLI


def _cli_fixture(tmp_path):
    """The square with one 6-valued edge, saved as a graph DB with its
    metadata, and a one-edge pattern requiring 5."""
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0)])
    gj = jax_from_edges(src, dst, num_vertices=4)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    val_of = {(0, 1): 5, (1, 2): 5, (2, 3): 5, (3, 0): 6}
    ed = graph_meta(gj, val_of)
    db = str(tmp_path / "db")
    jax_storage.save(gj, db, num_shards=2, labels=labels, edge_data=ed)
    pdir = tmp_path / "patterns" / "0"
    pdir.mkdir(parents=True)
    (pdir / "pattern_edge").write_text("0 1\n1 0\n")
    (pdir / "pattern_edge_data").write_text("0 1 0 5\n1 0 0 5\n")
    (pdir / "pattern_vertex_data").write_text("0 1\n1 2\n")
    (pdir / "pattern_stat").write_text("diameter : 2\n")
    (pdir / "pattern_nlc").write_text("")
    (pdir / "pattern_non_local_constraint").write_text("")
    return gj, labels, val_of, ed, db, pdir


@pytest.mark.parametrize("source", ["db", "file"])
def test_cli_edge_metadata(tmp_path, source, capsys):
    from fuzzypatternmatching_tpu.pattern.pattern_graph import load_pattern_graph

    gj, labels, val_of, ed, db, pdir = _cli_fixture(tmp_path)
    if source == "db":
        arg = "db"
    else:
        # each undirected edge listed once: the CLI gives both directions
        arg = str(tmp_path / "meta_")
        rows = [f"{u} {v} {w}\n" for (u, v), w in val_of.items()]
        (tmp_path / "meta_0").write_text("".join(rows[:2]))
        (tmp_path / "meta_1").write_text("".join(rows[2:]))
    out = str(tmp_path / "out")
    run_pattern_matching.main([
        "-i", db, "-p", str(tmp_path / "patterns"), "-o", out, "-e", arg,
        "--lcc-engine", "flat", "--device", "cpu",
    ])
    if source == "file":
        assert "matched 8/8 CSR directions" in capsys.readouterr().out
    pat = load_pattern_graph(str(pdir / "pattern"))
    ora = MatchOracle(gj, labels, pat, [], edge_data=ed).run()
    assert (3, 0) not in ora.active_edges and (0, 3) not in ora.active_edges
    want = JaxMatchEngine(
        gj, labels, pat, [], num_ranks=2, lcc_engine="flat", edge_data=ed
    ).run()
    assert want.active_edges == ora.active_edges
    assert want.active_vertices == ora.active_vertices
    res = str(tmp_path / "want")
    write_results(res, 0, want, labels, 2, pat.edge_count, pat.vertex_count, 0)
    assert _tree_files(out) == _tree_files(res)


def test_cli_edge_metadata_conflict_and_unmatched(tmp_path, capsys):
    _, _, _, _, db, _ = _cli_fixture(tmp_path)
    base = ["-i", db, "-p", str(tmp_path / "patterns"), "-o", str(tmp_path / "o"),
            "--device", "cpu", "-e"]
    (tmp_path / "bad").write_text("0 1 5\n1 0 6\n")
    with pytest.raises(SystemExit):
        run_pattern_matching.main(base + [str(tmp_path / "bad")])
    assert "conflicting edge metadata for (0, 1): 5 vs 6" in capsys.readouterr().err
    (tmp_path / "part").write_text("0 1 5\n")
    run_pattern_matching.main(base + [str(tmp_path / "part")])
    assert "WARNING: 6 graph edges have no metadata row" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # --mmap needs the sharded engine
        run_pattern_matching.main(base[:-1] + ["--mmap"])


# ------------------------------------------------- the driver's host state


def test_lazy_bucketed_state_roundtrip():
    """The compact continuation's host state in metadata mode: the driver
    reads it, and the NLCC's pair metadata, as it reads the device state
    it stands for; with_updates merges its marks on the host; made a
    device state (``_state_from_pairs``), a full lcc_call gives the eager
    state's rows, tv and alive pairs."""
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0), (1, 3)])
    gj = jax_from_edges(src, dst, num_vertices=4)
    g = port_graph(gj)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    pat = port_pattern(meta_pattern([(0, 1), (1, 0)], [1, 2], [5, 5], diameter=2))
    # 6 on the edges whose ends sum to an odd id: no pattern edge allows it
    ed = np.where((g.edge_row + g.cols) % 2 == 0, 5, 6).astype(np.int64)
    drv = MatchEngine(g, labels, pat, [], edge_data=ed, device="cpu")
    eng = drv.lcc
    assert drv._meta is not None and eng.meta_allow is not None
    eids = np.arange(g.num_edges, dtype=np.int64)[::2]
    tv = pat.label_match_bitset(labels).astype(np.uint32)
    host = _HostState(tv, g.edge_row[eids].astype(np.int64), g.cols[eids].astype(np.int64),
                      np.empty(0, dtype=np.int64))
    eager = eng.state_from_edge_ids(tv, eids)
    for a, b in zip(drv._host_state(host)[:3], drv._host_state(eager)[:3]):
        assert (a == b).all()
    csr_h = drv._alive_csr(host.arow, host.acol, None, tv, host)
    csr_e = drv._alive_csr(host.arow, host.acol, None, tv, eager)
    assert (csr_h.meta == csr_e.meta).all() and (csr_h.col == csr_e.col).all()
    assert set(csr_h.meta.tolist()) == {0, 1}
    tv2 = tv.copy()
    tv2[3] = 0
    host2 = drv._with_updates(host, tv2, [int(eids[0])])
    assert isinstance(host2, _HostState) and host2.marks.tolist() == [int(eids[0])]
    eager2 = drv._with_updates(eager, tv2, [int(eids[0])])
    dev = drv._state_from_pairs(host2.tv, host2.arow, host2.acol, host2.marks)
    for a, b in ((dev.tv, eager2.tv), (dev.alive, eager2.alive), (dev.tp_flag, eager2.tp_flag)):
        assert (a == b).all()
    sl, rl, dl = eng.lcc_call(dev, False, n_steps=2)
    se, re, de = eng.lcc_call(eager2, False, n_steps=2)
    assert [r[:3] for r in rl] == [r[:3] for r in re] and dl == de
    assert (sl.tv == se.tv).all()
    for a, b in zip(eng.alive_pairs(sl), eng.alive_pairs(se)):
        assert (a == b).all()


# ---------------------------------------------- the tree corpus, compact


def _tree_config(scale):
    """(JAX graph, labels, port graph, JAX and port tree corpora with their
    pattern_edge_data) at an R-MAT scale of the golden recipe."""
    gj = jax_from_edges(*_rmat_edges(scale), num_vertices=1 << scale)
    g = golden.build_config(scale, os.path.join(REPO, "examples", "patterns", "0", "pattern"))
    with tempfile.TemporaryDirectory() as tmp:
        pj, cjs = jax_builtin.load_tree_pattern(tmp + "/jax")
        pt, cs = builtin.load_tree_pattern(tmp + "/port")
    assert pt.edge_data is not None and set(pt.edge_data.tolist()) == {55}
    return gj, g[1], g[0], (pj, cjs), (pt, cs)


def test_bucketed_compact_path_with_metadata():
    """R-MAT s11 + the port's built-in tree corpus (pattern_edge_data
    uniformly 55): uniform-55 graph metadata reproduces the no-metadata
    result; poisoning one edge of an enumerated walk changes it. The port
    equals the JAX engine (rows and per-rank counters) and the oracle."""
    gj, labels, g, (pj, cjs), (pt, cs) = _tree_config(11)
    ed55 = np.full(gj.num_edges, 55, dtype=np.int64)
    plain = MatchEngine(g, labels, pt, cs, device="cpu").run()
    runs = []
    for ed in (ed55, None):
        if ed is None:  # poison the first hop of one enumerated walk
            walks = [w for v in runs[0].subgraphs.values() for w in v]
            if not walks:
                break
            a, b = int(walks[0][0]), int(walks[0][1])
            ed = ed55.copy()
            both = ({int(gj.edge_row[e]), int(gj.cols[e])} == {a, b} for e in range(gj.num_edges))
            ed[np.fromiter(both, dtype=bool)] = 99
        rj = JaxMatchEngine(gj, labels, pj, cjs, edge_data=ed).run()
        o = MatchOracle(gj, labels, pj, cjs, edge_data=ed).run()
        for compact in (True, False):
            r = MatchEngine(g, labels, pt, cs, edge_data=ed, compact=compact,
                            device="cpu").run()
            results_equal(r, rj)
            results_equal(r, o, per_rank=False)
        runs.append(r)
    assert runs[0].active_vertices == plain.active_vertices
    assert runs[0].subgraphs == plain.subgraphs
    if len(runs) == 2:
        n_p = sum(len(v) for v in runs[1].subgraphs.values())
        assert n_p < sum(len(v) for v in runs[0].subgraphs.values())


@pytest.mark.parametrize("engine", ["bucketed", "flat"])
def test_tree_s13_all_edges_55_matches_golden(engine, tmp_path):
    """tree_s13 with every edge carrying 55: the result tree equals the
    committed golden one (12/22/6)."""
    g, labels, _, _ = golden.build_config(
        13, os.path.join(REPO, "examples", "patterns", "0", "pattern")
    )
    pattern, constraints = builtin.load_tree_pattern(str(tmp_path / "corpus"))
    eng = MatchEngine(
        g, labels, pattern, constraints, num_ranks=4, lcc_engine=engine,
        edge_data=np.full(g.num_edges, 55, dtype=np.int64), device="cpu",
    )
    assert eng._meta is not None
    r = eng.run()
    assert (len(r.active_vertices), len(r.active_edges)) == (12, 22)
    assert sum(len(v) for v in r.subgraphs.values()) == 6
    out = str(tmp_path / "out")
    write_results(out, 0, r, labels, 4, pattern.edge_count, pattern.vertex_count,
                  len(constraints))
    assert _tree_files(out) == _tree_files(os.path.join(GOLDEN_BASE, "tree_s13"))


# ------------------------------------------------- superstep by superstep


@pytest.mark.parametrize("counting", [False, True], ids=["meta", "meta_counting"])
@pytest.mark.parametrize("kind", ["bucketed", "flat"])
def test_metadata_supersteps_from_jax_state(rmat_s10, kind, counting):
    """Random symmetric metadata over {55, 56} on the tree corpus (56 is
    no pattern edge's value): the JAX engine's state continued in the port
    one superstep at a time, split hubs and 4 ranks."""
    gj, labels, pj, _ = rmat_s10
    rng = np.random.RandomState(7)
    vals = rng.choice([55, 56], p=[0.9, 0.1], size=gj.num_edges)
    ed = np.where(gj.edge_row < gj.cols, vals, vals[np.maximum(gj.rev_edge, 0)])
    vv, allow = pj.edge_meta_tables()
    code = np.where(ed == 55, 0, len(vv)).astype(np.int64)
    jx, po = superstep_pairs(rmat_s10, kind, counting=counting, edge_meta=(allow, code))
    assert assert_supersteps_from_jax(jx, po) > 0
