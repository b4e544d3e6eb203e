"""The compact path's closure cache (``MatchEngine._closure``) on the CPU.

An LCC phase's alive set only shrinks within a search, so every later
phase's alive set lies inside the closure the first phase built. A later
phase starts from the previous phase's sub-engine state on the device
(counter ``compact_state_carries``, ``tests/test_torch_compact_carry.py``);
a host state that carries none is served from that closure by the subset
test (counter ``compact_subset_hits``). The cache keeps the closure, so a
rerun's first phase hits it exactly and builds nothing (counter
``compact_builds``). The slots of the larger closure outside the alive
set's own are dead both ways, so every result equals a full-plane engine's
(``compact=False``), the committed golden tree and a fresh build's:

* the triangle (cycle_s13: three LCC phases a search) with every NLCC
  placement, counting, edge metadata and on a two-shard mesh, searched
  twice on one engine: 1 build, no subset hit and 2 carries, then 0, 0
  and 2;
* a live vertex that touches no alive pair but has a row in the cached
  closure: the larger engine kills it and raises ``died``, as the full
  engine does; a fresh build of the smaller closure has no row for it,
  zeroes its tv, and ``MatchEngine`` raises ``died``;
* the driver's host state with an empty alive set, the one kind that
  reaches the full engine, against the device state it stands for.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine, _HostState
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.io.results import write_results
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
    load_nonlocal_constraints,
)
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_golden_results import _tree_files
from test_torch_trace import plain, profiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLE_DIR = os.path.join(REPO, "examples", "patterns_cycle", "0")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden_meta():
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cycle13(golden_meta):
    cfg = golden_meta["configs"]["cycle_s13"]
    return golden.build_config(cfg["scale"], os.path.join(REPO, cfg["corpus"]))


def twice(eng):
    """Two searches on one engine under the profiler, so each keeps its
    counters."""
    with profiled():
        return eng.run(), eng.run()


def pair_keys(arow, acol, v):
    return arow.astype(np.int64) * v + acol


def reuse_counts(r):
    return (r.counters["compact_builds"], r.counters["compact_subset_hits"],
            r.counters["compact_state_carries"])


def assert_golden(r, meta, labels, pattern, constraints, tmp_path):
    cfg = meta["configs"]["cycle_s13"]
    assert r.iterations == cfg["iterations"]
    assert len(r.active_vertices) == cfg["active_vertices"]
    assert len(r.active_edges) == cfg["active_edges"]
    assert sum(len(v) for v in r.subgraphs.values()) == cfg["subgraphs"]
    out = str(tmp_path / "out")
    write_results(out, 0, r, labels, meta["num_ranks"], pattern.edge_count,
                  pattern.vertex_count, len(constraints))
    assert _tree_files(out) == _tree_files(os.path.join(golden.GOLDEN_BASE, "cycle_s13"))


@pytest.mark.parametrize(
    "kw",
    [{"nlcc_mode": "host"}, {"nlcc_mode": "device"}, {"nlcc_mode": "auto"},
     {"counting": True}],
    ids=["host", "device", "auto", "counting"],
)
def test_cycle_reruns_reuse_the_closure(golden_meta, cycle13, kw, tmp_path):
    nr = golden_meta["num_ranks"]
    eng = MatchEngine(*cycle13, num_ranks=nr, device="cpu", **kw)
    first, second = twice(eng)
    assert reuse_counts(first) == (1, 0, 2)
    assert reuse_counts(second) == (0, 0, 2)
    full = MatchEngine(*cycle13, num_ranks=nr, compact=False, device="cpu", **kw).run()
    assert plain(first) == plain(second) == plain(full)
    assert_golden(second, golden_meta, *cycle13[1:], tmp_path)


def test_edge_metadata_reruns_reuse_the_closure(golden_meta, cycle13, tmp_path):
    """The triangle with 55 on every pattern edge and every graph edge:
    metadata mode on (each constraint on the host NLCC), the plain search's
    result, and the closure's edge metadata served with it."""
    corpus = tmp_path / "0"
    shutil.copytree(CYCLE_DIR, corpus)
    edges = (corpus / "pattern_edge").read_text().split("\n")
    rows = [f"{ln} {i} 55" for i, ln in enumerate(e for e in edges if e.strip())]
    (corpus / "pattern_edge_data").write_text("\n".join(rows) + "\n")
    prefix = str(corpus / "pattern")
    pattern = load_pattern_graph(prefix)
    constraints = load_nonlocal_constraints(prefix)
    assert pattern.edge_data is not None
    g, labels = cycle13[:2]
    nr = golden_meta["num_ranks"]
    ed = np.full(g.num_edges, 55, dtype=np.int64)
    eng = MatchEngine(g, labels, pattern, constraints, num_ranks=nr, edge_data=ed,
                      device="cpu")
    assert eng._meta is not None
    first, second = twice(eng)
    assert reuse_counts(first) == (1, 0, 2)
    assert reuse_counts(second) == (0, 0, 2)
    full = MatchEngine(g, labels, pattern, constraints, num_ranks=nr, edge_data=ed,
                       compact=False, device="cpu").run()
    no_meta = MatchEngine(*cycle13, num_ranks=nr, device="cpu").run()
    assert plain(first) == plain(second) == plain(full) == plain(no_meta)


def test_mesh_compact_reruns_reuse_the_closure(golden_meta, cycle13):
    """The mesh's compact continuation runs on its first device with the
    same cache."""
    nr = golden_meta["num_ranks"]
    kw = dict(num_ranks=nr, lcc_engine="sharded", nlcc_mode="device")
    eng = MatchEngine(*cycle13, mesh=build_mesh(shards=2, device="cpu"), **kw)
    first, second = twice(eng)
    assert reuse_counts(first) == (1, 0, 2)
    assert reuse_counts(second) == (0, 0, 2)
    full = MatchEngine(*cycle13, mesh=build_mesh(shards=2, device="cpu"),
                       compact=False, **kw).run()
    assert plain(first) == plain(second) == plain(full)


def test_lone_live_vertex_dies_on_every_route(golden_meta, cycle13):
    """The first alive set's closure cached, LCC phases run on it to a state
    in which none dies; then a dead vertex x with a row in the cached
    closure and no alive pair is given a template bit. Served from the
    cached closure, whose engine kills x by its keep rule, from a fresh
    build of the smaller closure, which has no row for x, and on the full
    engine, the phase returns the same state: x's tv zeroed, ``died``
    raised (by x alone), the same alive pairs and LP rows."""
    eng = MatchEngine(*cycle13, num_ranks=golden_meta["num_ranks"], device="cpu")
    lcc = eng.lcc
    steps = eng.pattern.diameter - 1
    state, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    for _ in range(20):
        tv, arow, acol, _ = eng._host_state(state)
        state, _, died = eng._compact_call(tv, arow, acol, steps, None)
        # the sub-engine's alive pairs lie inside its input pairs, so the
        # driver's host state takes them unfiltered
        assert np.isin(pair_keys(state.arow, state.acol, len(tv)),
                       pair_keys(arow, acol, len(tv))).all()
        if not died:
            break
    assert not died
    primed = eng._sub_cache
    v = np.uint64(len(tv))
    in_closure = np.zeros(len(tv), dtype=bool)
    in_closure[(primed[2] // v).astype(np.int64)] = True
    touched = np.zeros(len(tv), dtype=bool)
    touched[arow] = touched[acol] = True
    cand = np.flatnonzero((tv == 0) & in_closure & ~touched)
    assert len(cand) > 0
    x = int(cand[0])
    tv[x] = 1

    cached = eng._compact_call(tv, arow, acol, steps, None)
    assert eng._sub_cache is primed  # served from it, and kept
    eng._sub_cache = None
    fresh = eng._compact_call(tv, arow, acol, steps, None)
    assert eng._sub_cache is not primed
    full = lcc.lcc_call(eng._state_from_pairs(tv, arow, acol), False, n_steps=steps)

    def read(res):
        # the compact routes return the driver's host state, the full
        # engine a device state
        st, rows, died = res
        tv_r, arow_r, acol_r, _ = eng._host_state(st)
        return (
            tv_r.tolist(), [arow_r.tolist(), acol_r.tolist()],
            [(r[:3], {k: a.tolist() for k, a in r[3].items()}) for r in rows], died,
        )

    assert read(cached) == read(fresh) == read(full)
    assert cached[2] is True
    assert cached[0].tv[x] == 0


@pytest.mark.parametrize("shards", [0, 2], ids=["bucketed", "mesh"])
def test_empty_host_state_meets_the_full_engine(golden_meta, cycle13, shards):
    """A host state whose alive set is empty is the one that reaches the
    full engine (a compact phase's output lies inside its input, at most
    E/4). Made a device state there, its phase gives the LP rows,
    ``died``, tv and alive pairs of the device state with the same tv and
    no alive slot."""
    kw = {"mesh": build_mesh(shards=shards, device="cpu")} if shards else {"device": "cpu"}
    eng = MatchEngine(*cycle13, num_ranks=golden_meta["num_ranks"], **kw)
    lcc = eng.lcc
    state, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv = lcc.tv_host(state).copy()
    assert (tv != 0).any()
    none = np.empty(0, dtype=np.int64)
    marks = np.array([0, 5], dtype=np.int64)
    host = _HostState(tv, none, none, marks)

    def phase(st):
        res = MatchResult()
        st2, died = eng._lcc_calls(st, False, 1, res, None)
        tv2, arow, acol, _ = eng._host_state(st2)
        rows = [(r.itr, r.step, r.active_vertices, r.active_edges, r.messages,
                 {k: a.tolist() for k, a in r.per_rank.items()}) for r in res.rows]
        return rows, died, tv2.tolist(), arow.tolist(), acol.tolist()

    got = phase(host)
    want = phase(lcc.state_from_edge_ids(tv, none, flag_ids=marks))
    assert got == want
    assert got[1] is True and not any(got[2])  # every live vertex died
    assert len(got[0]) == eng.pattern.diameter


def test_host_state_updates_copy_and_leave_the_original(golden_meta, cycle13):
    """``_with_updates`` on a host state returns a new one and leaves the
    original's tv and marks as they were; ``_host_state`` hands out a copy
    of tv, which the NLCC deletes sources from in place."""
    eng = MatchEngine(*cycle13, num_ranks=golden_meta["num_ranks"], device="cpu")
    lcc = eng.lcc
    state, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv, arow, acol, _ = eng._host_state(state)
    host, _, _ = eng._compact_call(tv, arow, acol, eng.pattern.diameter - 1, None)
    assert isinstance(host, _HostState) and len(host.arow) > 0
    tv0, marks0 = host.tv.copy(), host.marks.copy()
    tv1, arow1, acol1, _ = eng._host_state(host)
    assert np.array_equal(tv1, tv0) and arow1 is host.arow and acol1 is host.acol
    tv1[np.flatnonzero(tv1)[::2]] = 0
    eid = int(np.searchsorted(eng._edge_keys_cached(),
                              np.uint64(arow1[0]) * np.uint64(len(tv1)) + np.uint64(acol1[0])))
    upd = eng._with_updates(host, tv1, [eid, eid])
    assert np.array_equal(host.tv, tv0) and np.array_equal(host.marks, marks0)
    assert np.array_equal(upd.tv, tv1) and upd.tv is not tv1 and upd.tv.dtype == np.uint32
    assert upd.marks.tolist() == [eid]
    assert eng._with_updates(upd, tv1, []).marks is upd.marks
