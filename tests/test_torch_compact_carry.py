"""The compact route's device state carried between one search's LCC
phases (``MatchEngine._compact_call``), on the CPU.

A compact phase returns the driver's host state with the sub-engine it ran
on and that engine's output state beside it. The search's next phase, while
that engine is still the cached one, starts from the output's alive plane
as it is (counter ``compact_state_carries``): no closure lookup, no slot
planes built on the host. Its input must be what the lookup route rebuilds
(``_closure`` and ``state_from_edge_ids`` on the same tv, pairs and marks):

* the triangle (cycle_s13: an init phase and two later phases a search) on
  every route the closure-reuse tests run, each later phase's input tv,
  alive and tp_flag equal to the rebuilt ones, where a phase's marks lie on
  slots still alive in the next phase, which has none of its own (so an OR
  into the previous input's flags would differ); two carries and no subset
  hit a search, none on the tree (one LCC phase a search);
* a host state that carries no device state, or one of an engine that is no
  longer cached, takes the lookup (a subset hit) and gives the carried
  phase's result.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine, _HostState
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
    load_nonlocal_constraints,
)
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph
from fuzzypatternmatching_tpu_torch.utils import trace
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_torch_trace import plain, profiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLE_DIR = os.path.join(REPO, "examples", "patterns_cycle", "0")
ROUTES = ["host", "device", "auto", "counting", "metadata", "mesh"]


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


def config(golden_meta, name):
    cfg = golden_meta["configs"][name]
    return golden.build_config(cfg["scale"], os.path.join(REPO, cfg["corpus"]))


@pytest.fixture(scope="module")
def cycle13(golden_meta):
    return config(golden_meta, "cycle_s13")


def engine(route, cfg, nr, tmp_path):
    """The engine of one route, as the closure-reuse tests build it."""
    if route == "metadata":
        # the triangle with 55 on every pattern edge and every graph edge
        corpus = tmp_path / "0"
        shutil.copytree(CYCLE_DIR, corpus)
        edges = (corpus / "pattern_edge").read_text().split("\n")
        rows = [f"{ln} {i} 55" for i, ln in enumerate(e for e in edges if e.strip())]
        (corpus / "pattern_edge_data").write_text("\n".join(rows) + "\n")
        prefix = str(corpus / "pattern")
        g, labels = cfg[:2]
        eng = MatchEngine(
            g, labels, load_pattern_graph(prefix), load_nonlocal_constraints(prefix),
            num_ranks=nr, edge_data=np.full(g.num_edges, 55, dtype=np.int64),
            device="cpu",
        )
        assert eng._meta is not None
        return eng
    if route == "mesh":
        return MatchEngine(*cfg, num_ranks=nr, lcc_engine="sharded", nlcc_mode="device",
                           mesh=build_mesh(shards=2, device="cpu"))
    kw = {"counting": True} if route == "counting" else {"nlcc_mode": route}
    return MatchEngine(*cfg, num_ranks=nr, device="cpu", **kw)


def counts(r):
    return tuple(r.counters[k] for k in
                 ("compact_builds", "compact_subset_hits", "compact_state_carries"))


@pytest.mark.parametrize("route", ROUTES)
def test_carried_state_equals_the_rebuilt_one(golden_meta, cycle13, route,
                                              tmp_path, monkeypatch):
    eng = engine(route, cycle13, golden_meta["num_ranks"], tmp_path)
    inputs = []  # every sub-engine phase's input state, in order
    phases = []  # (its index in inputs, tv, arow, acol, marks) of each carried phase
    carried_in = []  # the input state each carried phase built
    real_call = BucketedLccEngine.lcc_call
    real_on_alive = BucketedLccEngine.state_on_alive
    real_compact = eng._compact_call

    def lcc_call(self, state, global_init_step, n_steps=None):
        if self is not eng.lcc:
            inputs.append(state)
        return real_call(self, state, global_init_step, n_steps)

    def state_on_alive(self, tv, alive, flag_ids=None):
        st = real_on_alive(self, tv, alive, flag_ids)
        carried_in.append(st)
        return st

    def compact_call(tv, arow, acol, steps_left, tp_mark_eids, carried=None):
        if carried is not None and carried.sub is not None:
            phases.append((len(inputs), tv.copy(), arow, acol,
                           None if tp_mark_eids is None else list(tp_mark_eids)))
        return real_compact(tv, arow, acol, steps_left, tp_mark_eids, carried=carried)

    monkeypatch.setattr(BucketedLccEngine, "lcc_call", lcc_call)
    monkeypatch.setattr(BucketedLccEngine, "state_on_alive", state_on_alive)
    eng._compact_call = compact_call
    with profiled():
        first, second = eng.run(), eng.run()
    assert counts(first) == (1, 0, 2)
    assert counts(second) == (0, 0, 2)
    assert plain(first) == plain(second)
    assert len(phases) == len(carried_in) == 4

    # today's route on the same inputs, against the one cached closure
    # (nothing is built after the first phase of the first search)
    sub = eng._sub_cache[4]
    earlier_marks_alive = False
    for (i, tv, arow, acol, marks), got in zip(phases, carried_in):
        assert inputs[i] is got
        union, alive_sub_eids, sub_l = eng._closure(arow, acol)
        assert sub_l is sub
        want = sub.state_from_edge_ids(
            tv, alive_sub_eids, flag_ids=eng._marks_in_closure(union, marks)
        )
        assert torch.equal(got.tv, want.tv)
        assert torch.equal(got.alive, want.alive)
        assert torch.equal(got.tp_flag, want.tp_flag)
        prev = inputs[i - 1].tp_flag
        earlier_marks_alive |= bool((prev & got.alive & ~got.tp_flag).any())
    # a phase's marks lie on slots alive in the next phase, which has none
    # of its own there: flags carried over from the previous input would show
    assert earlier_marks_alive


def test_tree_carries_nothing(golden_meta):
    """The tree runs one LCC phase a search: nothing is carried, and its one
    compact phase hits the cached closure exactly on a rerun."""
    eng = MatchEngine(*config(golden_meta, "tree_s13"),
                      num_ranks=golden_meta["num_ranks"], device="cpu")
    with profiled():
        first, second = eng.run(), eng.run()
    assert counts(first) == (1, 0, 0)
    assert counts(second) == (0, 0, 0)
    assert plain(first) == plain(second)


def test_uncarried_host_state_takes_the_lookup(golden_meta, cycle13):
    """A later phase from the carried host state, from the same state with
    no device state beside it, and from the carried state after the cache
    was rebuilt over the same closure (its engine no longer the cached
    one): the first carries, the other two are served by the subset test,
    and all three give the same tv, alive pairs, LP rows and ``died``."""
    eng = MatchEngine(*cycle13, num_ranks=golden_meta["num_ranks"], device="cpu")
    lcc = eng.lcc
    steps = eng.pattern.diameter - 1
    state, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv0, arow0, acol0, _ = eng._host_state(state)
    host, _, _ = eng._compact_call(tv0, arow0, acol0, steps, None)
    assert host.sub is eng._sub_cache[4] and len(host.arow) > 0
    # the NLCC's outcome, by hand: sources deleted, a few alive edges marked
    tv1 = host.tv.copy()
    tv1[np.flatnonzero(tv1)[::3]] = 0
    keys = host.arow.astype(np.uint64) * np.uint64(len(tv1)) + host.acol.astype(np.uint64)
    marks = np.searchsorted(eng._edge_keys_cached(), keys[::50]).tolist()
    upd = eng._with_updates(host, tv1, marks)
    assert upd.sub is host.sub and upd.sub_state is host.sub_state

    def phase(st):
        res = MatchResult()
        with profiled(), trace.search(res):
            out, died = eng._lcc_calls(st, False, 1, res, marks)
        rows = [(r.step, r.active_vertices, r.active_edges, r.messages,
                 {k: a.tolist() for k, a in r.per_rank.items()}) for r in res.rows]
        got = (out.tv.tolist(), out.arow.tolist(), out.acol.tolist(), rows, died)
        return got, counts(res)

    carried, n_carried = phase(upd)
    bare, n_bare = phase(_HostState(upd.tv, upd.arow, upd.acol, upd.marks))
    eng._sub_cache = None
    eng._closure(arow0, acol0)  # the same closure, a new engine
    assert eng._sub_cache[4] is not upd.sub
    stale, n_stale = phase(upd)
    assert n_carried == (0, 0, 1)
    assert n_bare == n_stale == (0, 1, 0)
    assert carried == bare == stale
