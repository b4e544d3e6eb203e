"""The host-clock records of set-up (``utils/trace.py``: ``build``,
``search``, ``LOG``, ``setup_records``) on the CPU.

* Build: a ``MatchEngine`` build leaves one ``fpm.build`` record, its
  spans the constructor's (``fpm.build.lcc`` with ``.layout``, ``.codes``
  and ``.planes``; ``fpm.build.nlcc`` unless the NLCC stays on the host),
  each inside its parent, its ``h2d_bytes`` the bytes ``to_device`` moved.
* First search: a compact-route engine's first search leaves a record
  holding ``fpm.lcc.compact.build`` with its five children inside
  ``.compact.closure``; its second search leaves none, and the
  ``MatchResult`` of neither keeps a span.
* Profiled: a cache-miss search keeps the build spans on its result
  under ``.compact.closure``, leaves no record, and ``benchmark/spans.py``'s
  split by layer is the same with the build spans taken out.
* Off: outside a build and a first search, with no profiler, ``span()``
  is the shared no-op and ``record_function`` is never called; a record
  never calls it either. The recorder is reset after a build and a search
  that raised, which leave no record; the log keeps the newest
  ``LOG_SIZE``.
"""

import os

import numpy as np
import pytest
import torch

from benchmark import run as harness
from benchmark import spans as bench_spans
from benchmark.trace import Trace
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.utils import trace
from fuzzypatternmatching_tpu_torch.utils.trace import Span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(REPO, "examples", "patterns", "0", "pattern")
CYCLE = os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern")
LCC = ("fpm.build.lcc.layout", "fpm.build.lcc.codes", "fpm.build.lcc.planes")
CLOSURE = (
    "fpm.lcc.compact.build.keys", "fpm.lcc.compact.build.graph", "fpm.build.lcc",
    "fpm.lcc.compact.build.alive", "fpm.lcc.compact.build.slot_map",
)
BUILD_SPANS = {"fpm.lcc.compact.build", *CLOSURE, *LCC}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def configs():
    return {"tree": golden.build_config(13, TREE), "cycle": golden.build_config(13, CYCLE)}


def engine(cfg, **kw):
    return MatchEngine(*cfg, device="cpu", **kw)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def new_records(before):
    """The records ``LOG`` gained since it held ``before``."""
    log = list(trace.LOG)
    for i in range(len(log) - 1, -1, -1):
        if log[i] is before:
            return log[i + 1:]
    return log


def newest():
    return trace.LOG[-1] if trace.LOG else None


def tree_of(spans):
    """{index: [(child name, child index)]}, after checking that there is
    one root and that every span lies inside its parent."""
    assert [s.parent for s in spans].count(-1) == 1 and spans[0].parent == -1
    kids = {i: [] for i in range(len(spans))}
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if i:
            p = spans[s.parent]
            assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            kids[s.parent].append((s.name, i))
    return kids


@pytest.fixture
def opened(monkeypatch):
    """The ``record_function`` ranges opened while the test runs."""
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


@pytest.mark.parametrize("mode,nlcc", [("auto", True), ("host", False)])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_build_record(configs, corpus, mode, nlcc, monkeypatch, opened):
    moved = []
    real = trace.torch

    class Counted:
        """``torch`` for ``utils/trace.py``, with ``from_numpy``'s bytes
        counted: ``to_device`` is its one caller there."""

        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def from_numpy(a):
            moved.append(a.nbytes)
            return real.from_numpy(a)

    monkeypatch.setattr(trace, "torch", Counted())
    before = newest()
    e = engine(configs[corpus], nlcc_mode=mode)
    recs = new_records(before)
    assert len(recs) == 1
    rec = recs[0]
    assert rec.root == "fpm.build" and rec.engine == id(e)
    assert trace.setup_records() == (rec, None)
    kids = tree_of(rec.spans)
    assert rec.spans[0].name == "fpm.build"
    top = [n for n, _ in kids[0]]
    assert top == ["fpm.build.lcc"] + (["fpm.build.nlcc"] if nlcc else [])
    lcc = dict(kids[0])["fpm.build.lcc"]
    assert [n for n, _ in kids[lcc]] == list(LCC)
    assert all(not kids[i] for _, i in kids[lcc])
    assert len(rec.spans) == 5 + nlcc
    assert rec.counters["h2d_bytes"] == sum(moved) > 0
    assert set(rec.counters) == set(trace.COUNTERS)
    assert opened == []
    assert trace._current.get() is None


@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_first_search_record(configs, corpus, opened):
    e = engine(configs[corpus])
    build = newest()
    first = e.run()
    recs = new_records(build)
    assert len(recs) == 1 and recs[0].root == "fpm.search" and recs[0].engine == id(e)
    rec = recs[0]
    assert first.spans == [] and first.counters == {}
    assert trace.setup_records() == (build, rec)
    kids = tree_of(rec.spans)
    builds = [i for i, s in enumerate(rec.spans) if s.name == "fpm.lcc.compact.build"]
    assert len(builds) == 1 == rec.counters["compact_builds"]
    b = builds[0]
    assert rec.spans[rec.spans[b].parent].name == "fpm.lcc.compact.closure"
    assert [n for n, _ in kids[b]] == list(CLOSURE)
    sub = dict(kids[b])["fpm.build.lcc"]
    assert [n for n, _ in kids[sub]] == list(LCC)
    second = e.run()
    assert newest() is rec
    assert second.spans == [] and second.counters == {}
    assert trace.setup_records() == (build, rec)
    assert opened == []
    assert trace._current.get() is None


def test_full_plane_first_search_builds_no_closure(configs):
    e = engine(configs["tree"], compact=False)
    e.run()
    build, first = trace.setup_records()
    assert build.engine == first.engine == id(e)
    assert first.counters["compact_builds"] == 0
    assert not {s.name for s in first.spans} & BUILD_SPANS


def _without(spans, names):
    """``spans`` less those named in ``names``, each child moved to its
    nearest kept ancestor."""
    index, out = {}, []
    for i, s in enumerate(spans):
        if s.name in names:
            index[i] = index.get(s.parent, -1)
            continue
        index[i] = len(out)
        out.append(Span(s.name, index.get(s.parent, -1), s.start_ns, s.end_ns))
    return out


def _synthetic(results, timed):
    """A traced run of ``results`` on a card, as the harness reads it:
    each search placed at its own start, the device busy in the middle
    third of every LCC call and plane upload of ``timed``."""
    searches, device, t = [], [], 100.0
    for r in timed:
        t0 = r.spans[0].start_ns
        dur = (r.spans[0].end_ns - t0) * 1e-9
        searches.append((t, t + dur))
        for s in r.spans:
            if s.name in ("fpm.lcc.call", "fpm.build.lcc.planes"):
                a, b = (s.start_ns - t0) * 1e-9, (s.end_ns - t0) * 1e-9
                device.append(("k", t + a + (b - a) / 3, t + a + 2 * (b - a) / 3))
        t += dur + 1.0
    run = harness.Run("tree.default", {}, {}, torch.device("cuda"))
    run.results, run.traced = list(results), len(results)
    run.trace = Trace(searches, device, [])
    return run


@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_profiled_miss_keeps_the_build_spans(configs, corpus):
    e = engine(configs[corpus])
    build = newest()
    with profiled() as prof:
        r = e.run()
    assert newest() is build  # a profiled first search leaves no record
    assert trace.setup_records() == (build, None)
    kids = tree_of(r.spans)
    b = [i for i, s in enumerate(r.spans) if s.name == "fpm.lcc.compact.build"]
    assert len(b) == 1 and r.spans[r.spans[b[0]].parent].name == "fpm.lcc.compact.closure"
    assert [n for n, _ in kids[b[0]]] == list(CLOSURE)
    ranges = {ev.key for ev in prof.key_averages()}
    assert BUILD_SPANS <= ranges
    # every build span counts in the LCC layer, as its .closure does
    for i in range(len(r.spans)):
        if r.spans[i].name in BUILD_SPANS:
            j = i
            while r.spans[j].name not in ("fpm.lcc", "fpm.nlcc"):
                j = r.spans[j].parent
            assert r.spans[j].name == "fpm.lcc"
    bare = MatchResult()
    bare.spans, bare.counters = _without(r.spans, BUILD_SPANS), dict(r.counters)
    with_layers, with_spans = bench_spans.idle_split(_synthetic([r], [r]))
    bare_layers, bare_spans = bench_spans.idle_split(_synthetic([bare], [r]))
    assert with_layers == pytest.approx(bare_layers, rel=1e-12, abs=1e-15)
    closure = "fpm.lcc.compact.closure"
    moved = sum(v for k, v in with_spans.items() if k in BUILD_SPANS)
    assert moved > 0
    assert bare_spans[closure] - with_spans.get(closure, 0.0) == pytest.approx(moved, rel=1e-9)


def test_off_outside_a_record(configs, opened):
    e = engine(configs["tree"])
    e.run()
    assert not trace.profiling() and trace._current.get() is None
    assert trace.span("fpm.lcc") is trace._OFF
    assert trace.search(MatchResult()) is trace._OFF
    rec = newest()
    for _ in range(2):
        r = e.run()
        assert r.spans == [] and r.counters == {}
    assert newest() is rec
    # a sub-engine built with no recorder open records nothing
    g, labels, pattern, _ = configs["tree"]
    BucketedLccEngine(g, np.asarray(labels, dtype=np.uint64), pattern, device="cpu")
    assert newest() is rec
    assert opened == []


def test_recorder_reset_after_a_raise(configs, monkeypatch):
    rec = newest()

    def broken(*a, **kw):
        raise RuntimeError("planted")

    with monkeypatch.context() as m:
        m.setattr(BucketedLccEngine, "_build_planes", broken)
        with pytest.raises(RuntimeError, match="planted"):
            engine(configs["tree"])
    assert trace._current.get() is None and newest() is rec
    e = engine(configs["tree"])
    build = newest()
    with monkeypatch.context() as m:
        m.setattr(MatchEngine, "_host_state", broken)
        with pytest.raises(RuntimeError, match="planted"):
            e.run()
    assert trace._current.get() is None and newest() is build
    assert trace.setup_records() == (build, None)
    e.run()  # the engine's first search was the one that raised
    assert newest() is build


def test_log_stays_bounded():
    for i in range(3 * trace.LOG_SIZE):
        with trace.build(-1 - i):
            with trace.span("fpm.build.lcc"):
                trace.count("h2d_bytes", i)
    assert len(trace.LOG) == trace.LOG_SIZE
    build, first = trace.setup_records()
    assert build.engine == -3 * trace.LOG_SIZE and first is None
    assert build.counters["h2d_bytes"] == 3 * trace.LOG_SIZE - 1
    assert [s.name for s in build.spans] == ["fpm.build", "fpm.build.lcc"]
    with trace.search(MatchResult(), build.engine):
        pass
    assert trace.setup_records() == (build, trace.LOG[-1])
    assert len(trace.LOG) == trace.LOG_SIZE
