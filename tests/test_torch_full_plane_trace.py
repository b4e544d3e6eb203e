"""The LCC's slot counter and the alive-pairs span (``utils/trace.py``,
``engine/lcc_bucketed.py``) on the CPU, on the full plane
(``compact=False``) and on the compact route.

* ``lcc_slots``: each superstep adds the ``num_slots`` of the engine that
  ran it. On the full plane that is the search's LP rows times the full
  engine's slots; on the compact route the full engine's init superstep
  plus the sub-engine's slots times its supersteps.
* ``fpm.pairs`` opens inside the span that reads the pairs (the state
  read, the first phase's download, ``.compact.back``), only where the
  state does not hold them already.
* With no profiler recording, nothing is kept and no range opens.
* The span moves no idle time between layers: ``benchmark/spans.py``'s
  split by layer is the same with the search's ``fpm.pairs`` spans taken
  out, and by span their idle time goes back to their parents.
"""

import os

import pytest
import torch

from benchmark import run as harness
from benchmark import spans as bench_spans
from benchmark.trace import Trace
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.utils import trace
from fuzzypatternmatching_tpu_torch.utils.trace import Span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(REPO, "examples", "patterns", "0", "pattern")
CYCLE = os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern")
PAIRS = "fpm.pairs"
READERS = {"fpm.state", "fpm.lcc.download", "fpm.lcc.compact.back"}


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


def lp_rows(r):
    return sum(x.phase == "LP" for x in r.rows)


@pytest.mark.parametrize("mode", ["auto", "host", "device"])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_slots_on_the_full_plane(configs, corpus, mode):
    e = engine(configs[corpus], compact=False, nlcc_mode=mode)
    with profiled():
        r = e.run()
    assert lp_rows(r) >= e.pattern.diameter
    assert r.counters["lcc_slots"] == lp_rows(r) * e.lcc.num_slots > 0


@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_slots_on_the_compact_route(configs, corpus):
    """The init superstep on the full engine, every later one on the
    cached closure's sub-engine: in the search that builds it and in the
    next, which finds it cached."""
    e = engine(configs[corpus])
    with profiled():
        first, second = e.run(), e.run()
    sub = e._sub_cache[4]
    assert sub.num_slots < e.lcc.num_slots
    for r in (first, second):
        want = e.lcc.num_slots + (lp_rows(r) - 1) * sub.num_slots
        assert r.counters["lcc_slots"] == want


def test_slots_counted_per_superstep(configs):
    """One LCC call per superstep (``superstep_timing``) counts what one
    call over all of them does."""
    one = engine(configs["tree"], compact=False)
    each = engine(configs["tree"], compact=False, superstep_timing=True)
    with profiled():
        a, b = one.run(), each.run()
    assert a.counters["lcc_slots"] == b.counters["lcc_slots"] == lp_rows(b) * one.lcc.num_slots


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_pairs_span_inside_its_reader(configs, corpus, compact):
    e = engine(configs[corpus], compact=compact)
    with profiled():
        r = e.run()
    pairs = [s for s in r.spans if s.name == PAIRS]
    assert pairs
    for s in pairs:
        p = r.spans[s.parent]
        assert p.name in READERS, p.name
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    if corpus == "tree" and not compact:
        # one LCC phase: its state is read once for the NLCC; the final
        # read finds the pairs kept on the updated state
        assert [r.spans[s.parent].name for s in pairs] == ["fpm.state"]
    if corpus == "tree" and compact:
        # the init state's download and the sub-engine's pairs in .back;
        # the host state is read in place after that
        assert sorted(r.spans[s.parent].name for s in pairs) == [
            "fpm.lcc.compact.back", "fpm.lcc.download",
        ]


def test_pairs_span_only_when_not_cached(configs):
    e = engine(configs["tree"], compact=False)
    r = MatchResult()
    with profiled(), trace.search(r):
        state, _, _ = e.lcc.lcc_call(e.lcc.init_state(), True)
        with trace.span("fpm.state"):
            first = e.lcc.alive_pairs(state)
            again = e.lcc.alive_pairs(state)
        kept = e.lcc.with_updates(state, e.lcc.tv_host(state), [])
        with trace.span("fpm.result"):
            e.lcc.alive_pairs(kept)
    assert again is first
    names = [(s.name, r.spans[s.parent].name) for s in r.spans if s.name == PAIRS]
    assert names == [(PAIRS, "fpm.state")]
    assert r.counters["lcc_slots"] == e.pattern.diameter * e.lcc.num_slots


@pytest.mark.parametrize("compact", [True, False])
def test_off_keeps_nothing(configs, compact, monkeypatch):
    e = engine(configs["tree"], compact=compact)
    calls = []
    real = torch.profiler.record_function

    def opened(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", opened)
    assert not trace.profiling()
    for _ in range(2):
        r = e.run()
        assert r.spans == [] and r.counters == {}
    assert calls == []
    assert trace._current.get() is None


def _without(spans, name):
    """``spans`` with every span called ``name`` taken out, each child
    moved to its nearest kept ancestor."""
    index, out = {}, []
    for i, s in enumerate(spans):
        if s.name == name:
            index[i] = index.get(s.parent, -1)
            continue
        index[i] = len(out)
        out.append(Span(s.name, index.get(s.parent, -1), s.start_ns, s.end_ns))
    return out


def _synthetic(results, timed):
    """A traced run of ``results`` on a card (as the harness reads it):
    each search placed at its own start, the device busy in the middle of
    every LCC call and of every pairs sweep of ``timed``, the same
    searches' spans with the pairs sweeps in them."""
    searches, device, t = [], [], 100.0
    for r in timed:
        t0 = r.spans[0].start_ns
        dur = (r.spans[0].end_ns - t0) * 1e-9
        searches.append((t, t + dur))
        for s in r.spans:
            if s.name in ("fpm.lcc.call", PAIRS):
                a, b = (s.start_ns - t0) * 1e-9, (s.end_ns - t0) * 1e-9
                device.append(("k", t + a + (b - a) / 3, t + a + 2 * (b - a) / 3))
        t += dur + 1.0
    run = harness.Run("tree.full_plane", {}, {}, torch.device("cuda"))
    run.results, run.traced = list(results), len(results)
    run.trace = Trace(searches, device, [])
    return run


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_pairs_span_leaves_the_layers_as_they_were(configs, corpus, compact):
    e = engine(configs[corpus], compact=compact)
    with profiled():
        results = [e.run(), e.run()]
    assert all(any(s.name == PAIRS for s in r.spans) for r in results)
    bare = []
    for r in results:
        b = MatchResult()
        b.spans, b.counters = _without(r.spans, PAIRS), dict(r.counters)
        bare.append(b)
    with_layers, with_spans = bench_spans.idle_split(_synthetic(results, results))
    bare_layers, bare_spans = bench_spans.idle_split(_synthetic(bare, results))
    assert with_layers == pytest.approx(bare_layers, rel=1e-12, abs=1e-15)
    assert with_spans[PAIRS] > 0 and PAIRS not in bare_spans
    # the sweep's idle time goes back to the spans that called it
    moved = {k: bare_spans.get(k, 0.0) - with_spans.get(k, 0.0) for k in READERS}
    assert sum(moved.values()) == pytest.approx(with_spans[PAIRS], rel=1e-9)
    assert all(v >= -1e-15 for v in moved.values())
