"""The counting LCC's span and counters (``engine/lcc_bucketed.py``,
``utils/trace.py``) on the CPU, on the upstream tree with template vertex 0
relabelled 7 (the benchmark's counting template, where vertex 1 needs two
label-7 neighbours) and on the upstream tree itself.

* Every superstep of the counting mode opens one ``fpm.lcc.count`` span,
  inside an LCC call span (``fpm.lcc.call`` or ``fpm.lcc.compact.call``),
  and counts one ``lcc_count_supersteps``: as many as the search's LP rows,
  on the compact route and the full plane, on every NLCC route.
* ``lcc_count_passes`` counts each bucket's class-count reductions
  dispatched from Python, here the plain twin's: the template's (i, j)
  requirements per bucket per superstep. ``lcc_count_fused`` counts the
  supersteps run as one launch on the card, so 0 on the CPU.
* The default mode opens no such span and counts 0 of all three; with no
  profiler recording, the counting mode keeps no span or counter and opens
  no range.
* The counting search's results are the same with tracing on and off.
"""

import os

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(REPO, "examples", "patterns", "0", "pattern")
CYCLE = os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern")
TWO_SEVENS = os.path.join(
    REPO, "benchmark", "templates", "rmat_log2_tree_pattern_0_two_sevens", "pattern"
)
CALLS = {"fpm.lcc.call", "fpm.lcc.compact.call"}
KEYS = ("lcc_count_supersteps", "lcc_count_passes", "lcc_count_fused")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def configs():
    return {
        "two_sevens": golden.build_config(13, TWO_SEVENS),
        "tree": golden.build_config(13, TREE),
        "cycle": golden.build_config(13, CYCLE),
    }


def engine(cfg, **kw):
    return MatchEngine(*cfg, device="cpu", **kw)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def lp_rows(r):
    return sum(x.phase == "LP" for x in r.rows)


@pytest.mark.parametrize("mode", ["auto", "host", "device"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("corpus", ["two_sevens", "tree"])
def test_count_span_in_each_lcc_call(configs, corpus, compact, mode):
    e = engine(configs[corpus], counting=True, compact=compact, nlcc_mode=mode)
    with profiled():
        r = e.run()
    spans = r.spans
    counted = [s for s in spans if s.name == "fpm.lcc.count"]
    assert counted
    for s in counted:
        p = spans[s.parent]
        assert p.name in CALLS, p.name
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert len(counted) == r.counters["lcc_count_supersteps"] == lp_rows(r)
    assert trace._current.get() is None


@pytest.mark.parametrize("compact", [True, False])
def test_passes_per_bucket_and_superstep(configs, compact):
    """The init superstep's buckets on the full engine, the later ones on
    the compact sub-engine (or the full engine on the full plane), each
    bucket one reduction per (i, j) requirement."""
    e = engine(configs["two_sevens"], counting=True, compact=compact)
    e.run()  # the compact closure, built once
    with profiled():
        r = e.run()
    per_bucket = int((e.lcc.required > 0).sum())
    steps = lp_rows(r)
    later = e._sub_cache[4] if compact else e.lcc
    want = per_bucket * (len(e.lcc.buckets) + (steps - 1) * len(later.buckets))
    assert r.counters["lcc_count_passes"] == want
    assert r.iterations == 1 and steps == e.pattern.diameter


@pytest.mark.parametrize("compact", [True, False])
def test_no_fused_count_on_the_cpu(configs, compact):
    """On the CPU the counting supersteps run the plain twin: its class
    counts are Python-side passes, and no superstep is a fused launch."""
    e = engine(configs["two_sevens"], counting=True, compact=compact)
    with profiled():
        r = e.run()
    assert r.counters["lcc_count_supersteps"] == lp_rows(r) > 0
    assert r.counters["lcc_count_passes"] > 0
    assert r.counters["lcc_count_fused"] == 0


@pytest.mark.parametrize("corpus", ["two_sevens", "tree", "cycle"])
def test_default_mode_counts_nothing(configs, corpus):
    e = engine(configs[corpus])
    with profiled():
        r = e.run()
    assert all(r.counters[k] == 0 for k in KEYS)
    assert "fpm.lcc.count" not in {s.name for s in r.spans}


def test_off_counting_records_nothing(configs, monkeypatch):
    e = engine(configs["two_sevens"], counting=True)
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
        assert all(r.counters.get(k, 0) == 0 for k in KEYS)
    assert calls == []


def _plain(r):
    return (
        [(x.itr, x.phase, x.step, x.active_vertices, x.active_edges, x.messages)
         for x in r.rows],
        list(r.pattern_found), r.iterations, dict(r.active_vertices),
        set(r.active_edges), {k: list(v) for k, v in r.subgraphs.items()},
        r.traversed_edges,
    )


@pytest.mark.parametrize("compact", [True, False])
def test_counting_results_unchanged_by_tracing(configs, compact):
    e = engine(configs["two_sevens"], counting=True, compact=compact)
    off = e.run()
    with profiled():
        on = e.run()
    assert _plain(on) == _plain(off)
    assert np.asarray(on.subgraphs.get(4, [])).size > 0
