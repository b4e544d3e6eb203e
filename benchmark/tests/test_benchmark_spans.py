"""The readers of the program's spans and counters (``benchmark/spans.py``
and the five metrics that read it) on synthetic runs: hand-made device
intervals and spans, on two clocks that differ by an offset per search.

One search (milliseconds from its ``fpm.search`` start, on both clocks):
``fpm.lcc`` 10-40 (``.call`` 10-20, ``.compact`` 20-40, its ``.closure``
20-30), ``fpm.state`` 40-45, ``fpm.nlcc`` 50-90 (``.walk.host`` 50-60, an
interleaved ``fpm.lcc`` 60-80 with its ``.call`` 60-70, ``.marks`` 80-90),
``fpm.result`` 90-100. The device is busy 0-5, 15-18, 62-64 and 95-105 in
the first search and never in the second: idle LCC 27 + 18 and 50, NLCC 20
and 20, driver 5 + 10 + 5 and 30."""

import types

import pytest
import torch

from benchmark import run, spans
from benchmark.trace import Trace
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.utils.trace import Span

CUDA = torch.device("cuda")
MS = 1e-3
# (name, parent, start, end) in ms from the search's start
SPANS = [
    ("fpm.search", -1, 0, 100),
    ("fpm.lcc", 0, 10, 40),
    ("fpm.lcc.call", 1, 10, 20),
    ("fpm.lcc.compact", 1, 20, 40),
    ("fpm.lcc.compact.closure", 3, 20, 30),
    ("fpm.state", 0, 40, 45),
    ("fpm.nlcc", 0, 50, 90),
    ("fpm.nlcc.walk.host", 6, 50, 60),
    ("fpm.lcc", 6, 60, 80),
    ("fpm.lcc.call", 8, 60, 70),
    ("fpm.nlcc.marks", 6, 80, 90),
    ("fpm.result", 0, 90, 100),
]
# program clock (ns) of each traced search's fpm.search start, and trace
# clock (s) of its bench.search start: the offset rule places fpm.search at
# bench.search's start, and the device intervals are given from there
PROGRAM_NS = [5_000_000_000, 7_250_000_000, 9_000_000_000]
TRACE_S = [100.0, 100.5, 101.0]
LEAD = 20e-6  # bench.search's start before fpm.search's, as placed


def result(i, counters=None):
    r = MatchResult()
    base = PROGRAM_NS[i]
    r.spans = [
        Span(n, p, base + int(s * 1e6), base + int(e * 1e6)) for n, p, s, e in SPANS
    ]
    r.counters = counters or {}
    return r


def synthetic(results, device=CUDA, busy0=((0, 5), (15, 18), (62, 64), (95, 105))):
    """A run of three traced searches (the second raised: its result is
    None); the device busy only in the first."""
    searches = [(t - LEAD, t + 0.1) for t in TRACE_S]
    t0 = TRACE_S[0] - LEAD  # where the first search's fpm.search is placed
    device_ops = [("k", t0 + s * MS, t0 + e * MS) for s, e in busy0]
    r = run.Run("tree.default", {}, {}, device)
    r.results, r.traced = list(results), len(results)
    r.trace = Trace(searches, device_ops, [])
    return r


def two_searches(counters=(None, None)):
    return synthetic([result(0, counters[0]), None, result(2, counters[1])])


def test_idle_by_layer_innermost_and_interleaved():
    by_layer, by_span = spans.idle_split(two_searches())
    # the interleaved fpm.lcc inside fpm.nlcc counts as LCC
    assert by_layer["lcc"] == pytest.approx((45 + 50) / 2 * MS)
    assert by_layer["nlcc"] == pytest.approx((20 + 20) / 2 * MS)
    assert by_layer["driver"] == pytest.approx((20 + 30) / 2 * MS)
    assert by_span["fpm.lcc.compact"] == pytest.approx(10 * MS)  # its own time
    assert by_span["fpm.lcc.call"] == pytest.approx((7 + 10 + 8 + 10) / 2 * MS)
    assert by_span["fpm.search"] == pytest.approx((5 + 5 + 10 + 5) / 2 * MS)  # 0-10, 45-50
    assert by_span["fpm.result"] == pytest.approx((5 + 10) / 2 * MS)
    assert sum(by_span.values()) == pytest.approx(sum(by_layer.values()))


def test_the_layers_partition_the_idle_time_inside_the_search():
    r = two_searches()
    busy = r.trace.busy()
    idle = []
    for sp in spans.placed(r):
        a, b = sp[0][2], sp[0][3]
        inside = sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)
        idle.append((b - a) - inside)
    by_layer, _ = spans.idle_split(r)
    assert sum(by_layer.values()) == pytest.approx(sum(idle) / len(idle))
    assert sum(idle) / len(idle) == pytest.approx((85 + 100) / 2 * MS)


def test_spans_placed_by_the_search_span_offset():
    placed = spans.placed(two_searches())
    assert len(placed) == 2  # the search that raised is skipped, not shifted
    for sp, i in zip(placed, (0, 2)):
        assert sp[0][2] == pytest.approx(TRACE_S[i] - LEAD)
        assert sp[9][2] - sp[0][2] == pytest.approx(60 * MS)


@pytest.mark.parametrize("name", ["idle_lcc_s", "idle_nlcc_s", "idle_driver_s"])
def test_idle_readers(name):
    want = {"idle_lcc_s": 47.5, "idle_nlcc_s": 20.0, "idle_driver_s": 25.0}[name]
    assert run.reader(name)(two_searches()) == pytest.approx(want * MS)


NAMES = [
    "idle_lcc_s", "idle_nlcc_s", "idle_driver_s", "copy_bytes_per_search",
    "compact_builds_per_search",
]
COUNTS = ({"h2d_bytes": 100, "d2h_bytes": 50, "compact_builds": 1},
          {"h2d_bytes": 300, "d2h_bytes": 150, "compact_builds": 0})


@pytest.mark.parametrize("name", NAMES)
def test_none_off_the_card(name):
    off = synthetic([result(0, COUNTS[0])], device=torch.device("cpu"))
    assert run.reader(name)(off) is None
    untraced = synthetic([result(0, COUNTS[0])])
    untraced.trace = None
    assert run.reader(name)(untraced) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_from_a_program_without_spans(name):
    """What the parent program gives: results without the fields, or a
    search run with no profiler (empty fields)."""
    bare = synthetic([types.SimpleNamespace(rows=[]), None])
    assert run.reader(name)(bare) is None
    assert run.reader(name)(synthetic([MatchResult(), None])) is None


def test_counter_readers():
    r = two_searches(COUNTS)
    assert run.reader("copy_bytes_per_search")(r) == pytest.approx((150 + 450) / 2)
    assert run.reader("compact_builds_per_search")(r) == pytest.approx(0.5)
    zero = two_searches((dict(COUNTS[1]), dict(COUNTS[1])))
    assert run.reader("compact_builds_per_search")(zero) == 0
