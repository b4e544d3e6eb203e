"""What the full-plane cell (``tree.full_plane``) brings to the benchmark:
its configuration, the tree's with the compact continuation switched off;
the port on that route equal to the plain reference on small graphs, with
the constraints on the host, on the device and placed by ``"auto"``, and
equal row for row to the compact route; and the readers of the LCC's slot
counter and of the alive-pairs span (``lcc_slots_per_search``,
``idle_pairs_s``) on synthetic runs built as ``test_benchmark_spans``
builds them."""

import functools
import json
import os
import types

import pytest
import torch

from benchmark import compare, run, spans
from benchmark.tests import test_benchmark_reference as ref_tests
from benchmark.tests import test_benchmark_spans as span_tests
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.utils.trace import Span

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
TREE = os.path.join(BENCH_DIR, "templates", "rmat_log2_tree_pattern_0")
CPU = torch.device("cpu")
MS = span_tests.MS


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_config_is_the_tree_with_compact_off():
    tree, full = _config("rmat21-tree"), _config("rmat21-tree-full-plane")
    assert tree["engine"]["compact"] is True and full["engine"]["compact"] is False
    assert full["engine"] == {**tree["engine"], "compact": False}
    assert full["assumed"][:-1] == tree["assumed"]
    assert "compact continuation" in full["assumed"][-1]
    assert full["reduced"] == []
    same = set(tree) - {"engine", "assumed", "source"}
    assert set(full) == set(tree)
    assert {k: full[k] for k in same} == {k: tree[k] for k in same}
    assert len(full["source"]) <= 200


@functools.lru_cache(maxsize=None)
def _graph_and_reference(scale, seed):
    g, port = ref_tests.graph(scale, seed)
    return g, port, ref_tests.reference(g, TREE, False)


SCALES = [(13, 2**31 + 3), (14, 2**31 + 3), (15, 7), (16, 2**31 + 3)]
IDS = [f"s{s}" for s, _ in SCALES]


def _search(scale, seed, **kw):
    g, port, _ = _graph_and_reference(scale, seed)
    pattern, cons = ref_tests.port_inputs(TREE)
    return MatchEngine(port, g["labels"], pattern, cons, device="cpu", **kw).run()


@pytest.mark.parametrize("mode", ["host", "device", "auto"])
@pytest.mark.parametrize("scale,seed", SCALES, ids=IDS)
def test_full_plane_equals_reference(scale, seed, mode):
    got = _search(scale, seed, compact=False, nlcc_mode=mode)
    ref = _graph_and_reference(scale, seed)[2]
    assert compare.differences(compare.plain(got), ref) == dict.fromkeys(compare.LIMITS, 0)
    assert ref["traversed_edges"] > 0


@pytest.mark.parametrize("scale,seed", SCALES, ids=IDS)
def test_full_plane_equals_compact_row_for_row(scale, seed):
    """The LP and TP rows (each with its per-rank counts), the found flags,
    the subgraphs and the active sets: the route changes none of them."""
    full, comp = (
        _search(scale, seed, compact=c, nlcc_mode="auto", num_ranks=4) for c in (False, True)
    )

    def rows(r):
        return [
            (x.itr, x.phase, x.step, x.active_vertices, x.active_edges, x.messages,
             {k: list(map(int, v)) for k, v in (x.per_rank or {}).items()})
            for x in r.rows
        ]

    assert rows(full) == rows(comp)
    assert compare.plain(full) == compare.plain(comp)
    assert any(x.phase == "TP" for x in full.rows)


# one search (ms from its fpm.search start): the pairs swept in the first
# phase's download 22-28 and in .compact.back 35-38, and in a state read
# 41-44; the device busy 0-5, 23-24, 62-64 and 95-105 in the first search
# and never in the second
SWEPT = [
    ("fpm.search", -1, 0, 100),
    ("fpm.lcc", 0, 10, 40),
    ("fpm.lcc.call", 1, 10, 20),
    ("fpm.lcc.download", 1, 20, 30),
    ("fpm.pairs", 3, 22, 28),
    ("fpm.lcc.compact", 1, 30, 40),
    ("fpm.lcc.compact.back", 5, 34, 40),
    ("fpm.pairs", 6, 35, 38),
    ("fpm.state", 0, 40, 45),
    ("fpm.pairs", 8, 41, 44),
    ("fpm.nlcc", 0, 50, 90),
    ("fpm.nlcc.walk.host", 10, 50, 60),
    ("fpm.result", 0, 90, 100),
]
COUNTS = ({"lcc_slots": 726_209_024, "h2d_bytes": 10},
          {"lcc_slots": 726_209_000, "h2d_bytes": 10})
NAMES = ["lcc_slots_per_search", "idle_pairs_s"]


def swept(i, counters=None, layout=SWEPT):
    """``test_benchmark_spans.result`` with pairs sweeps."""
    r = MatchResult()
    base = span_tests.PROGRAM_NS[i]
    r.spans = [Span(n, p, base + int(s * 1e6), base + int(e * 1e6)) for n, p, s, e in layout]
    r.counters = counters or {}
    return r


def swept_run(device=span_tests.CUDA, layout=SWEPT):
    return span_tests.synthetic(
        [swept(0, COUNTS[0], layout), None, swept(2, COUNTS[1], layout)],
        device=device,
        busy0=((0, 5), (23, 24), (62, 64), (95, 105)),
    )


def test_idle_of_the_pairs_sweeps():
    """Idle under fpm.pairs: 6 + 3 + 3 ms a search, less 23-24 busy in the
    first."""
    assert run.reader("idle_pairs_s")(swept_run()) == pytest.approx((11 + 12) / 2 * MS)


def test_pairs_span_moves_no_idle_between_layers():
    """The sweeps are leaves inside the LCC phase's download and
    .compact.back (LCC) and the state read (driver): taken out, their idle
    time goes to those spans, and each layer keeps its own."""
    keep = [i for i, s in enumerate(SWEPT) if s[0] != "fpm.pairs"]
    at = {old: new for new, old in enumerate(keep)}
    bare = [(n, at.get(p, -1), s, e) for n, p, s, e in (SWEPT[i] for i in keep)]
    with_layers, with_spans = spans.idle_split(swept_run())
    bare_layers, bare_spans = spans.idle_split(swept_run(layout=bare))
    assert with_layers == pytest.approx(bare_layers)
    assert with_layers["lcc"] == pytest.approx((29 + 30) / 2 * MS)
    for name, pairs in (("fpm.lcc.download", (5, 6)), ("fpm.lcc.compact.back", (3, 3)),
                        ("fpm.state", (3, 3))):
        assert bare_spans[name] - with_spans[name] == pytest.approx(sum(pairs) / 2 * MS)


def test_slots_reader():
    assert run.reader("lcc_slots_per_search")(swept_run()) == 726_209_012


@pytest.mark.parametrize("name", NAMES)
def test_none_off_the_card(name):
    assert run.reader(name)(swept_run(device=CPU)) is None
    untraced = swept_run()
    untraced.trace = None
    assert run.reader(name)(untraced) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_span_or_counter(name):
    """What the parent program gives: results without the fields, a search
    run with no profiler, and searches with spans and counters but neither
    the pairs span nor the slot counter."""
    bare = span_tests.synthetic([types.SimpleNamespace(rows=[]), None])
    assert run.reader(name)(bare) is None
    assert run.reader(name)(span_tests.synthetic([MatchResult(), None])) is None
    assert run.reader(name)(span_tests.two_searches(span_tests.COUNTS)) is None
