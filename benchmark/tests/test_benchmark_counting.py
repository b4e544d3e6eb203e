"""What the counting cell (``counting.default``) brings to the benchmark:
its template, the upstream tree with template vertex 0 relabelled 7; the
port under the counting LCC equal to the plain reference on small graphs,
with the constraints on the host, on the device and placed by ``"auto"``;
the count pruning in the LCC what the default rule leaves to the NLCC;
and the readers of the counting superstep's span and counter
(``lcc_count_roofline_pct``, ``idle_lcc_count_s``,
``lcc_count_passes_per_search``) on synthetic runs built as
``test_benchmark_spans`` builds them."""

import functools
import os
import types

import pytest
import torch

from benchmark import compare, run
from benchmark.reference import template
from benchmark.tests import test_benchmark_reference as ref_tests
from benchmark.tests import test_benchmark_spans as span_tests
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.utils.trace import Span

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH_DIR)
TWO_SEVENS = os.path.join(BENCH_DIR, "templates", "rmat_log2_tree_pattern_0_two_sevens")
UPSTREAM = os.path.join(REPO, "examples", "patterns", "0")
CPU = torch.device("cpu")
MS = span_tests.MS


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _read(directory, name):
    with open(os.path.join(directory, f"pattern_{name}")) as f:
        return f.read()


def _vertex_labels(directory):
    return dict(tuple(map(int, r.split())) for r in _read(directory, "vertex_data").splitlines())


def test_template_is_the_tree_with_vertex_0_relabelled():
    for f in ("edge", "stat", "non_local_constraint"):
        assert _read(TWO_SEVENS, f) == _read(UPSTREAM, f), f
    ours, theirs = _vertex_labels(TWO_SEVENS), _vertex_labels(UPSTREAM)
    assert ours == {**theirs, 0: 7} and theirs[0] == 3
    # pattern_nlc: every column but the labels as upstream's, and each
    # label the label of the template vertex at its walk position
    for a, b in zip(_read(TWO_SEVENS, "nlc").splitlines(), _read(UPSTREAM, "nlc").splitlines(),
                    strict=True):
        mine, up = a.split(":"), b.split(":")
        assert mine[1:] == up[1:]
        index = [int(t) for t in mine[1].split()]
        assert [int(t) for t in mine[0].split()] == [ours[i] for i in index]


def test_vertex_1_needs_two_label_7_neighbours():
    classes, req = template.load(TWO_SEVENS).label_counts()
    assert req[1, classes.index(7)] == 2
    assert req.max() == 2


@functools.lru_cache(maxsize=None)
def _graph_and_reference(scale, seed, counting):
    g, port = ref_tests.graph(scale, seed)
    return g, port, ref_tests.reference(g, TWO_SEVENS, counting)


SCALES = [(13, 2**31 + 3), (14, 2**31 + 3), (15, 7), (16, 2**31 + 3)]


@pytest.mark.parametrize("mode", ["host", "device", "auto"])
@pytest.mark.parametrize("scale,seed", SCALES, ids=[f"s{s}" for s, _ in SCALES])
def test_port_counting_equals_reference(scale, seed, mode):
    g, port, ref = _graph_and_reference(scale, seed, True)
    pattern, cons = ref_tests.port_inputs(TWO_SEVENS)
    got = MatchEngine(
        port, g["labels"], pattern, cons, counting=True, nlcc_mode=mode, device="cpu"
    ).run()
    assert compare.differences(compare.plain(got), ref) == dict.fromkeys(compare.LIMITS, 0)
    assert ref["traversed_edges"] > 0


@pytest.mark.parametrize("scale,seed", [SCALES[0], SCALES[-1]], ids=["s13", "s16"])
def test_the_count_prunes(scale, seed):
    """The counting rule removes in the LCC what the default rule leaves
    to a round of the NLCC and an interleaved LCC phase: other rows, fewer
    iterations, and no vertex that the default rule drops."""
    _, _, base = _graph_and_reference(scale, seed, False)
    _, _, cnt = _graph_and_reference(scale, seed, True)
    d = compare.differences(cnt, base)
    assert d["lp_rows"] > 0, d
    assert cnt["iterations"] < base["iterations"]
    assert set(cnt["vertices"]) <= set(base["vertices"])
    assert cnt["subgraphs"] and any(cnt["subgraphs"].values())


# one search of the counting mode (ms from its fpm.search start): the init
# superstep counted in fpm.lcc.call 10-20, two compact supersteps in
# .compact.call 25-35, and an interleaved LCC call 60-70 with no counting
# superstep, which neither reader may take
COUNTED = [
    ("fpm.search", -1, 0, 100),
    ("fpm.lcc", 0, 10, 40),
    ("fpm.lcc.call", 1, 10, 20),
    ("fpm.lcc.count", 2, 11, 19),
    ("fpm.lcc.compact", 1, 20, 40),
    ("fpm.lcc.compact.closure", 4, 20, 25),
    ("fpm.lcc.compact.call", 4, 25, 35),
    ("fpm.lcc.count", 6, 26, 29),
    ("fpm.lcc.count", 6, 30, 34),
    ("fpm.lcc.compact.back", 4, 35, 40),
    ("fpm.state", 0, 40, 45),
    ("fpm.nlcc", 0, 50, 90),
    ("fpm.nlcc.walk.host", 11, 50, 60),
    ("fpm.lcc", 11, 60, 80),
    ("fpm.lcc.call", 13, 60, 70),
    ("fpm.nlcc.marks", 11, 80, 90),
    ("fpm.result", 0, 90, 100),
]
COUNTS = ({"lcc_count_passes": 352, "lcc_count_supersteps": 8},
          {"lcc_count_passes": 360, "lcc_count_supersteps": 8})
NAMES = ["lcc_count_roofline_pct", "idle_lcc_count_s", "lcc_count_passes_per_search"]


def counted(i, counters=None):
    """``test_benchmark_spans.result`` with counting supersteps."""
    r = MatchResult()
    base = span_tests.PROGRAM_NS[i]
    r.spans = [Span(n, p, base + int(s * 1e6), base + int(e * 1e6)) for n, p, s, e in COUNTED]
    r.counters = counters or {}
    return r


def counting_run(device=span_tests.CUDA):
    r = span_tests.synthetic(
        [counted(0, COUNTS[0]), None, counted(2, COUNTS[1])],
        device=device,
        busy0=((0, 5), (12, 14), (27, 28), (62, 64), (95, 105)),
    )
    r.reference = {"rows": [(0, "LP", 0, 10, 20, 7000), (0, "LP", 1, 5, 8, 500)]}
    r.num_edges, r.num_vertices, r.template_vertices = 1000, 100, 7
    r.peak = lambda key: 1e9
    return r


def test_idle_of_the_counting_supersteps():
    """Idle under fpm.lcc.count: 8 + 3 + 4 ms a search, less 12-14 and
    27-28 busy in the first."""
    r = counting_run()
    assert run.reader("idle_lcc_count_s")(r) == pytest.approx((12 + 15) / 2 * MS)


def test_count_roofline_by_span():
    """The kernels inside the LCC calls that hold an fpm.lcc.count, copies
    left out, whatever their names: 2 + 1 + 1 ms over two searches, against
    4 B an edge, 1 B a vertex and 2 B a later LP row's vertex at 1e9 B/s."""
    r = counting_run()
    t0 = span_tests.TRACE_S[0] - span_tests.LEAD
    r.trace.device = [
        ("any_torch_kernel", t0 + 12 * MS, t0 + 14 * MS),  # in the init call
        ("Memcpy DtoH (Device -> Pageable)", t0 + 15 * MS, t0 + 16 * MS),
        ("Memset (Device)", t0 + 16 * MS, t0 + 17 * MS),
        ("gather_wide_kernel", t0 + 19 * MS, t0 + 21 * MS),  # half inside
        ("void fused_count<7>(Planes)", t0 + 27 * MS, t0 + 28 * MS),  # compact call
        ("k", t0 + 36 * MS, t0 + 37 * MS),  # .compact.back: no call span
        ("k", t0 + 62 * MS, t0 + 64 * MS),  # a call with no counting superstep
    ]
    want = 100 * ((4 * 1000 + 100 + 2 * 5) / 1e9) / (4 * MS / 2)
    assert run.reader("lcc_count_roofline_pct")(r) == pytest.approx(want)


def test_passes_reader():
    assert run.reader("lcc_count_passes_per_search")(counting_run()) == 356
    # a program that keeps counters, but not this one
    bare = span_tests.two_searches(span_tests.COUNTS)
    assert run.reader("lcc_count_passes_per_search")(bare) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_off_the_card(name):
    assert run.reader(name)(counting_run(device=CPU)) is None
    untraced = counting_run()
    untraced.trace = None
    assert run.reader(name)(untraced) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_span_or_counter(name):
    """What the parent program gives (results without the fields, or a
    search run with no profiler), and the default mode's searches (spans
    and counters, no counting superstep)."""
    bare = span_tests.synthetic([types.SimpleNamespace(rows=[]), None])
    assert run.reader(name)(bare) is None
    assert run.reader(name)(span_tests.synthetic([MatchResult(), None])) is None
    default = span_tests.two_searches(span_tests.COUNTS)
    default.reference = counting_run().reference
    default.peak = lambda key: 1e9
    assert run.reader(name)(default) is None
