"""What the cycle cell (``cycle.default``) brings to the benchmark: its
template copied byte for byte from the corpus; the kernels its roofline
share times, defined in the program's sources; the control failing the
comparison on the triangle; ``correct`` false under a fault of the device
walk's cyclic acceptance, planted in the timed path; and the readers of
the device walk's spans and counters (``idle_nlcc_device_s``,
``nlcc_device_lanes_per_search``, ``nlcc_kernel_roofline_pct``) on
synthetic runs built as ``test_benchmark_spans`` builds them."""

import json
import os
import re
import types

import pytest
import torch

from benchmark import compare, run, spans
from benchmark.reference import template
from benchmark.tests import test_benchmark_reference as ref_tests
from benchmark.tests import test_benchmark_run as run_tests
from benchmark.tests import test_benchmark_spans as span_tests
from fuzzypatternmatching_tpu_torch.engine.nlcc_device import DeviceNlcc
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.utils.trace import Span

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH_DIR)
CYCLE = os.path.join(BENCH_DIR, "templates", "patterns_cycle_0")
CPU = torch.device("cpu")
MS = span_tests.MS


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name,source", [
    ("rmat_log2_tree_pattern_0", "examples/patterns/0"),
    ("patterns_cycle_0", "examples/patterns_cycle/0"),
])
def test_templates_are_copies_of_the_corpus(name, source):
    for f in ("edge", "vertex_data", "stat", "nlc", "non_local_constraint"):
        with open(os.path.join(BENCH_DIR, "templates", name, f"pattern_{f}"), "rb") as a, \
                open(os.path.join(REPO, source, f"pattern_{f}"), "rb") as b:
            assert a.read() == b.read(), f


def _kernels(cu):
    """The ``__global__`` functions defined in a CUDA source."""
    with open(cu) as f:
        text = f.read()
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text
    ))


@pytest.mark.parametrize("spec,sources", [
    ("lcc_kernel_roofline_pct.json", ["lcc_fused.cu", "lcc_superstep.cu"]),
    ("nlcc_kernel_roofline_pct.json", ["nlcc_frontier.cu"]),
])
def test_roofline_kernels_exist(spec, sources):
    """Each kernel a roofline share times is defined in the program's
    sources; of the walk's source (K4) every kernel is timed."""
    with open(os.path.join(BENCH_DIR, "metrics", spec)) as f:
        names = set(json.load(f)["kernels"])
    csrc = os.path.join(REPO, "fuzzypatternmatching_tpu_torch", "csrc")
    defined = set().union(*(_kernels(os.path.join(csrc, f)) for f in sources))
    assert names <= defined, names - defined
    if spec.startswith("nlcc"):
        assert names == defined


def test_control_fails_the_comparison_on_the_cycle():
    """The control of ``test_benchmark_reference`` on the cycle template,
    at a scale whose fixpoint holds triangles."""
    g, _ = ref_tests.graph(15, 3)
    ref = ref_tests.reference(g, CYCLE, False)
    assert ref["subgraphs"] and ref["vertices"]
    ctl = ref_tests.reference(g, CYCLE, False, supersteps=template.load(CYCLE).diameter - 1)
    d = compare.differences(ctl, ref)
    assert any(d[k] > lim for k, lim in compare.LIMITS.items()), d


@pytest.mark.parametrize("planted", [False, True], ids=["sound", "planted"])
def test_device_walk_validates_every_source(monkeypatch, planted):
    """The cycle cell with its constraints on the device NLCC (``"auto"``
    leaves them on the host at this scale), and the device walk planted
    to validate every source it starts from, as if no token had to close
    the triangle: a fault of the cyclic acceptance, which the tree cell
    never runs. (Dropping the device walk's edge marks changes no result
    of this template: each vertex holds one template bit, so the LCC keeps
    a closed triangle's edges with or without their marks.)"""
    if planted:
        real = DeviceNlcc.run_nem

        def every_source(self, *a, **kw):
            out = real(self, *a, **kw)
            out.validated[:] = True
            return out

        monkeypatch.setattr(DeviceNlcc, "run_nem", every_source)
    cfg = run_tests.small("cycle.default")
    cfg["engine"]["nlcc_mode"] = "device"
    line = run.execute("cycle.default", run_tests.SEED, 0.5, False, CPU, config=cfg)
    assert line is not None
    assert line["correct"] is not planted
    if planted:
        assert line["checks"]["tp_rows"]["value"] > 0


# the search of test_benchmark_spans with its constraint walked on the
# device: the walk's own spans inside fpm.nlcc.walk.device, a gap between each
DEVICE_WALK = span_tests.SPANS[:7] + [
    ("fpm.nlcc.walk.device", 6, 50, 60),
    ("fpm.nlcc.walk.device.prepare", 7, 50, 52),
    ("fpm.nlcc.walk.device.expand", 7, 53, 56),
    ("fpm.nlcc.walk.device.out", 7, 57, 60),
    ("fpm.lcc", 6, 60, 80),
    ("fpm.lcc.call", 11, 60, 70),
    ("fpm.nlcc.marks", 6, 80, 90),
    ("fpm.result", 0, 90, 100),
]
COUNTS = tuple({**c, "nlcc_device_lanes": n} for c, n in zip(span_tests.COUNTS, (1000, 3000)))
NAMES = ["idle_nlcc_device_s", "nlcc_device_lanes_per_search"]


def walked(i, counters=None):
    """``test_benchmark_spans.result`` with the walk on the device."""
    r = MatchResult()
    base = span_tests.PROGRAM_NS[i]
    r.spans = [
        Span(n, p, base + int(s * 1e6), base + int(e * 1e6)) for n, p, s, e in DEVICE_WALK
    ]
    r.counters = counters or {}
    return r


def test_idle_of_the_device_walk():
    """Idle time under fpm.nlcc.walk.device and its own spans: 50-60 in
    both searches, less 54-55 busy in the first (inside ``.expand``)."""
    r = span_tests.synthetic(
        [walked(0), None, walked(2)],
        busy0=((0, 5), (15, 18), (54, 55), (62, 64), (95, 105)),
    )
    assert run.reader("idle_nlcc_device_s")(r) == pytest.approx((9 + 10) / 2 * MS)
    _, by_span = spans.idle_split(r)
    assert by_span["fpm.nlcc.walk.device.expand"] == pytest.approx((2 + 3) / 2 * MS)
    assert by_span["fpm.nlcc.walk.device"] == pytest.approx(2 * MS)  # the gaps
    # no walk on the device: nothing to read
    assert run.reader("idle_nlcc_device_s")(span_tests.two_searches()) is None


def test_lanes_reader():
    r = span_tests.two_searches(COUNTS)
    assert run.reader("nlcc_device_lanes_per_search")(r) == 2000
    # a program that keeps counters, but not this one
    assert run.reader("nlcc_device_lanes_per_search")(span_tests.two_searches(span_tests.COUNTS)) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_off_the_card(name):
    off = span_tests.synthetic([walked(0, COUNTS[0])], device=CPU)
    assert run.reader(name)(off) is None
    untraced = span_tests.synthetic([walked(0, COUNTS[0])])
    untraced.trace = None
    assert run.reader(name)(untraced) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_from_a_program_without_spans(name):
    """What the parent program gives: results without the fields, or a
    search run with no profiler (empty fields)."""
    bare = span_tests.synthetic([types.SimpleNamespace(rows=[]), None])
    assert run.reader(name)(bare) is None
    assert run.reader(name)(span_tests.synthetic([MatchResult(), None])) is None


def test_walk_kernel_roofline():
    """4 bytes a message of every TP row over the K4 kernels' device time
    per traced search: here 3 ms over three searches, at 1e9 B/s."""
    r = span_tests.synthetic([span_tests.result(0), None, span_tests.result(2)], busy0=())
    t0 = span_tests.TRACE_S[0] - span_tests.LEAD
    r.trace.device = [
        ("void (anonymous namespace)::expand_count_kernel(ExpandArgs, int*)", t0, t0 + 2 * MS),
        ("winner_mark_kernel", t0 + 3 * MS, t0 + 4 * MS),
        ("void (anonymous namespace)::superstep_kernel<true>(Planes)", t0 + 5 * MS, t0 + 9 * MS),
    ]
    r.reference = {"rows": [
        (0, "LP", 0, 10, 20, 7000), (0, "TP", 0, 10, 20, 1000), (0, "TP", 1, 5, 8, 500),
    ]}
    r.peak = lambda key: 1e9
    want = 100 * (4 * 1500 / 1e9) / (3 * MS / 3)
    assert run.reader("nlcc_kernel_roofline_pct")(r) == pytest.approx(want)
    r.trace.device = r.trace.device[2:]  # no walk kernel ran
    assert run.reader("nlcc_kernel_roofline_pct")(r) is None
