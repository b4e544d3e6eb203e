"""The readers of the program's set-up records (``benchmark/setup_spans.py``
and ``build_layout_s``, ``build_planes_s``, ``warmup_closure_s``): on
synthetic records, and on the records that small CPU runs of the tree and
full-plane cells leave, read as a run on a card would read them.

Synthetic build record (ms from its start): ``fpm.build`` 0-10,000, its
``fpm.build.lcc`` 100-9,000 (``.layout`` 100-6,000, ``.codes``
6,000-7,000, ``.planes`` 7,000-9,000), ``fpm.build.nlcc`` 9,000-9,010.
Synthetic first search: two closure builds, 1,000-3,500 and 4,000-4,500,
each with its sub-engine's ``fpm.build.lcc``, which the build readers do
not read."""

import json
import os
import types
from collections import deque

import pytest
import torch

from benchmark import run
from fuzzypatternmatching_tpu_torch.utils import trace
from fuzzypatternmatching_tpu_torch.utils.trace import Record, Span

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CUDA = torch.device("cuda")
CPU = torch.device("cpu")
NAMES = ["build_layout_s", "build_planes_s", "warmup_closure_s"]
SCALE = 16
SEED = 2**31 + 29
TRAFFIC = {"arrivals": "closed", "warmup_searches": 1, "traced_searches": 1}

BUILD = [
    ("fpm.build", -1, 0, 10_000),
    ("fpm.build.lcc", 0, 100, 9_000),
    ("fpm.build.lcc.layout", 1, 100, 6_000),
    ("fpm.build.lcc.codes", 1, 6_000, 7_000),
    ("fpm.build.lcc.planes", 1, 7_000, 9_000),
    ("fpm.build.nlcc", 0, 9_000, 9_010),
]
FIRST = [
    ("fpm.search", -1, 0, 6_000),
    ("fpm.lcc", 0, 0, 5_000),
    ("fpm.lcc.compact", 1, 500, 5_000),
    ("fpm.lcc.compact.closure", 2, 500, 3_600),
    ("fpm.lcc.compact.build", 3, 1_000, 3_500),
    ("fpm.lcc.compact.build.keys", 4, 1_000, 1_200),
    ("fpm.lcc.compact.build.graph", 4, 1_200, 1_500),
    ("fpm.build.lcc", 4, 1_500, 3_000),
    ("fpm.build.lcc.layout", 7, 1_500, 2_500),
    ("fpm.build.lcc.codes", 7, 2_500, 2_600),
    ("fpm.build.lcc.planes", 7, 2_600, 3_000),
    ("fpm.lcc.compact.build.alive", 4, 3_000, 3_100),
    ("fpm.lcc.compact.build.slot_map", 4, 3_100, 3_500),
    ("fpm.lcc.compact.closure", 2, 3_900, 4_600),
    ("fpm.lcc.compact.build", 13, 4_000, 4_500),
]
WANT = {"build_layout_s": 6.9, "build_planes_s": 2.0, "warmup_closure_s": 3.0}


def record(root, engine, layout, base_ns=1_000_000_000):
    spans = [Span(n, p, base_ns + s * 1_000_000, base_ns + e * 1_000_000) for n, p, s, e in layout]
    return Record(root, engine, spans, dict.fromkeys(trace.COUNTERS, 0))


def card():
    """What the readers take of a run on a card."""
    return types.SimpleNamespace(device=CUDA)


def logged(monkeypatch, *records):
    monkeypatch.setattr(trace, "LOG", deque(records, maxlen=trace.LOG_SIZE))


@pytest.mark.parametrize("name", NAMES)
def test_readers_on_synthetic_records(name, monkeypatch):
    old = record("fpm.build", 1, BUILD)
    logged(monkeypatch, old, record("fpm.search", 1, FIRST[:1]),
           record("fpm.build", 2, BUILD), record("fpm.search", 3, FIRST),
           record("fpm.search", 2, FIRST), record("fpm.search", 2, FIRST[:1]))
    assert run.reader(name)(card()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_none_off_the_card_and_from_the_parent(name, monkeypatch):
    logged(monkeypatch, record("fpm.build", 2, BUILD), record("fpm.search", 2, FIRST))
    assert run.reader(name)(types.SimpleNamespace(device=CPU)) is None
    # a program that keeps no records: the parent's
    monkeypatch.delattr(trace, "setup_records")
    assert run.reader(name)(card()) is None


def test_none_without_the_spans(monkeypatch):
    """An engine whose first search built no closure (``compact: false``),
    or was profiled (no record); a log with no build."""
    logged(monkeypatch, record("fpm.build", 2, BUILD), record("fpm.search", 2, FIRST[:2]))
    assert run.reader("warmup_closure_s")(card()) is None
    assert run.reader("build_planes_s")(card()) == pytest.approx(2.0)
    logged(monkeypatch, record("fpm.build", 2, BUILD))
    assert run.reader("warmup_closure_s")(card()) is None
    logged(monkeypatch, record("fpm.search", 2, FIRST))
    for name in NAMES:
        assert run.reader(name)(card()) is None


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def executed():
    """Two traced CPU runs in one process, the tree's then the full
    plane's: each one's result line and the log as it left it."""
    out = {}
    for cell in ("tree.default", "tree.full_plane"):
        _, cfg, _ = run.load_cell(cell)
        cfg["graph"]["scale"] = SCALE
        line = run.execute(cell, SEED, 0.2, True, CPU, config=cfg, traffic=TRAFFIC)
        assert line is not None and line["correct"] is True
        out[cell] = (line, list(trace.LOG))
    return out


@pytest.mark.parametrize("cell", ["tree.default", "tree.full_plane"])
def test_readers_on_a_cpu_run(executed, cell, monkeypatch):
    line, log = executed[cell]
    # no set-up split is given off the card
    assert not set(line["metrics"]) & set(NAMES)
    logged(monkeypatch, *log)
    got = {name: run.reader(name)(card()) for name in NAMES}
    parts = line["setup_parts"]
    assert got["build_layout_s"] > 0 and got["build_planes_s"] > 0
    assert got["build_layout_s"] + got["build_planes_s"] <= parts["engine_build"]
    if cell == "tree.full_plane":
        assert got["warmup_closure_s"] is None
    else:
        assert 0 < got["warmup_closure_s"] <= parts["warmup"]


def test_each_run_reads_its_own_engine(executed, monkeypatch):
    logged(monkeypatch, *executed["tree.default"][1])
    tree = trace.setup_records()
    logged(monkeypatch, *executed["tree.full_plane"][1])
    full = trace.setup_records()
    assert None not in tree + full
    assert tree[0] is not full[0] and tree[1] is not full[1]
    assert tree[0].engine == tree[1].engine and full[0].engine == full[1].engine
    # the second run's records come after the first's: its build starts
    # after the tree's warm-up ended
    assert full[0].spans[0].start_ns > tree[1].spans[0].end_ns
    assert tree[1].counters["compact_builds"] == 1
    assert full[1].counters["compact_builds"] == 0


def test_benchmark_json_lists_the_three():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    by_name = {m["name"]: m for m in spec["per_layer"]}
    layer = by_name["engine_build_s"]["layer"]
    cells = [w["name"] for w in spec["workloads"]]
    for name in NAMES:
        m = by_name[name]
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "s", "lower", "program_span", "setup_s",
        )
        assert m["layer"] == layer
        assert os.path.isfile(os.path.join(REPO, "benchmark", "metrics", f"{name}.py"))
        assert set(m["workloads"]) <= set(cells)
    assert by_name["build_layout_s"]["workloads"] == cells[:4]
    assert by_name["build_planes_s"]["workloads"] == cells[:4]
    assert by_name["warmup_closure_s"]["workloads"] == [
        "tree.default", "cycle.default", "counting.default",
    ]
    assert [m["name"] for m in spec["per_layer"][-3:]] == NAMES
