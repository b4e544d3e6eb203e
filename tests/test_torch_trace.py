"""The port's search tracer (``utils/trace.py``) on the CPU.

* Download: only the first LCC phase of a search opens
  ``fpm.lcc.download``; later phases read the driver's host state.
* Off: with no profiler recording, ``MatchEngine.run`` keeps no span or
  counter and calls ``torch.profiler.record_function`` not once.
* On, under ``torch.profiler.profile``: one ``fpm.search`` root, every span
  inside its parent, only the names the driver documents (a closure's
  build spans among them); the compact
  closure built by the first search on an engine and not by the second,
  and the cycle's later LCC phases started from the previous phase's
  device state in both, with no closure lookup;
  the walk span named by the constraint's placement; the device walk's
  own spans inside each device walk and nowhere else, and its counter
  (the lanes its expansions took in, summed here from each call's
  frontier); the NLCC's dense
  row pointer built once per AliveCsr on the device route and never on
  the host route; the copy counters
  equal to the bytes a search on a full-plane engine with the host NLCC
  must move (per LCC superstep a stats row of 3R + 1 int64, the alive
  pairs' int64 keys and tv once down, tv once up).
* Clock: every span, shifted by the start of a ``bench.search`` range
  around ``run()`` less its ``fpm.search`` start, lies within 0.1 ms of
  its own ``user_annotation`` event in the profiler's exported trace, in
  one of the searches after the first of a profile.
* Results: every field that the benchmark's comparison and the result
  writer read is the same with tracing on and off, on every NLCC route.
* Copies: the engine files that copy between host and device do it only
  through ``to_device``/``to_host`` (an AST scan).
"""

import ast
import json
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(REPO, "examples", "patterns", "0", "pattern")
CYCLE = os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern")

# the device walk's own spans (engine/nlcc_device.py's docstring)
WALK = (
    "fpm.nlcc.walk.device.prepare", "fpm.nlcc.walk.device.expand",
    "fpm.nlcc.walk.device.winners", "fpm.nlcc.walk.device.out",
)
# a closure's build on a cache miss (engine/driver.py's docstring) and its
# sub-engine's (engine/lcc_bucketed.py's)
BUILD = (
    "fpm.lcc.compact.build", "fpm.lcc.compact.build.keys", "fpm.lcc.compact.build.graph",
    "fpm.lcc.compact.build.alive", "fpm.lcc.compact.build.slot_map", "fpm.build.lcc",
    "fpm.build.lcc.layout", "fpm.build.lcc.codes", "fpm.build.lcc.planes",
)
# every span name the driver opens (engine/driver.py's docstring)
NAMES = {
    "fpm.search", "fpm.lcc", "fpm.lcc.call", "fpm.lcc.download",
    "fpm.lcc.compact", "fpm.lcc.compact.closure", "fpm.lcc.compact.call",
    "fpm.lcc.compact.back", "fpm.state", "fpm.update", "fpm.nlcc",
    "fpm.nlcc.csr", "fpm.nlcc.place", "fpm.nlcc.walk.host",
    "fpm.nlcc.walk.device", "fpm.nlcc.marks", "fpm.result", "fpm.pairs",
} | set(WALK) | set(BUILD)
# where each span may open: the names of its possible parents
PARENTS = {
    "fpm.lcc": {"fpm.search", "fpm.nlcc"},
    "fpm.lcc.call": {"fpm.lcc"},
    "fpm.lcc.download": {"fpm.lcc"},
    "fpm.lcc.compact": {"fpm.lcc"},
    "fpm.lcc.compact.closure": {"fpm.lcc.compact"},
    "fpm.lcc.compact.call": {"fpm.lcc.compact"},
    "fpm.lcc.compact.back": {"fpm.lcc.compact"},
    "fpm.nlcc": {"fpm.search"},
    "fpm.nlcc.csr": {"fpm.nlcc"},
    "fpm.nlcc.place": {"fpm.nlcc"},
    "fpm.nlcc.walk.host": {"fpm.nlcc"},
    "fpm.nlcc.walk.device": {"fpm.nlcc"},
    "fpm.nlcc.marks": {"fpm.nlcc"},
    "fpm.result": {"fpm.search"},
    "fpm.update": {"fpm.search", "fpm.nlcc"},
    "fpm.state": {"fpm.search", "fpm.nlcc", "fpm.result"},
    # the bucketed engine's pairs sweep, inside each read of a device state
    "fpm.pairs": {"fpm.lcc.download", "fpm.state", "fpm.lcc.compact.back"},
    **{name: {"fpm.nlcc.walk.device"} for name in WALK},
    "fpm.lcc.compact.build": {"fpm.lcc.compact.closure"},
    **{name: {"fpm.lcc.compact.build"} for name in BUILD[1:6]},
    **{name: {"fpm.build.lcc"} for name in BUILD[6:]},
}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree13():
    return golden.build_config(13, TREE)


@pytest.fixture(scope="module")
def cycle13():
    return golden.build_config(13, CYCLE)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def engine(cfg, **kw):
    return MatchEngine(*cfg, device="cpu", **kw)


def plain(r):
    """Every field of a result that the benchmark's comparison and
    io/results.py read."""
    return {
        "rows": [
            (
                x.itr, x.phase, x.step, x.active_vertices, x.active_edges,
                x.messages,
                {k: np.asarray(v).tolist() for k, v in (x.per_rank or {}).items()},
            )
            for x in r.rows
        ],
        "found": list(r.pattern_found),
        "iterations": r.iterations,
        "vertices": dict(r.active_vertices),
        "edges": set(r.active_edges),
        "subgraphs": {pl: list(s) for pl, s in r.subgraphs.items()},
        "traversed": r.traversed_edges,
        "truncated": r.truncated,
    }


def test_off_records_nothing_and_opens_no_range(tree13, monkeypatch):
    e = engine(tree13)
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not trace.profiling()
    for _ in range(2):  # the closure's build, then the cache
        r = e.run()
        assert r.spans == [] and r.counters == {}
    assert calls == []
    assert trace._current.get() is None


@pytest.mark.parametrize("mode", ["auto", "host", "device"])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_span_tree(tree13, cycle13, corpus, compact, mode):
    e = engine(tree13 if corpus == "tree" else cycle13, compact=compact, nlcc_mode=mode)
    with profiled():
        r = e.run()
    spans = r.spans
    assert [s.parent for s in spans].count(-1) == 1
    assert spans[0].name == "fpm.search" and spans[0].parent == -1
    assert {s.name for s in spans} <= NAMES
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if i == 0:
            continue
        p = spans[s.parent]
        assert s.parent < i
        assert s.name in PARENTS and p.name in PARENTS[s.name], (s.name, p.name)
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    names = [s.name for s in spans]
    assert names.count("fpm.nlcc") == sum(x.phase == "TP" for x in r.rows)
    assert names.count("fpm.result") == 1
    assert ("fpm.lcc.compact" in names) == compact
    if corpus == "cycle":  # a constraint deletes sources: an interleaved LCC phase
        assert any(s.name == "fpm.lcc" and spans[s.parent].name == "fpm.nlcc" for s in spans)
    assert trace._current.get() is None


@pytest.mark.parametrize("corpus,carries", [("tree", 0), ("cycle", 2)])
def test_compact_builds_first_search_only(tree13, cycle13, corpus, carries):
    """The first LCC phase builds the closure; the cycle's later phases,
    whose alive sets lie inside it, start from the previous phase's state
    on the device and look no closure up. The next search's first phase
    maps the init superstep's alive plane into the cached closure on the
    device: its spans are the first search's without the download and the
    pairs sweep inside it, and without the closure's build."""
    e = engine(tree13 if corpus == "tree" else cycle13)
    with profiled():
        first, second = e.run(), e.run()
    assert first.counters["compact_builds"] == 1
    assert second.counters["compact_builds"] == 0
    assert first.counters["compact_subset_hits"] == second.counters["compact_subset_hits"] == 0
    assert (first.counters["compact_state_carries"]
            == second.counters["compact_state_carries"] == carries)
    assert first.counters["compact_device_maps"] == 0
    assert second.counters["compact_device_maps"] == 1
    down = [i for i, s in enumerate(first.spans) if s.name == "fpm.lcc.download"]
    assert len(down) == 1
    built = [i for i, s in enumerate(first.spans) if s.name == "fpm.lcc.compact.build"]
    assert len(built) == 1
    gone = set(down + built)
    for i, s in enumerate(first.spans):
        if s.parent in gone:
            gone.add(i)
    kept = [s.name for i, s in enumerate(first.spans) if i not in gone]
    assert kept == [s.name for s in second.spans]


@pytest.mark.parametrize("corpus,phases", [("tree", 1), ("cycle", 3)])
def test_download_only_from_a_device_state(tree13, cycle13, corpus, phases):
    """Only the first LCC phase, which starts from the init superstep's
    device state, downloads tv and the alive pairs; every later phase reads
    the compact route's host state in place."""
    e = engine(tree13 if corpus == "tree" else cycle13)
    with profiled():
        r = e.run()
    spans = r.spans
    lcc = [i for i, s in enumerate(spans) if s.name == "fpm.lcc"]
    downloads = [s for s in spans if s.name == "fpm.lcc.download"]
    assert len(lcc) == phases == sum(s.name == "fpm.lcc.compact" for s in spans)
    assert len(downloads) == 1 and downloads[0].parent == lcc[0]


@pytest.mark.parametrize("mode", ["host", "device"])
def test_walk_named_by_placement(cycle13, mode):
    e = engine(cycle13, nlcc_mode=mode)
    with profiled():
        r = e.run()
    walks = {
        s.name for s in r.spans
        if s.name.startswith("fpm.nlcc.walk.") and r.spans[s.parent].name == "fpm.nlcc"
    }
    assert walks == {f"fpm.nlcc.walk.{mode}"}
    places = sum(s.name == "fpm.nlcc.place" for s in r.spans)
    assert places == sum(s.name == f"fpm.nlcc.walk.{mode}" for s in r.spans) > 0


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_device_walk_spans(tree13, cycle13, corpus, mode):
    """Each device walk holds one ``.prepare``, at least one ``.expand``
    and one ``.out``, in that order; no host walk opens any of them."""
    e = engine(tree13 if corpus == "tree" else cycle13, nlcc_mode=mode)
    with profiled():
        r = e.run()
    kids = defaultdict(list)
    for s in r.spans:
        if s.name in WALK:
            assert r.spans[s.parent].name == "fpm.nlcc.walk.device"
            kids[s.parent].append(s.name.rsplit(".", 1)[1])
    walks = [i for i, s in enumerate(r.spans) if s.name == "fpm.nlcc.walk.device"]
    assert set(kids) == set(walks)
    assert (len(walks) > 0) == (mode == "device")
    for i in walks:
        k = kids[i]
        assert k[0] == "prepare" and k[-1] == "out" and "expand" in k
        assert k.count("prepare") == k.count("out") == 1


@pytest.mark.parametrize("mode", ["auto", "host", "device"])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_device_walk_counters(tree13, cycle13, corpus, mode, monkeypatch):
    """``nlcc_device_lanes`` counts the lanes of every expansion, here
    summed from each call's frontier and row pointer."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    real = nf.expand_frontier
    lanes = []

    def summing(ptr, col, cur, *a, **kw):
        c = cur.long()
        lanes.append(int((ptr[c + 1] - ptr[c]).sum()))
        return real(ptr, col, cur, *a, **kw)

    monkeypatch.setattr(nf, "expand_frontier", summing)
    e = engine(tree13 if corpus == "tree" else cycle13, nlcc_mode=mode)
    with profiled():
        r = e.run()
    walks = sum(s.name == "fpm.nlcc.walk.device" for s in r.spans)
    assert r.counters["nlcc_device_lanes"] == sum(lanes)
    if mode == "device":
        assert walks == sum(s.name == "fpm.nlcc.place" for s in r.spans) > 0
        assert sum(lanes) > 0
    # every message is a lane
    tp = sum(x.messages for x in r.rows if x.phase == "TP")
    assert sum(lanes) >= (tp if mode == "device" else 0)


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_dense_ptr_built_only_for_the_device(tree13, cycle13, corpus, mode):
    """The host walks index the alive pairs' rows alone; the device NLCC
    builds the dense V + 1 row pointer once per AliveCsr it uploads (one
    per ``fpm.nlcc.csr``)."""
    e = engine(tree13 if corpus == "tree" else cycle13, nlcc_mode=mode)
    with profiled():
        r = e.run()
    csrs = sum(s.name == "fpm.nlcc.csr" for s in r.spans)
    assert csrs > 0
    assert r.counters["nlcc_dense_ptr_builds"] == (csrs if mode == "device" else 0)


@pytest.mark.parametrize("ranks", [1, 4])
def test_copy_bytes_of_a_known_search(tree13, ranks):
    """Full plane, host NLCC, one iteration, no edge marks (the tree's
    constraints are paths): one LCC call (a stats row of 3R + 1 int64 per
    superstep down), the state read (int64 alive-pair keys and uint32 tv
    down), tv up once; the final read is served from the state's caches."""
    e = engine(tree13, compact=False, nlcc_mode="host", num_ranks=ranks)
    with profiled():
        r = e.run()
    assert r.iterations == 1
    lp = [x for x in r.rows if x.phase == "LP"]
    v = tree13[0].num_vertices
    assert r.counters["d2h_bytes"] == (
        len(lp) * (3 * ranks + 1) * 8 + 8 * lp[-1].active_edges + 4 * v
    )
    assert r.counters["h2d_bytes"] == 4 * v
    assert r.counters["compact_builds"] == 0


def test_counters_only_while_a_search_records():
    a = np.arange(10, dtype=np.int64)
    with profiled():
        t = trace.to_device(a, CPU)  # outside a search: nothing to count into
        assert np.array_equal(trace.to_host(t), a)
        trace.count("compact_builds")
    assert trace._current.get() is None


def _annotations(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [ev for ev in events if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"]


def _worst_offset_s(r, events):
    """The largest distance of a span's start or end from its event's, once
    the spans are shifted by the bench.search start less fpm.search's."""
    bench = [ev for ev in events if ev["name"] == "bench.search"]
    assert len(bench) == 1
    t0 = float(bench[0]["ts"]) * 1e-6
    off = t0 - r.spans[0].start_ns * 1e-9
    by_name = defaultdict(list)
    for ev in sorted(events, key=lambda ev: float(ev["ts"])):
        by_name[ev["name"]].append(ev)
    seen: dict = defaultdict(int)
    worst = 0.0
    for s in r.spans:
        ev = by_name[s.name][seen[s.name]]
        seen[s.name] += 1
        start = float(ev["ts"]) * 1e-6
        end = start + float(ev["dur"]) * 1e-6
        worst = max(
            worst, abs(s.start_ns * 1e-9 + off - start), abs(s.end_ns * 1e-9 + off - end)
        )
    assert {k: len(v) for k, v in by_name.items() if k != "bench.search"} == dict(seen)
    return worst


def test_spans_on_the_profilers_clock(tree13, tmp_path):
    e = engine(tree13)
    e.run()  # the closure's build is not what is timed
    with profiled():  # the profiler's first use in the process is not either
        e.run()
    # as the harness's window traces them: one profile, each search in its
    # own bench.search range, its spans matched with the events inside
    # that range. The first range a profile opens takes tens of
    # microseconds longer to enter than the later ones, which shifts every
    # span of the first search by as much; and on a CPU shared with other
    # processes a preemption between the profiler's stamp and a span's
    # clock read can shift any one search. So the check takes one of the
    # searches after the first.
    results = []
    with profiled() as prof:
        for _ in range(6):
            with torch.profiler.record_function("bench.search"):
                results.append(e.run())
    events = _annotations(prof, tmp_path / "trace.json")
    ranges = sorted(
        (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        for ev in events if ev["name"] == "bench.search"
    )
    assert len(ranges) == len(results)
    worst = [
        _worst_offset_s(r, [ev for ev in events if a <= float(ev["ts"]) <= b])
        for r, (a, b) in zip(results, ranges)
    ]
    assert min(worst[1:]) < 1e-4, worst


@pytest.mark.parametrize("corpus", ["tree", "cycle"])
@pytest.mark.parametrize("mode", ["auto", "device", "host"])
def test_results_unchanged_by_tracing(tree13, cycle13, corpus, mode):
    cfg = tree13 if corpus == "tree" else cycle13
    e = engine(cfg, nlcc_mode=mode)
    off = e.run()
    with profiled():
        on = e.run()
    again = engine(cfg, nlcc_mode=mode)
    with profiled():
        fresh = again.run()  # the closure built under the profiler
    assert on.spans and fresh.spans
    assert plain(on) == plain(off) == plain(fresh)


ROUTED = ["engine/driver.py", "engine/lcc_bucketed.py", "engine/nlcc_device.py"]


@pytest.mark.parametrize("rel", ROUTED)
def test_copies_go_through_the_tracer(rel):
    """No ``.cpu()`` call and no ``torch.from_numpy(...).to(...)`` chain
    (over one statement too: ``x = torch.from_numpy(...)`` then
    ``x.to(...)``) is left outside ``to_device``/``to_host``."""
    path = os.path.join(REPO, "fuzzypatternmatching_tpu_torch", rel)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    from_numpy_names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            f = node.value.func
            if isinstance(f, ast.Attribute) and f.attr == "from_numpy":
                from_numpy_names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        f = node.func
        if f.attr == "cpu":
            bad.append((node.lineno, ".cpu()"))
        if f.attr == "to":
            v = f.value
            if (
                isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr == "from_numpy"
            ) or (isinstance(v, ast.Name) and v.id in from_numpy_names):
                bad.append((node.lineno, "from_numpy(...).to(...)"))
    assert not bad, f"{rel}: {bad}"
