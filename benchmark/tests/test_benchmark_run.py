"""A run driven on the CPU at a small scale, past the harness's look for a
card: the last line's shape; both kinds of arrivals the traffic generator
reads, and the traffic it refuses; ``correct`` false under each fault the
cells can have, planted in the timed path, also with the counting LCC; and
the refusals (no card, a directory with only the benchmark's files)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run
from fuzzypatternmatching_tpu_torch.engine import driver
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")
# the smallest scale at which the tree template finds subgraphs on this draw
SCALE = 16
SEED = 2**31 + 11


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


CELLS = [w["name"] for w in run.load_json("..", "BENCHMARK.json")["workloads"]]


def small(workload, counting=False):
    _, cfg, _ = run.load_cell(workload)
    cfg["graph"]["scale"] = SCALE
    if counting:
        cfg["engine"]["counting"] = True
    return cfg


def execute(workload, traced=False, seconds=0.5, counting=False, traffic=None):
    line = run.execute(
        workload, SEED, seconds, traced, CPU, config=small(workload, counting), traffic=traffic
    )
    assert line is not None
    return line


@pytest.mark.parametrize("workload", CELLS)
def test_line_shape(workload):
    line = execute(workload)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in run.metric_specs(workload, False)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    json.dumps(line)


def test_traced_line_shape():
    line = execute("tree.default", traced=True)
    assert line["correct"] is True
    assert line["attempted"] >= 8
    # on the CPU no device metric may be given
    assert set(line["metrics"]) == {"lcc_phase_s", "nlcc_phase_s", "engine_build_s"}
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_open_loop_serves_every_arrival():
    # four arrivals, 0.25 s apart, fall in a 1-s window; each is served
    # however long the searches before it took, its latency from its arrival
    traffic = {"arrivals": "open", "rate_per_s": 4.0, "warmup_searches": 1, "traced_searches": 1}
    r = run.Run("tree.default", small("tree.default"), traffic, CPU)
    engine, _, _ = run.setup(r, SEED)
    t = run.time.perf_counter()
    run.window(r, engine, 1.0, 0)
    took = run.time.perf_counter() - t
    assert len(r.times) == 4 and all(x is not None for x in r.results)
    assert took >= 0.75 + r.times[-1] - 1e-3
    assert execute("tree.default", traffic=traffic, seconds=1.0)["attempted"] == 4


@pytest.mark.parametrize("bad", [
    {"clients": 4},
    {"arrivals": "poisson"},
    {"arrivals": "open"},
    {"arrivals": "open", "rate_per_s": 0},
    {"rate_per_s": 2.0},
    {"traced_searches": 0},
], ids=["unread_key", "unknown_arrivals", "open_without_rate", "zero_rate",
        "closed_with_rate", "nothing_traced"])
def test_traffic_the_generator_cannot_read_is_refused(bad):
    _, _, traffic = run.load_cell("tree.default")
    with pytest.raises((ValueError, KeyError)):
        run.check_traffic({**traffic, **bad})


def test_lcc_state_returned_unchanged(monkeypatch):
    real = BucketedLccEngine.lcc_call

    def stuck(self, state, *a, **kw):
        _, rows, died = real(self, state, *a, **kw)
        return state, rows, died

    monkeypatch.setattr(BucketedLccEngine, "lcc_call", stuck)
    line = execute("tree.default")
    assert line["correct"] is False and line["failed"] == line["attempted"]


def test_half_the_sources_left_out(monkeypatch):
    real = driver.MatchEngine.__init__

    def half(self, *a, **kw):
        real(self, *a, **kw)
        self._cands = [c[: len(c) // 2] for c in self._cands]

    monkeypatch.setattr(driver.MatchEngine, "__init__", half)
    line = execute("tree.default")
    assert line["correct"] is False


@pytest.mark.parametrize("counting", [False, True], ids=["default", "counting"])
def test_answer_altered_where_produced(monkeypatch, counting):
    real = driver.run_tds

    def altered(*a, **kw):
        out = real(*a, **kw)
        if out.subgraphs is not None and len(out.subgraphs):
            out.subgraphs[0, 0] += 1
        return out

    monkeypatch.setattr(driver, "run_tds", altered)
    line = execute("tree.default", counting=counting)
    assert line["correct"] is False
    assert line["checks"]["subgraphs"]["value"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "tree.default", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_bare_directory_refused(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "tree.default", "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert p.returncode != 0 and p.stdout.strip() == ""
