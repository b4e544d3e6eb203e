"""``BENCHMARK.json`` against the benchmark contract's rules on names, units
and lengths; every cell's files found by name; and what the benchmark's
files may import (an AST scan, top-level module names compared whole)."""

import ast
import glob
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH_DIR)
with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {
        "command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer",
    }
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for word in SPEC["command"]:
        assert line_ok(word)
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and line_ok(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(cells)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:
            # a per-layer metric moves an end-to-end metric its cells report
            assert m["moves"] in {x["name"] for x in mine}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = json.load(open(os.path.join(BENCH_DIR, "workloads", f"{w['name']}.json")))
    for k in ("config", "traffic", "chips"):
        assert cell[k] == w[k]
    cfg_entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert cfg_entry["file"] == f"benchmark/configs/{w['config']}.json"
    cfg = json.load(open(os.path.join(REPO, cfg_entry["file"])))
    assert cfg["reduced"] == cfg_entry["reduced"] and cfg["source"] == cfg_entry["source"]
    from benchmark import run

    run.check_traffic(json.load(open(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))))
    tdir = os.path.join(BENCH_DIR, "templates", cfg["template"])
    for f in ("edge", "vertex_data", "stat", "nlc", "non_local_constraint"):
        assert os.path.isfile(os.path.join(tdir, f"pattern_{f}"))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        if w["name"] in m.get("workloads", [w["name"]]):
            assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in SPEC["paths"])


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES_PY = sorted(glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax_anywhere(path):
    bad = {"jax", "jaxlib", "flax", "fuzzypatternmatching_tpu"}
    assert not set(_imports(path)) & bad
    # nothing of the repo's other measurement code either
    assert not set(_imports(path)) & {"bench_torch", "bench", "tools", "tools_torch", "chip_smoke"}


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH_DIR, "reference", "*.py"))
    assert files
    for path in files:
        assert set(_imports(path)) <= {"__future__", "collections", "dataclasses", "os", "numpy", "torch"}, path


def test_top_level_names_compared_whole(monkeypatch):
    import sys
    import types

    from benchmark import run

    base = set(run.forbidden_loaded())
    for name in ("fuzzypatternmatching_tpu_torch_x.y", "jax_like", "flaxen.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(run.forbidden_loaded()) == base
    monkeypatch.setitem(sys.modules, "fuzzypatternmatching_tpu.engine", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("y"))
    assert set(run.forbidden_loaded()) == base | {"fuzzypatternmatching_tpu", "jaxlib"}
