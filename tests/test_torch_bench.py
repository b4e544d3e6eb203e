"""The port's measurement scripts on the CPU: ``bench_torch.py`` and
``tools_torch/`` (sweep, profile_search, init_decompose, scaling_bench,
comm_volume).

* ``bench_torch``: the R-MAT s13 workload, cached through the port's
  storage (read back by the JAX package's reader, array for array), gives
  ``ANCHORS[13]`` and the JAX ``MatchEngine``'s summary on the JAX
  package's own graph; ``main`` prints one JSON line with ``bench.py``'s
  metric name, and exits 1 with no JSON line when an anchor is wrong.
* The sweep at s13 over both engines and all four modes equals the pinned
  anchors; a diverging or failing cell makes it exit 1.
* The phase split (tree and cycle corpus, against the sweep's pins), the
  init-superstep split, the scaling harness and the communication volumes
  at s11-s13: their parts never exceed the totals they print.
* Every script refuses to run without a card unless the CPU is asked for.

The graph cache is pointed at a temporary directory by patching
``bench_torch.CACHE``; every output goes to ``--out`` in it.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import bench_torch
from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.generators.rmat import rmat_all_ranks as jax_rmat_all_ranks
from fuzzypatternmatching_tpu.graph import storage as jax_storage
from fuzzypatternmatching_tpu.graph.csr import degree_labels as jax_degree_labels
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.pattern.builtin import load_tree_pattern as jax_tree_pattern
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from tools_torch import comm_volume, init_decompose, profile_search, scaling_bench, sweep
from tools_torch.common import superstep_bytes

GRAPH_ARRAYS = ("row_ptr", "cols", "rev_edge", "raw_degree", "edge_row")


@pytest.fixture(autouse=True)
def _cache(tmp_path_factory, monkeypatch):
    """One graph cache for the module's tests, in a temporary directory."""
    monkeypatch.setattr(bench_torch, "CACHE", str(tmp_path_factory.getbasetemp() / "bench_cache"))
    monkeypatch.setenv("BENCH_SCALE", "13")
    monkeypatch.delenv("BENCH_FRESH", raising=False)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_s13():
    """The JAX package's s13 workload and its search summary."""
    src, dst = jax_rmat_all_ranks(13, 4)
    g = jax_from_edges(src, dst, num_vertices=1 << 13)
    labels = jax_degree_labels(g)
    with tempfile.TemporaryDirectory() as tmp:
        pattern, constraints = jax_tree_pattern(tmp)
    return g, labels, bench_torch.summary(JaxMatchEngine(g, labels, pattern, constraints).run())


def json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            pass
    return out


def test_run_bench_gives_the_anchors_and_the_jax_summary(jax_s13):
    g, labels = bench_torch.build_or_load_graph(13)
    gj, labels_j, summary_j = jax_s13
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(g, name), getattr(gj, name))
    np.testing.assert_array_equal(labels, labels_j)
    # the cache is the JAX package's format: its reader gives the same graph
    g_read, labels_read, _ = jax_storage.load(os.path.join(bench_torch.CACHE, "rmat_s13"))
    for name in GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(g_read, name), getattr(g, name))
    np.testing.assert_array_equal(labels_read, labels)

    rec = bench_torch.run_bench(g, labels, "cpu", runs=2)
    assert rec["anchors"] == bench_torch.ANCHORS[13]
    assert {k: rec["anchors"][k] for k in summary_j} == summary_j
    assert rec["traversed_edges"] == summary_j["traversed_edges"]
    assert rec["best_seconds"] == min(rec["seconds_all"]) and len(rec["seconds_all"]) == 2
    assert rec["value"] == rec["traversed_edges"] / rec["best_seconds"]
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert {"commit", "measured_at", "host_loadavg", "launches"} <= set(rec)
    assert len(rec["source_hash"]) == 12 and int(rec["source_hash"], 16) >= 0


@pytest.mark.parametrize("wrong", [False, True], ids=["anchors", "wrong-anchor"])
def test_bench_main_prints_one_line_or_refuses(wrong, monkeypatch, capsys):
    if wrong:
        bad = dict(bench_torch.ANCHORS[13], traversed_edges=94525)
        monkeypatch.setitem(bench_torch.ANCHORS, 13, bad)
    rc = bench_torch.main(["--device", "cpu", "--runs", "1"])
    lines = json_lines(capsys.readouterr().out)
    if wrong:
        assert rc == 1 and lines == []
    else:
        assert rc == 0 and len(lines) == 1
        assert lines[0]["metric"] == (
            "traversed edges/sec/chip (LCC+NLCC, R-MAT s13 tree pattern)"
        )
        assert lines[0]["unit"] == "edges/s" and lines[0]["value"] > 0


SWEEP_ARGS = ["--scales", "13", "--engines", "bucketed,sharded",
              "--modes", "default,counting,meta,full_plane", "--runs", "1",
              "--device", "cpu", "--shards", "2"]


def test_sweep_cells_equal_the_pinned_anchors(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    assert sweep.main(SWEEP_ARGS + ["--out", str(out)]) == 0
    matrix = json.loads(out.read_text())["matrix"]
    assert sorted(matrix) == sorted(
        ["s13/bucketed/default", "s13/bucketed/counting", "s13/bucketed/meta",
         "s13/sharded/default", "s13/sharded/counting", "s13/sharded/meta",
         "s13/sharded/full_plane"]
    )
    pinned = sweep.PINNED_ANCHORS[(13, "tree")]
    for cell in matrix.values():
        assert {k: cell[k] for k in pinned} == pinned
        assert cell["card"] == "cpu" and cell["seconds_best"] == min(cell["seconds_all"])
    assert matrix["s13/sharded/full_plane"]["shards"] == 2
    assert json.loads(capsys.readouterr().out)["matrix"] == matrix


@pytest.mark.parametrize("fault", ["divergence", "exception"])
def test_sweep_exits_1_on_a_failed_cell(fault, tmp_path, monkeypatch):
    if fault == "divergence":
        bad = dict(sweep.PINNED_ANCHORS[(13, "tree")], subgraphs=7)
        monkeypatch.setitem(sweep.PINNED_ANCHORS, (13, "tree"), bad)
    else:
        run_cell = sweep.run_cell

        def failing(scale, engine, mode, *a, **kw):
            if mode == "counting":
                raise RuntimeError("injected")
            return run_cell(scale, engine, mode, *a, **kw)

        monkeypatch.setattr(sweep, "run_cell", failing)
    out = tmp_path / "sweep.json"
    args = ["--scales", "13", "--engines", "bucketed", "--modes", "default,counting",
            "--runs", "1", "--device", "cpu", "--out", str(out)]
    assert sweep.main(args) == 1
    matrix = json.loads(out.read_text())["matrix"]
    assert "error" in matrix["s13/bucketed/counting"]
    assert ("error" in matrix["s13/bucketed/default"]) == (fault == "divergence")


@pytest.mark.parametrize("corpus", ["tree", "cycle"])
def test_profile_search_phases_within_the_total(corpus, tmp_path, capsys):
    out = tmp_path / "p.json"
    assert profile_search.main(["--device", "cpu", "--corpus", corpus, "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "measured" in text and "cumulative" in text
    rec = json.loads(out.read_text())
    assert len(rec["runs"]) == 2 and rec["card"] == "cpu" and rec["corpus"] == corpus
    for run in rec["runs"]:
        assert 0 < run["lp"] and 0 < run["tp"]
        assert run["lp"] + run["tp"] <= run["total"]
        tp_rows = sum(sec for _, phase, _, sec in run["rows"] if phase == "TP")
        assert tp_rows == pytest.approx(run["tp"])


def test_init_decompose_parts_within_the_total(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_SCALE", "12")
    out = tmp_path / "i.json"
    assert init_decompose.main(["--device", "cpu", "--reps", "2", "--out", str(out)]) == 0
    assert "label replay" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    parts = rec["parts_ms"]
    assert set(parts) == set(init_decompose.PARTS)
    assert all(v >= 0 for v in parts.values())
    assert sum(parts.values()) <= rec["profiled_total_ms"] * (1 + 1e-9)
    for part in ("entry gather", "label replay", "acceptance", "row OR", "exit writes"):
        assert parts[part] > 0, part
    assert len(rec["superstep_ms"]) == 2 and rec["superstep_best_ms"] == min(rec["superstep_ms"])
    assert len(rec["plain_ms"]) == 2 and rec["plain_best_ms"] == min(rec["plain_ms"])
    assert rec["alive_pairs"] > 0 and rec["card"] == "cpu"
    # the init superstep reads a 1-byte label code a slot in place of the
    # state, the neighbour ids and rev
    g, labels = bench_torch.build_or_load_graph(12)
    lcc = BucketedLccEngine(g, labels, bench_torch.load_corpus()[0], device="cpu")
    assert rec["bound_bytes"] == superstep_bytes(lcc, init=True) < superstep_bytes(lcc)


def test_scaling_and_comm_volume(tmp_path, capsys):
    out = tmp_path / "s.json"
    assert scaling_bench.main(["-s", "11", "-d", "1,2", "-i", "1", "--device", "cpu",
                               "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert [r["n"] for r in rec["rows"]] == [1, 2] and rec["card"] == "cpu"
    for r in rec["rows"]:
        assert r["ms_per_superstep"] > 0 and r["supersteps_per_call"] == 8
        assert r["efficiency"] == pytest.approx(r["speedup"] / r["n"])

    out = tmp_path / "c.json"
    assert comm_volume.main(["--scales", "11", "--devices", "1,2,4", "--device", "cpu",
                             "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["n"] for r in rows] == [1, 2, 4]
    assert rows[0]["cut_edges_total"] == 0
    for r in rows:
        assert 0 <= r["cut_edges_total"] <= r["E"]
        cross = sum(r[x]["useful_cross_max_per_device"] * r[x]["bytes_per_entry"]
                    for x in comm_volume.EXCHANGES)
        assert cross == r["cross_bytes_max_per_device_per_superstep"]
        assert cross <= r["wire_bytes_per_device_per_superstep"]
    # the per-shard working set falls with n
    assert rows[2]["per_device_elems"] < rows[0]["per_device_elems"]


@pytest.mark.parametrize("script", ["bench_torch", "sweep", "profile_search",
                                    "init_decompose", "scaling_bench", "comm_volume"])
def test_no_card_no_run(script):
    """Each script measures on the card unless the CPU is asked for."""
    main = {"bench_torch": bench_torch.main, "sweep": sweep.main,
            "profile_search": profile_search.main, "init_decompose": init_decompose.main,
            "scaling_bench": scaling_bench.main, "comm_volume": comm_volume.main}[script]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
