"""The torch MatchEngine and CLI (fuzzypatternmatching_tpu_torch) on the CPU.

* against the JAX MatchEngine, run live, on tree_s11 with and without the
  compact continuation: the same phase rows (wall-time fields left out),
  iterations, active sets, enumerated subgraphs and traversed edges;
* against the committed golden trees (examples/results_golden, the
  oracle's output, which the JAX engines match): the anchors and the result
  files written by write_results, normalized as tests/test_golden_results.py
  normalizes them;
* the CLI end to end on a saved s11 graph DB.

The JAX engines get the JAX package's graphs and patterns
(``tools/make_golden.py::build_config``), the port its own
(``fuzzypatternmatching_tpu_torch.golden.build_config``), built from the
same R-MAT stream and pattern files. Everything compared is an integer
count, set or file row: exact equality.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.graph import storage
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.cli import run_pattern_matching
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.io.results import write_results

from test_golden_results import _tree_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_BASE = os.path.join(REPO, "examples", "results_golden")
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_golden import build_config as jax_build_config  # noqa: E402


@pytest.fixture(scope="module")
def golden_meta():
    with open(os.path.join(GOLDEN_BASE, "golden_meta.json")) as f:
        return json.load(f)


def _config(golden_meta, name, build=golden.build_config):
    """The port's (graph, labels, pattern, constraints) of a golden
    configuration; ``build=jax_build_config`` gives the JAX package's."""
    cfg = golden_meta["configs"][name]
    return build(cfg["scale"], os.path.join(REPO, cfg["corpus"]))


def _rows(result):
    return [
        (
            r.itr, r.phase, r.step, r.active_vertices, r.active_edges,
            r.messages,
            {k: np.asarray(v).tolist() for k, v in (r.per_rank or {}).items()},
        )
        for r in result.rows
    ]


@pytest.mark.parametrize("compact", [True, False])
def test_match_engine_matches_jax_tree_s11(golden_meta, compact):
    gj, labels_j, pattern_j, constraints_j = _config(
        golden_meta, "tree_s11", jax_build_config
    )
    g, labels, pattern, constraints = _config(golden_meta, "tree_s11")
    nr = golden_meta["num_ranks"]
    rj = JaxMatchEngine(
        gj, labels_j, pattern_j, constraints_j, num_ranks=nr, compact=compact
    ).run()
    rt = MatchEngine(
        g, labels, pattern, constraints, num_ranks=nr, compact=compact,
        device="cpu",
    ).run()
    assert _rows(rt) == _rows(rj)
    assert rt.iterations == rj.iterations
    assert rt.traversed_edges == rj.traversed_edges
    assert rt.pattern_found == rj.pattern_found
    assert rt.active_vertices == rj.active_vertices
    assert rt.active_edges == rj.active_edges
    assert rt.subgraphs == rj.subgraphs


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("config", ["tree_s11", "tree_s13", "cycle_s13"])
def test_match_engine_result_tree_matches_golden(
    golden_meta, config, compact, tmp_path
):
    cfg = golden_meta["configs"][config]
    nr = golden_meta["num_ranks"]
    g, labels, pattern, constraints = _config(golden_meta, config)
    r = MatchEngine(
        g, labels, pattern, constraints, num_ranks=nr, compact=compact,
        device="cpu",
    ).run()
    assert r.iterations == cfg["iterations"]
    assert len(r.active_vertices) == cfg["active_vertices"]
    assert len(r.active_edges) == cfg["active_edges"]
    assert sum(len(v) for v in r.subgraphs.values()) == cfg["subgraphs"]
    out = str(tmp_path / "out")
    write_results(
        out, 0, r, labels, nr,
        pattern.edge_count, pattern.vertex_count, len(constraints),
    )
    assert _tree_files(out) == _tree_files(os.path.join(GOLDEN_BASE, config))


def test_cli_end_to_end_tree_s11(golden_meta, tmp_path):
    """The JAX package's storage writes the DB; the port's CLI reads it."""
    g, _, _, _ = _config(golden_meta, "tree_s11", jax_build_config)
    db = str(tmp_path / "db")
    storage.save(g, db, num_shards=golden_meta["num_ranks"])
    out = str(tmp_path / "out")
    run_pattern_matching.main([
        "-i", db, "-p", os.path.join(REPO, "examples", "patterns"),
        "-o", out, "--device", "cpu",
    ])
    assert _tree_files(out) == _tree_files(os.path.join(GOLDEN_BASE, "tree_s11"))


def test_cuda_device_raises_without_a_card(golden_meta, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, labels, pattern, constraints = _config(golden_meta, "tree_s11")
    with pytest.raises(RuntimeError):
        MatchEngine(g, labels, pattern, constraints, device="cuda")
    db = str(tmp_path / "db")
    storage.save(_config(golden_meta, "tree_s11", jax_build_config)[0], db, num_shards=1)
    with pytest.raises(RuntimeError):
        run_pattern_matching.main([
            "-i", db, "-p", os.path.join(REPO, "examples", "patterns"),
            "-o", str(tmp_path / "out"), "--device", "cuda",
        ])


@pytest.mark.parametrize(
    "kw",
    [
        {"nlcc_mode": "auto"},
        {"nlcc_mode": "device"},
        {"lcc_engine": "flat"},
        {"counting": True},
        {"edge_data": np.zeros(1, dtype=np.int64)},
    ],
)
def test_unported_options_raise(golden_meta, kw):
    g, labels, pattern, constraints = _config(golden_meta, "tree_s11")
    with pytest.raises(ValueError):
        MatchEngine(g, labels, pattern, constraints, device="cpu", **kw)
