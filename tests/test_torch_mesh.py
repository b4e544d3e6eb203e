"""The port's multi-device plane end to end on CPU meshes, against the JAX
package on its virtual CPU devices (tests/conftest.py):

* ``MatchEngine(lcc_engine="sharded", mesh=...)`` (the mesh LCC engine and
  the mesh NLCC) on the golden tree_s13 and cycle_s13 configurations, at
  1, 2 and 8 shards, with the compact continuation and on the full plane:
  every PhaseRow (with the per-rank counters), the found flags, the active
  sets and the subgraphs equal the JAX ``MatchEngine(lcc_engine="sharded",
  mesh=...)`` (on 8 devices: its result does not depend on the mesh,
  tests/test_nlcc_sharded.py), the result tree equals the golden tree, and
  the port's mesh NLCC runs every constraint (``nlcc_fallbacks == 0``);
* ``superstep_timing=True`` gives the rows of the default search;
* the search CLI with ``--lcc-engine sharded --mmap`` over a DB written by
  ``cli.generate_rmat`` writes the JAX CLI's result tree, and ``--shards``;
* ``algorithms/frontier_sharded.py`` against the JAX package's at 2 and 8
  shards (PageRank within rtol 1e-5, atol 1e-6; everything else exact),
  ``run_algorithms --sharded`` and ``comm_rate_test``;
* the mesh collectives against their definitions.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fuzzypatternmatching_tpu.algorithms import frontier_sharded as jax_fs
from fuzzypatternmatching_tpu.cli import run_pattern_matching as jax_run_pattern_matching
from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.algorithms import frontier_sharded
from fuzzypatternmatching_tpu_torch.cli import (
    comm_rate_test,
    generate_rmat,
    run_algorithms,
    run_pattern_matching,
)
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.io.results import write_results
from fuzzypatternmatching_tpu_torch.parallel.mesh import Mesh
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_engine_vs_oracle import _random_graph
from test_golden_results import _tree_files
from test_torch_counting import port_graph, results_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_golden import build_config as jax_build_config  # noqa: E402

CONFIGS = ["tree_s13", "cycle_s13"]


def jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("x",))


@pytest.fixture(scope="module")
def golden_meta():
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        return json.load(f)


def _config(meta, name, build=golden.build_config):
    cfg = meta["configs"][name]
    return build(cfg["scale"], os.path.join(REPO, cfg["corpus"]))


_jax_results: dict = {}


def jax_result(meta, name):
    """The JAX MatchEngine on an 8-device mesh, full plane. Its NLCC runs on
    the host engine: the JAX mesh NLCC compiles a program per frontier
    capacity (a minute for cycle_s13 on the CPU) and equals the host engine
    (tests/test_nlcc_sharded.py; the port's against both in
    tests/test_torch_nlcc_sharded.py)."""
    if name not in _jax_results:
        gj, lj, pj, cj = _config(meta, name, jax_build_config)
        _jax_results[name] = JaxMatchEngine(
            gj, lj, pj, cj, num_ranks=meta["num_ranks"], lcc_engine="sharded",
            mesh=jax_mesh(8), nlcc_mode="host", compact=False,
        ).run()
    return _jax_results[name]


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full_plane"])
@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", CONFIGS)
def test_mesh_search_equals_jax_and_golden(golden_meta, tmp_path, name, n, compact):
    g, labels, pattern, constraints = _config(golden_meta, name)
    nr = golden_meta["num_ranks"]
    eng = MatchEngine(
        g, labels, pattern, constraints, num_ranks=nr, lcc_engine="sharded",
        mesh=build_mesh(shards=n, device="cpu"), nlcc_mode="device", compact=compact,
    )
    assert eng.lcc.n == n and hasattr(eng._dev_nlcc, "mesh")
    r = eng.run()
    assert eng.nlcc_fallbacks == 0
    results_equal(r, jax_result(golden_meta, name))
    out = str(tmp_path / "out")
    write_results(out, 0, r, labels, nr, pattern.edge_count, pattern.vertex_count,
                  len(constraints))
    assert _tree_files(out) == _tree_files(os.path.join(golden.GOLDEN_BASE, name))


@pytest.mark.parametrize("engine", ["bucketed", "sharded"])
def test_superstep_timing_rows_equal_default(golden_meta, engine):
    g, labels, pattern, constraints = _config(golden_meta, "tree_s13")
    kw = dict(num_ranks=golden_meta["num_ranks"], lcc_engine=engine, device="cpu")
    if engine == "sharded":
        kw["mesh"] = build_mesh(shards=2, device="cpu")
    timed = MatchEngine(g, labels, pattern, constraints, superstep_timing=True, **kw).run()
    plain = MatchEngine(g, labels, pattern, constraints, **kw).run()
    results_equal(timed, plain)
    lp = [x for x in timed.rows if x.phase == "LP"]
    assert len(lp) % pattern.diameter == 0 and all(x.seconds > 0 for x in lp)


def test_graphdb_needs_the_sharded_engine(golden_meta, tmp_path):
    from fuzzypatternmatching_tpu_torch.graph import storage

    g, labels, pattern, constraints = _config(golden_meta, "tree_s13")
    storage.save(g, str(tmp_path / "db"), num_shards=2)
    db = storage.open_db(str(tmp_path / "db"))
    with pytest.raises(TypeError):
        MatchEngine(db, labels, pattern, constraints, device="cpu")
    eng = MatchEngine(db, labels, pattern, constraints, num_ranks=4,
                      lcc_engine="sharded", mesh=build_mesh(shards=3, device="cpu"))
    assert not eng._compact_engine  # no global CSR to build the closure from
    r = eng.run()
    assert (len(r.active_vertices), len(r.active_edges)) == (12, 22)


def test_mmap_cli_writes_the_jax_tree(tmp_path, capsys):
    """tree_s13's graph written by cli.generate_rmat (4 shards, no
    scramble), searched by both CLIs with --lcc-engine sharded --mmap."""
    db = str(tmp_path / "db")
    generate_rmat.main(["-s", "13", "-o", db, "--no-scramble"])
    patterns = os.path.join(REPO, "examples", "patterns")
    trees = {}
    for name, main, extra in (
        ("port", run_pattern_matching.main, ["--device", "cpu", "--shards", "3"]),
        ("jax", jax_run_pattern_matching.main, []),
    ):
        out = str(tmp_path / name)
        main(["-i", db, "-p", patterns, "-o", out, "--lcc-engine", "sharded", "--mmap"] + extra)
        trees[name] = _tree_files(out)
    assert trees["port"] == trees["jax"]
    assert trees["port"] == _tree_files(os.path.join(golden.GOLDEN_BASE, "tree_s13"))
    with pytest.raises(SystemExit):
        run_pattern_matching.main(["-i", db, "-p", patterns, "-o", str(tmp_path / "x"),
                                   "--device", "cpu", "--shards", "2"])
    # --distributed joins a process group, which needs its address, size and rank
    with pytest.raises(ValueError, match="--coordinator"):
        run_pattern_matching.main(["-i", db, "-p", patterns, "-o", str(tmp_path / "x"),
                                   "--device", "cpu", "--distributed"])


@pytest.fixture(scope="module")
def algo_graph():
    gj = _random_graph(4, v=300, e=1500)
    return gj, port_graph(gj)


FRONTIER = {
    "bfs": lambda m, g, **kw: m.breadth_first_search(g, 3, **kw),
    "cc": lambda m, g, **kw: m.connected_components(g, **kw),
    "pagerank": lambda m, g, **kw: m.pagerank(g, 0.85, 12, **kw),
    "kcore": lambda m, g, **kw: m.kth_core(g, 4, **kw),
    "sssp": lambda m, g, **kw: m.sssp(
        g, 3, 1.0 + (np.arange(g.num_edges) * 7 % 5), **kw
    ),
}


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("algo", sorted(FRONTIER))
def test_frontier_sharded_equals_jax(algo_graph, algo, n):
    gj, g = algo_graph
    got = FRONTIER[algo](frontier_sharded, g, mesh=build_mesh(shards=n, device="cpu"))
    want = FRONTIER[algo](jax_fs, gj, mesh=jax_mesh(n))
    for x, y in zip(*(((got,), (want,)) if not isinstance(got, tuple) else (got, want))):
        if algo == "pagerank":
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_run_algorithms_sharded_and_comm_rate(tmp_path, capsys):
    db = str(tmp_path / "db")
    generate_rmat.main(["-s", "10", "-o", db, "--no-scramble"])
    capsys.readouterr()
    outs = []
    for flags in (["--sharded", "--num-devices", "3"], []):
        path = str(tmp_path / f"bfs{len(flags)}.npy")
        run_algorithms.main(["bfs", "-i", db, "-s", "3", "--device", "cpu", "-o", path] + flags)
        outs.append(np.load(path))
    assert "sharded over 3 devices" in capsys.readouterr().out
    assert np.array_equal(outs[0], outs[1])
    comm_rate_test.main(["-n", "4096", "-i", "2", "--shards", "3", "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    assert line.startswith("devices=3 payload=0.0MiB/dev all_gather+psum latency=")


def test_mesh_collectives():
    n = 3
    mesh = Mesh(["cpu"] * n)
    sends = [torch.arange(n * 4).view(n, 2, 2) + 100 * s for s in range(n)]
    recv = mesh.all_to_all(sends)
    for d in range(n):
        for s in range(n):
            assert torch.equal(recv[d][s], sends[s][d])
    parts = [[torch.arange(s + d) + 10 * s for d in range(n)] for s in range(n)]
    got = mesh.all_to_all_ragged(parts)
    for d in range(n):
        assert torch.equal(got[d], torch.cat([parts[s][d] for s in range(n)]))
    vals = [torch.tensor([s, -s]) for s in range(n)]
    assert torch.equal(mesh.psum(vals)[1], torch.tensor([3, -3]))
    assert torch.equal(mesh.pmax(vals)[2], torch.tensor([2, 0]))
    assert torch.equal(mesh.pmin(vals)[0], torch.tensor([0, -2]))
    assert torch.equal(mesh.all_gather(vals)[0], torch.tensor([0, 0, 1, -1, 2, -2]))
    with pytest.raises(ValueError):
        mesh.all_to_all(sends[:2])
    with pytest.raises(ValueError):
        Mesh([])
