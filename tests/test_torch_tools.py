"""The port's graph-DB tools and CLIs against the JAX package's, on the CPU.

* ``generate_rmat`` (chunked, ``--in-memory``, ``-b``), ``ingest_edge_list``
  (in memory and ``--chunked``), ``build_edge_metadata`` and
  ``transfer_graph`` of both packages write the same DB: ``meta.json`` (its
  uuid aside) and every shard array, byte for byte;
* the port's ``run_algorithms`` for every algorithm with ``--device cpu``,
  its saved outputs against the JAX CLI's (PageRank with rtol=1e-5,
  atol=1e-6), and its refusals (``--device cuda`` without a card,
  ``triangles --sharded``);
* the port's search CLI with ``--pattern-set 0 -v -b --output-vertex-data``
  on the tree_s13 golden configuration against the JAX CLI's result tree,
  file by file (wall-clock fields stripped), and against the golden tree.
"""

import json
import os

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu.cli import build_edge_metadata as jax_build_edge_metadata
from fuzzypatternmatching_tpu.cli import generate_rmat as jax_generate_rmat
from fuzzypatternmatching_tpu.cli import ingest_edge_list as jax_ingest_edge_list
from fuzzypatternmatching_tpu.cli import run_algorithms as jax_run_algorithms
from fuzzypatternmatching_tpu.cli import run_pattern_matching as jax_run_pattern_matching
from fuzzypatternmatching_tpu.cli import transfer_graph as jax_transfer_graph
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.cli import (
    build_edge_metadata,
    generate_rmat,
    ingest_edge_list,
    run_algorithms,
    run_pattern_matching,
    transfer_graph,
)
from fuzzypatternmatching_tpu_torch.graph import storage

from test_golden_results import _tree_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(base):
    return sorted(
        os.path.relpath(os.path.join(d, f), base)
        for d, _, fs in os.walk(base) for f in fs
    )


def assert_same_db(a, b):
    """meta.json equal but for its uuid; every other file byte for byte."""
    assert _files(a) == _files(b)
    assert len(_files(a)) > 1
    for rel in _files(a):
        with open(os.path.join(a, rel), "rb") as fa, open(os.path.join(b, rel), "rb") as fb:
            x, y = fa.read(), fb.read()
        if rel == "meta.json":
            x, y = json.loads(x), json.loads(y)
            assert x.pop("uuid") and y.pop("uuid")
        assert x == y, rel


def _both(tmp_path, port_main, jax_main, argv):
    """Run the port's and the JAX package's CLI with ``argv``, where
    ``{}`` stands for the tool's own directory under ``tmp_path``."""
    out = {}
    for name, main in (("port", port_main), ("jax", jax_main)):
        d = str(tmp_path / name)
        os.makedirs(d, exist_ok=True)
        main([a.format(d) for a in argv])
        out[name] = d
    return out["port"], out["jax"]


@pytest.mark.parametrize(
    "scale, extra",
    [(10, []), (11, []), (10, ["--in-memory"]), (11, ["-d", "8", "-p", "3"])],
    ids=["s10", "s11", "s10_in_memory", "s11_d8_p3"],
)
def test_generate_rmat_writes_the_jax_db(tmp_path, scale, extra):
    argv = ["-s", str(scale), "-o", "{}/db", "--no-scramble", "-b", "{}/backup"]
    port, jax = _both(tmp_path, generate_rmat.main, jax_generate_rmat.main,
                      argv + (extra if "-p" in extra else extra + ["-p", "4"]))
    assert_same_db(os.path.join(port, "db"), os.path.join(jax, "db"))
    assert_same_db(os.path.join(port, "backup"), os.path.join(jax, "db"))


def _edge_files(tmp_path, columns):
    rng = np.random.RandomState(columns)
    paths = []
    for i, n in enumerate((300, 0, 120)):
        rows = rng.randint(0, 200, size=(n, columns))
        path = tmp_path / f"edges_{i}"
        np.savetxt(path, rows, fmt="%d")
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("chunked", [False, True], ids=["in_memory", "chunked"])
def test_ingest_edge_list_writes_the_jax_db(tmp_path, chunked):
    files = _edge_files(tmp_path, 2)
    argv = ["-o", "{}/db", "-u", "-p", "3"]
    if chunked:
        argv += ["--chunked", "--num-vertices", "200"]
    port, jax = _both(tmp_path, ingest_edge_list.main, jax_ingest_edge_list.main,
                      argv + files)
    assert_same_db(os.path.join(port, "db"), os.path.join(jax, "db"))
    g, _, _ = storage.load(os.path.join(port, "db"))
    assert g.num_edges > 0


@pytest.mark.parametrize("undirected", [False, True], ids=["directed", "undirected"])
def test_build_edge_metadata_and_transfer_write_the_jax_db(tmp_path, undirected):
    generate_rmat.main(["-s", "9", "-o", str(tmp_path / "src"), "--no-scramble"])
    files = _edge_files(tmp_path, 3)
    flags = ["-u"] if undirected else []
    port, jax = _both(tmp_path, transfer_graph.main, jax_transfer_graph.main,
                      [str(tmp_path / "src"), "{}/db"])
    assert_same_db(os.path.join(port, "db"), os.path.join(jax, "db"))
    for name, main in (("port", build_edge_metadata.main),
                       ("jax", jax_build_edge_metadata.main)):
        main(["-i", str(tmp_path / name / "db")] + flags + files)
    assert_same_db(os.path.join(port, "db"), os.path.join(jax, "db"))
    _, _, edata = storage.load(os.path.join(port, "db"))
    assert edata is not None and np.count_nonzero(edata) > 0


@pytest.fixture(scope="module")
def algo_db(tmp_path_factory):
    """An s10 R-MAT DB with stored labels and edge metadata (the SSSP
    weights), written by the port's tools."""
    d = tmp_path_factory.mktemp("algo")
    db = str(d / "db")
    generate_rmat.main(["-s", "10", "-o", db, "--no-scramble"])
    g, _, _ = storage.load(db)
    rows = np.repeat(np.arange(g.num_vertices), np.diff(g.row_ptr))
    np.savetxt(d / "w_0", np.stack([rows, g.cols, 1 + (rows * 7 + g.cols * 3) % 5], 1), fmt="%d")
    build_edge_metadata.main(["-i", db, str(d / "w_0")])
    return db


ALGORITHMS = [
    ("bfs", ["-s", "3"]),
    ("cc", []),
    ("pagerank", ["--damping", "0.8", "--iterations", "12"]),
    ("kcore", ["-k", "4"]),
    ("sssp", ["-s", "3"]),
    ("triangles", []),
    ("fuzzywalk", ["--walk-labels", "3,4,3"]),
]


@pytest.mark.parametrize("algo, flags", ALGORITHMS, ids=[a for a, _ in ALGORITHMS])
def test_run_algorithms_matches_the_jax_cli(algo_db, tmp_path, capsys, algo, flags):
    argv = [algo, "-i", algo_db] + flags
    out = {}
    for name, main, extra in (("port", run_algorithms.main, ["--device", "cpu"]),
                              ("jax", jax_run_algorithms.main, [])):
        path = str(tmp_path / f"{name}.npy")
        main(argv + extra + ["-o", path])
        lines = capsys.readouterr().out.splitlines()
        out[name] = ([ln for ln in lines if not ln.startswith(("time:", "wrote "))],
                     np.load(path) if os.path.exists(path) else None)
    (lines, got), (lines_j, want) = out["port"], out["jax"]
    if algo == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert lines[0] == lines_j[0]
    else:
        assert lines == lines_j
        if algo != "triangles":
            assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    assert any(ln.startswith(("bfs", "components", "top-5", "4-core", "sssp",
                              "triangles", "fuzzywalk")) for ln in lines)


def test_run_algorithms_refusals(algo_db):
    with pytest.raises(SystemExit):  # no sharded triangle count
        run_algorithms.main(["triangles", "-i", algo_db, "--sharded", "--device", "cpu"])
    if torch.cuda.is_available():
        return
    for argv in (["cc", "-i", algo_db], ["bfs", "-i", algo_db, "--device", "cuda"]):
        with pytest.raises(RuntimeError):
            run_algorithms.main(argv)


def test_search_cli_flags_write_the_jax_tree(tmp_path):
    """tree_s13 (the golden graph, 4 shards) searched from a backup, with
    labels from -v files (degree labels, so the result stays the golden
    one) and --output-vertex-data, over every pattern set present."""
    cfg = json.load(open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")))
    g, labels, _, _ = golden.build_config(13, os.path.join(REPO, "examples", "patterns", "0", "pattern"))
    backup = str(tmp_path / "backup")
    storage.save(g, backup, num_shards=cfg["num_ranks"])
    base = str(tmp_path / "vdata_")
    for part in range(2):
        vs = np.arange(part, g.num_vertices, 2)
        np.savetxt(f"{base}{part}", np.stack([vs, labels[vs]], 1), fmt="%d")
    trees = {}
    for name, main, extra in (("port", run_pattern_matching.main, ["--device", "cpu"]),
                              ("jax", jax_run_pattern_matching.main, [])):
        out = str(tmp_path / name / "out")
        main(["-i", str(tmp_path / name / "db"), "-b", backup,
              "-p", os.path.join(REPO, "examples", "patterns"), "-o", out,
              "--pattern-set", "0", "-v", base, "--output-vertex-data"] + extra)
        trees[name] = _tree_files(out)
        assert_same_db(str(tmp_path / name / "db"), backup)
    assert trees["port"] == trees["jax"]
    vdata = {k for k in trees["port"] if "all_ranks_vertex_data" in k}
    assert len(vdata) == cfg["num_ranks"]
    rows = trees["port"]["0/all_ranks_vertex_data/vertex_data_1"]
    assert rows[0] == f"1, l, 1, {int(g.raw_degree[1])}, {int(labels[1])}"
    golden_tree = _tree_files(os.path.join(golden.GOLDEN_BASE, "tree_s13"))
    assert {k: v for k, v in trees["port"].items() if k not in vdata} == golden_tree
