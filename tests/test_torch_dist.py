"""The port's multi-process plumbing (fuzzypatternmatching_tpu_torch/utils/
dist.py) on the CPU, the mirror of tests/test_dist.py: the 1-D and 2-D
meshes beside the JAX package's on its virtual CPU devices
(tests/conftest.py), ``init_distributed`` as a no-op without
``--distributed``, the sharded engine on ``build_mesh``; the backend
and card rule (``placement``) and where it reads the host's processes;
and the single-controller match loop refusing a mesh across processes, in the
driver and in the search CLI."""

import argparse
import os
import sys

import jax
import pytest
import torch.distributed as dist

from fuzzypatternmatching_tpu.utils.dist import build_mesh as jax_build_mesh
from fuzzypatternmatching_tpu_torch.engine.oracle import MatchOracle
from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges, grid_graph
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine
from fuzzypatternmatching_tpu_torch.utils.dist import (
    add_distributed_args,
    build_mesh,
    init_distributed,
    local_processes,
    placement,
)

import test_oracle as jo
from test_torch_counting import port_pattern
from test_torch_multiprocess import launch, launch_worker, load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu_shards(monkeypatch):
    """As many CPU shards per process as the JAX tests have devices (the
    variable the launcher's --devices-per-proc sets)."""
    n = len(jax.devices())
    monkeypatch.setenv("FPM_VIRTUAL_CPU_DEVICES", str(n))
    return n


def test_build_mesh_1d_host_major(cpu_shards):
    mesh, mesh_j = build_mesh(device="cpu"), jax_build_mesh()
    assert mesh.axis_names == mesh_j.axis_names == ("x",)
    assert mesh.shape == mesh_j.devices.shape == (cpu_shards,)
    assert mesh.n == cpu_shards and list(mesh.shard_ids) == list(range(cpu_shards))
    assert not mesh.spans_processes
    assert build_mesh(num_devices=4, device="cpu").n == jax_build_mesh(num_devices=4).devices.size == 4


def test_build_mesh_2d(cpu_shards):
    mesh, mesh_j = build_mesh(device="cpu", two_d=True), jax_build_mesh(two_d=True)
    assert mesh.axis_names == mesh_j.axis_names == ("host", "chip")
    # one process: one "host" row holding every shard
    assert mesh.shape == mesh_j.devices.shape == (1, cpu_shards)


def test_init_distributed_noop_without_flag():
    ap = argparse.ArgumentParser()
    add_distributed_args(ap)
    assert init_distributed(ap.parse_args([]), "cpu") is None  # a no-op, not an error
    assert not dist.is_initialized()


def test_init_distributed_needs_its_flags():
    ap = argparse.ArgumentParser()
    add_distributed_args(ap)
    with pytest.raises(ValueError, match="--coordinator"):
        init_distributed(ap.parse_args(["--distributed", "--num-processes", "2"]), "cpu")
    full = ["--distributed", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
            "--process-id", "0"]
    with pytest.raises(ValueError, match="not cpu or cuda"):
        init_distributed(ap.parse_args(full), "meta")
    assert not dist.is_initialized()


@pytest.mark.parametrize("device, local_rank, local_size, cards, want", [
    ("cpu", 1, 2, 0, ("gloo", None)),  # CPU shards
    ("cpu", 0, 2, 4, ("gloo", None)),
    ("cuda", 0, 1, 1, ("nccl", 0)),  # one process on one card
    ("cuda", 1, 2, 2, ("nccl", 1)),  # one process per card
    ("cuda", 1, 2, 8, ("nccl", 1)),
    ("cuda", 1, 2, 1, ("gloo", 0)),  # two processes share the one card
    ("cuda", 1, 4, 2, ("gloo", 0)),  # four processes on two cards: 0, 0, 1, 1
    ("cuda", 2, 4, 2, ("gloo", 1)),
    ("cuda", 3, 4, 2, ("gloo", 1)),
])
def test_placement_backend_and_card(device, local_rank, local_size, cards, want):
    """The backend follows from whether the host's processes share a card
    (more processes than cards: gloo, as NCCL refuses two processes on one
    card), and every process on a card gets one, whatever the backend."""
    assert placement(device, local_rank, local_size, cards) == want


def test_placement_needs_a_card_for_cuda():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        placement("cuda", 0, 2, 0)


def test_local_processes_from_launcher_or_flags(monkeypatch):
    ap = argparse.ArgumentParser()
    add_distributed_args(ap)
    args = ap.parse_args(["--distributed", "--coordinator", "127.0.0.1:1",
                          "--num-processes", "4", "--process-id", "3"])
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert local_processes(args) == (3, 4)  # every process on this host
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert local_processes(args) == (1, 2)  # two processes on each of two hosts


def test_sharded_engine_accepts_dist_mesh(cpu_shards):
    """The mesh engine on ``build_mesh``'s shards gives the LP trace of the
    port's oracle (the JAX test asserts a non-negative first row)."""
    src, dst = grid_graph(6, 6)
    g = from_edges(src, dst)
    labels, pattern = degree_labels(g), port_pattern(jo.PATH_PATTERN)
    engine = ShardedLccEngine(g, labels, pattern, mesh=build_mesh(device="cpu"))
    assert engine.n == cpu_shards
    _, rows, _ = engine.lcc_call(engine.init_state(), True)
    assert rows[0][0] >= 0
    want = [(r.active_vertices, r.active_edges, r.messages)
            for r in MatchOracle(g, labels, pattern, []).run(max_iterations=1).rows
            if r.phase == "LP"][: len(rows)]
    assert [r[:3] for r in rows] == want


def test_match_loop_refuses_a_mesh_across_processes(tmp_path):
    """MatchEngine and the mesh NLCC, given a mesh over 2 processes, raise
    NotImplementedError saying why (the JAX package's search crashes deep
    in its host loop instead)."""
    launch_worker("refuse", tmp_path)
    for r in range(2):
        res = load(tmp_path / f"refuse_{r}.pkl")
        assert res["n"] == 2
        assert "single-controller" in res["MatchEngine"]
        assert "sharded_lcc_demo" in res["MatchEngine"]
        assert "single-controller" in res["ShardedNlcc"]


def test_search_cli_refuses_a_mesh_across_processes(tmp_path):
    """``run_pattern_matching --lcc-engine sharded`` under the launcher
    stops with the driver's error."""
    db, out = str(tmp_path / "db"), str(tmp_path / "out")
    from fuzzypatternmatching_tpu_torch.cli import generate_rmat

    generate_rmat.main(["-s", "9", "-p", "2", "--no-scramble", "-o", db])
    rc, stdout, err = launch(2, [
        sys.executable, "-m", "fuzzypatternmatching_tpu_torch.cli.run_pattern_matching",
        "-i", db, "-p", os.path.join(REPO, "examples", "patterns"), "-o", out,
        "--lcc-engine", "sharded", "--device", "cpu",
    ])
    assert rc != 0
    assert "NotImplementedError" in err and "single-controller" in err


def test_search_cli_help_names_the_refusal(capsys):
    from fuzzypatternmatching_tpu_torch.cli import run_pattern_matching

    with pytest.raises(SystemExit):
        run_pattern_matching.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "--distributed" in text
    assert "single-controller" in text and "sharded_lcc_demo" in text
