"""The port's multi-process run on the CPU: processes spawned by
``cli/launch_multiprocess.py``, joined by ``torch.distributed`` over gloo,
each holding CPU shards of one mesh (the mirror of
tests/test_multiprocess_launch.py, plus the mesh and the LCC data plane
held against the one-process mesh):

* the launcher and ``cli/sharded_lcc_demo.py`` over 2 processes x 4 shards:
  one 8-shard mesh, and the LP trace of the port's oracle;
* the 2-process graph build (``cli/generate_rmat``) writes the shard files
  of the one-process build byte for byte, and its ``meta.json`` but for the
  uuid;
* every ``Mesh`` collective across 2 processes (2 + 2 shards, and 1 + 3)
  equals the one-process mesh of the same 4 shards on the same seeded
  inputs, for each local shard;
* ``ShardedLccEngine.lcc_call`` (the global init superstep through the
  diameter) on 2 processes x 2 shards, on the golden tree_s13 graph with
  the tree corpus, in the default mode, with 4 output ranks, counting and
  edge metadata (every edge at 55): the rows (with the per-rank counters)
  and the died flag of the one-process 4-shard mesh and of the port's
  oracle (``engine/oracle.py``, which tests/test_torch_shared.py ties to
  the JAX package's), and each shard's final tv block and alive slots of
  the one-process mesh, byte for byte; the host reads of the whole state
  refuse the mesh.

Each launch runs this file as the per-process worker
(``python tests/test_torch_multiprocess.py <job> <dir> --distributed ...``),
which writes its results to the directory; the test compares them there.
Children run one torch thread each, take a free port, and the whole
process tree is killed at the time limit.
"""

import argparse
import filecmp
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.oracle import MatchOracle, MatchResult
from fuzzypatternmatching_tpu_torch.parallel.mesh import Mesh
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine
from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern
from fuzzypatternmatching_tpu_torch.utils.dist import (
    add_distributed_args,
    build_mesh,
    init_distributed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300  # seconds a launch may take (each takes a few here)
SPLITS = {"2+2": [2, 2], "1+3": [1, 3]}  # shards of process 0 + process 1
COLLECTIVES = ["all_to_all", "all_to_all_ragged", "psum", "pmax", "pmin", "all_gather"]
LCC_MODES = ["default", "ranks4", "counting", "metadata"]


# ----------------------------------------------------------------- launching

def launch(num_processes, cmd, devices_per_proc=None, timeout=TIMEOUT):
    """The port's launcher in a session of its own: (returncode, stdout,
    stderr); the launcher and every child are killed at ``timeout``."""
    env = dict(os.environ)
    env.pop("FPM_VIRTUAL_CPU_DEVICES", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    args = [sys.executable, "-m", "fuzzypatternmatching_tpu_torch.cli.launch_multiprocess",
            "-n", str(num_processes)]
    if devices_per_proc:
        args += ["--devices-per-proc", str(devices_per_proc)]
    p = subprocess.Popen(args + ["--"] + cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=REPO, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"launch timed out after {timeout} s:\n{out}\n{err}")
    return p.returncode, out, err


def launch_worker(job, outdir, num_processes=2):
    """Run this file's worker ``job`` in ``num_processes`` processes."""
    rc, out, err = launch(num_processes, [sys.executable, os.path.abspath(__file__), job, str(outdir)])
    assert rc == 0, out + err
    return out


def load(path):
    with open(path, "rb") as f:  # written by this file's worker
        return pickle.load(f)


# ------------------------------------------------------------------- inputs

def collective_inputs(n=4):
    """Seeded per-shard inputs of every collective, for n global shards."""
    rng = np.random.RandomState(3)
    t = torch.from_numpy
    return {
        "all_to_all": [t(rng.randint(-99, 99, size=(n, 5, 3)).astype(np.int32)) for _ in range(n)],
        "all_to_all_ragged": [
            [t(rng.randint(0, 1 << 40, size=(rng.randint(0, 7), 2))) for _ in range(n)]
            for _ in range(n)
        ],
        "psum": [t(rng.randint(-50, 50, size=4)) for _ in range(n)],
        "pmax": [t(rng.randint(-50, 50, size=4)) for _ in range(n)],
        "pmin": [t(rng.randint(-50, 50, size=4)) for _ in range(n)],
        "all_gather": [t(rng.randint(-9, 9, size=(rng.randint(0, 5), 3)).astype(np.int32))
                       for _ in range(n)],
    }


def run_collectives(mesh, inputs):
    """Each collective on this process's shards: name -> per local shard
    numpy outputs."""
    mine = {k: [v[r] for r in mesh.shard_ids] for k, v in inputs.items()}
    out = {k: getattr(mesh, k)(mine[k]) for k in COLLECTIVES}
    return {k: [x.numpy() for x in v] for k, v in out.items()}


def lcc_inputs():
    """The golden tree_s13 graph and labels, and the tree corpus (which
    carries pattern_edge_data, all 55)."""
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        cfg = json.load(f)["configs"]["tree_s13"]
    g, labels, _, _ = golden.build_config(cfg["scale"], os.path.join(REPO, cfg["corpus"]))
    with tempfile.TemporaryDirectory() as tmp:
        pattern, _ = load_tree_pattern(tmp)
    return g, labels, pattern


def lcc_kwargs(mode, g, pattern):
    if mode == "ranks4":
        return {"num_ranks": 4}
    if mode == "counting":
        return {"num_ranks": 4, "counting": True}
    if mode == "metadata":
        vals, allow = pattern.edge_meta_tables()
        code = np.full(g.num_edges, int(np.searchsorted(vals, 55)), dtype=np.int64)
        return {"num_ranks": 4, "edge_meta": (allow, code)}
    return {}


def run_lcc(mesh, g, labels, pattern, mode):
    """One lcc_call from the init state: rows, died, this process's shards'
    final (tv block, alive slots), and the whole-state reads it refuses."""
    eng = ShardedLccEngine(g, labels, pattern, mesh=mesh, **lcc_kwargs(mode, g, pattern))
    st, rows, died = eng.lcc_call(eng.init_state(), True)
    zeros = np.zeros(g.num_vertices, dtype=np.uint32)
    refused = []
    for name, read in (
        ("tv_host", lambda: eng.tv_host(st)),
        ("alive_pairs", lambda: eng.alive_pairs(st)),
        ("alive_edge_ids", lambda: eng.alive_edge_ids(st)),
        ("state_to_global", lambda: eng.state_to_global(st)),
        ("with_updates", lambda: eng.with_updates(st, zeros, [0])),
    ):
        try:
            read()
        except NotImplementedError:
            refused.append(name)
    return {"rows": rows, "died": died, "blocks": eng.local_blocks(st), "refused": refused}


def refusals():
    """What the single-controller parts say to a mesh across processes
    (one CPU shard per process): error type and message of each."""
    from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
    from fuzzypatternmatching_tpu_torch.parallel.nlcc_sharded import ShardedNlcc

    g, labels, pattern = lcc_inputs()
    mesh = build_mesh(device="cpu")
    out = {"n": mesh.n}
    for name, make in (
        ("MatchEngine", lambda: MatchEngine(g, labels, pattern, [], lcc_engine="sharded",
                                            mesh=mesh, device="cpu")),
        ("ShardedNlcc", lambda: ShardedNlcc(g.num_vertices, mesh)),
    ):
        try:
            make()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------------------ worker

def worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("job", choices=["collectives", "lcc", "refuse"])
    ap.add_argument("outdir")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    assert init_distributed(args, "cpu") == "gloo"
    rank = dist.get_rank()
    try:
        if args.job == "collectives":
            inputs = collective_inputs()
            res = {}
            for split, counts in SPLITS.items():
                mesh = Mesh([torch.device("cpu")] * counts[rank], group=dist.group.WORLD)
                res[split] = {"shard_ids": list(mesh.shard_ids), "n": mesh.n,
                              "out": run_collectives(mesh, inputs)}
        elif args.job == "refuse":  # tests/test_torch_dist.py
            res = refusals()
        else:
            g, labels, pattern = lcc_inputs()
            mesh = build_mesh(shards=2, device="cpu")
            res = {"n": mesh.n, "repr": repr(mesh)}
            res.update({mode: run_lcc(mesh, g, labels, pattern, mode) for mode in LCC_MODES})
        with open(os.path.join(args.outdir, f"{args.job}_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------------- tests

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_launcher_runs_the_demo_across_two_processes():
    rc, out, err = launch(2, [sys.executable, "-m", "fuzzypatternmatching_tpu_torch.cli.sharded_lcc_demo"],
                          devices_per_proc=4)
    assert rc == 0, out + err
    assert "2 processes, 8 global shards" in out
    want = ("LP trace: [(327, 2469, 23084), (124, 173, 2469), (8, 8, 173), (0, 0, 8), "
            "(0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0)]")
    assert out.count(want) == 2  # the JAX demo's trace, in both processes
    assert "PASS: 2-process sharded LCC matches the oracle trace (8 supersteps)" in out


def test_launcher_gives_each_process_its_local_rank():
    """The launcher's processes all run on this host: LOCAL_RANK is the
    process id and LOCAL_WORLD_SIZE the process count, which
    ``utils/dist.placement`` reads to pick cards and the backend. Each
    process writes its line in one ``write``: the processes share the
    pipe, and ``print`` with several arguments writes each piece apart
    when stdout is unbuffered."""
    code = ("import os, sys; os.write(1, f\"local {sys.argv[-1]} {os.environ['LOCAL_RANK']} "
            "{os.environ['LOCAL_WORLD_SIZE']}\\n\".encode())")
    rc, out, err = launch(3, [sys.executable, "-c", code])
    assert rc == 0, out + err
    assert sorted(line for line in out.splitlines() if line.startswith("local")) == [
        f"local {i} {i} 3" for i in range(3)
    ]


def test_launcher_exits_nonzero_when_a_process_fails():
    code = "import sys; sys.exit(3 if '0' in sys.argv[-1:] else 0)"
    rc, out, err = launch(2, [sys.executable, "-c", code])
    assert rc == 3, out + err


def test_two_process_construction_matches_single_process(tmp_path):
    """2 processes each build their R-MAT rank slice and the shards they
    own through the shared output directory: the shard files of the
    one-process chunked build, byte for byte."""
    from fuzzypatternmatching_tpu_torch.graph.build import build_rmat_db

    single = str(tmp_path / "single")
    build_rmat_db(single, scale=12, n_ranks=4, num_shards=4)
    multi = str(tmp_path / "multi")
    rc, out, err = launch(2, [sys.executable, "-m", "fuzzypatternmatching_tpu_torch.cli.generate_rmat",
                              "-s", "12", "-p", "4", "-o", multi])
    assert rc == 0, out + err
    assert "2-process build:" in out
    shards = [s for s in sorted(os.listdir(single)) if os.path.isdir(os.path.join(single, s))]
    assert shards
    for shard in shards:
        files = sorted(os.listdir(os.path.join(single, shard)))
        assert files == sorted(os.listdir(os.path.join(multi, shard)))
        for f in files:
            assert filecmp.cmp(os.path.join(single, shard, f), os.path.join(multi, shard, f),
                               shallow=False), f"shard file differs: {shard}/{f}"
    with open(os.path.join(single, "meta.json")) as f:
        ma = json.load(f)
    with open(os.path.join(multi, "meta.json")) as f:
        mb = json.load(f)
    ma.pop("uuid"), mb.pop("uuid")
    assert ma == mb
    assert not os.path.exists(os.path.join(multi, ".dist_build"))


@pytest.fixture(scope="module")
def collectives_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("collectives")
    launch_worker("collectives", outdir)
    return [load(outdir / f"collectives_{r}.pkl") for r in range(2)]


@pytest.mark.parametrize("collective", COLLECTIVES)
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_mesh_collective_across_processes(collectives_run, split, collective):
    want = run_collectives(Mesh([torch.device("cpu")] * 4), collective_inputs())[collective]
    for rank, res in enumerate(collectives_run):
        got = res[split]
        assert got["n"] == 4
        assert got["shard_ids"] == list(range(sum(SPLITS[split][:rank]), sum(SPLITS[split][: rank + 1])))
        for i, r in enumerate(got["shard_ids"]):
            x, y = got["out"][collective][i], want[r]
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.fixture(scope="module")
def lcc_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("lcc")
    launch_worker("lcc", outdir)
    return [load(outdir / f"lcc_{r}.pkl") for r in range(2)]


@pytest.fixture(scope="module")
def lcc_one_process():
    g, labels, pattern = lcc_inputs()
    mesh = Mesh([torch.device("cpu")] * 4)
    return {mode: run_lcc(mesh, g, labels, pattern, mode) for mode in LCC_MODES}


@pytest.fixture(scope="module")
def lcc_oracle():
    """The port's oracle's rows and died flag for one lcc_call from the
    init state, in each mode (metadata: every edge at 55)."""
    g, labels, pattern = lcc_inputs()
    out = {}
    for mode in LCC_MODES:
        kw = {k: v for k, v in lcc_kwargs(mode, g, pattern).items() if k != "edge_meta"}
        if mode == "metadata":
            kw["edge_data"] = np.full(g.num_edges, 55, dtype=np.int64)
        oracle, result = MatchOracle(g, labels, pattern, [], **kw), MatchResult()
        died = oracle.lcc_call(True, 0, result)
        rows = [(r.active_vertices, r.active_edges, r.messages, r.per_rank) for r in result.rows]
        out[mode] = {"rows": rows, "died": died}
    return out


def _rows(rows):
    return [(av, ae, msg, {k: v.tolist() for k, v in per.items()}) for av, ae, msg, per in rows]


@pytest.mark.parametrize("mode", LCC_MODES)
def test_lcc_call_across_processes_equals_one_process(lcc_run, lcc_one_process, lcc_oracle,
                                                      mode):
    want = lcc_one_process[mode]
    assert want["refused"] == []  # the one-process mesh reads the whole state
    oracle = lcc_oracle[mode]
    assert _rows(want["rows"]) == _rows(oracle["rows"]) and want["died"] == oracle["died"]
    assert want["rows"][0][0] > 0 and want["rows"][-1][0] > 0  # the search keeps vertices
    seen = []
    for rank, res in enumerate(lcc_run):
        assert res["n"] == 4 and f"process {rank} of 2" in res["repr"]
        got = res[mode]
        assert _rows(got["rows"]) == _rows(want["rows"]) == _rows(oracle["rows"])
        assert got["died"] == want["died"]
        assert sorted(got["blocks"]) == [2 * rank, 2 * rank + 1]
        for r, (tv, alive) in got["blocks"].items():
            tv_w, alive_w = want["blocks"][r]
            assert tv.dtype == tv_w.dtype and tv.tobytes() == tv_w.tobytes()
            assert alive.dtype == alive_w.dtype and alive.tobytes() == alive_w.tobytes()
            seen.append(r)
        assert got["refused"] == ["tv_host", "alive_pairs", "alive_edge_ids",
                                  "state_to_global", "with_updates"]
    assert sorted(seen) == [0, 1, 2, 3]


if __name__ == "__main__":
    worker(sys.argv[1:])
