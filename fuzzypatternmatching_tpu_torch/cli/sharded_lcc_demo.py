"""Multi-process sharded-LCC demo (run through ``cli/launch_multiprocess.py``;
the port of ``scripts/run_sharded_lcc_demo.py``).

Every process joins the process group, adds its shards to one host-major
mesh across the processes, builds the same deterministic workload (R-MAT
s11 from 4 generator ranks, seeds 5489 + 3r, unscrambled; degree labels;
the tree corpus) and runs the LCC data plane (halo exchanges, the
partial-OR owner combination, the summed convergence counters) from the
global init superstep through the pattern's diameter, across the
processes. Process 0 checks the per-superstep trace against the port's
oracle (``engine/oracle.py``) and prints PASS.

Where the shards live, as in the JAX demo: ``FPM_VIRTUAL_CPU_DEVICES``
(the launcher's ``--devices-per-proc``) puts that many on the CPU of each
process, joined over gloo; else each process holds one shard on its card
(``utils/dist.placement``: NCCL with one process per card, gloo where the
processes outnumber the cards).

The scope is the JAX package's: the data plane runs across processes;
the ``MatchEngine`` host loop (compact continuation, NLCC placement) is
single-controller and runs on a mesh held by one process.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch.distributed as dist

from ..engine.oracle import MatchOracle
from ..generators.rmat import RmatParams, generate_edges
from ..graph.csr import degree_labels, from_edges
from ..parallel.sharded import ShardedLccEngine
from ..pattern.builtin import load_tree_pattern
from ..utils.dist import (
    add_distributed_args,
    build_mesh,
    cpu_shards_from_env,
    init_distributed,
    print_line,
)


def s11_graph():
    """The demo's graph: R-MAT s11, 4 generator ranks, unscrambled."""
    parts = [
        generate_edges(
            RmatParams(seed=5489 + 3 * r, vertex_scale=11,
                       edge_count=(16 << 11) // 4, scramble=False)
        )
        for r in range(4)
    ]
    return from_edges(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        num_vertices=1 << 11,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-process sharded LCC demo")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    device = "cpu" if cpu_shards_from_env() else "cuda"
    init_distributed(args, device)
    try:
        mesh = build_mesh(device=device)
        pid = mesh.process_index
        print_line(f"[proc {pid}] {mesh.processes} processes, {mesh.n} global shards, {mesh}")
        g = s11_graph()
        labels = degree_labels(g)
        with tempfile.TemporaryDirectory() as tmp:
            pattern, _ = load_tree_pattern(tmp)

        eng = ShardedLccEngine(g, labels, pattern, mesh=mesh)
        _, rows, _ = eng.lcc_call(eng.init_state(), True)
        trace = [(av, ae, msgs) for av, ae, msgs, _ in rows]
        print_line(f"[proc {pid}] LP trace: {trace}")

        if pid == 0:
            r = MatchOracle(g, labels, pattern, []).run(max_iterations=1)
            want = [
                (row.active_vertices, row.active_edges, row.messages)
                for row in r.rows
                if row.phase == "LP"
            ][: len(trace)]
            if trace != want:
                print_line(f"FAIL: mesh trace {trace} != oracle {want}")
                return 1
            print_line(
                f"PASS: {mesh.processes}-process sharded LCC matches the "
                f"oracle trace ({len(trace)} supersteps)"
            )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
