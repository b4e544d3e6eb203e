#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fuzzypatternmatching_tpu_torch) on one
NVIDIA GPU:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a) and print
     each kernel's registers, static shared memory and spills (-Xptxas -v);
  3. hold each kernel against its plain torch twin, exactly: the alive
     table (words and group summary) at several sizes and summary budgets,
     the lookup at widths 8..8192, and gather_accept_or at widths 8..8192
     (every lane mapping) with n = 0/1/33/1000, all at alive densities 0.5 %, 60 % and 100 %,
     with pad sentinels and all-zero/all-one masks; map_alive on seeded
     planes and slot maps (pad-heavy, every slot dead, alive slots off the
     map), its plane, touched vertices and count;
  4. run the golden configurations tree_s13 and cycle_s13 (4 output ranks)
     through the torch MatchEngine and assert the committed anchors;
  5. run the benchmark search — R-MAT s21 (4-rank scrambled stream), degree
     labels, the tree corpus, compact continuation — once warm and three
     times timed; assert the anchors 147/262/74 and 13,207,467 traversed
     edges on each run, and that every kernel of the default mode was
     launched by the search: pack_alive, rev_alive_lookup and the fused
     supersteps (init_superstep at least once, continuation_superstep at
     least 7 times, at most 2 launches of each a superstep), and
     gather_accept_or (which no engine route launches since the counting
     mode fused its superstep too) not at all; map_alive once in each timed
     search (each maps its first LCC phase into the cached closure);
  6. the same search with compact=False (every superstep over all slots),
     on phase 5's engine with its compact continuation turned off;
  7. hold each kernel against its twin at the s21 shapes of a full-graph
     superstep, on the state after the init superstep and on an all-alive
     state, and time kernel and twin with CUDA events; time the lookup
     again with rev sorted (the random-L2-sector check), and the library
     call that computes what pack_alive + rev_alive_lookup compute
     (alive[rev], torch indexing; the port never calls it); map_alive on
     the post-init plane and the cached closure's slot map, against its
     twin, timed beside its bytes bound;
  8. one search of each mode under torch.profiler: device time against
     wall time, and the largest device items;
  9. hold the NLCC walk kernels (expand_frontier, forward_winners) against
     their twins, exactly, on seeded inputs: empty frontiers, zero-degree
     tokens, hub rows of 20,000 neighbours, 1, 4 and 5,000 ranks, every
     lane filtered and none; keys repeating within and across hops, with
     earlier keys; and every route: the plane's summary at 1..16 vertices a
     bit (V from 300 to 2^24 + 3, not all multiples of 32), the first
     design, h_next 0, 30 and -1; the partitioned winners with their own
     tables and with tables forced small (partitions on global tables),
     and the global-table design;
 10. run tree_s13 and cycle_s13 with every NLCC constraint on the device
     (nlcc_mode="device") and assert the committed anchors;
 11. the s21 cycle search (the graph and labels of phase 5, the
     examples/patterns_cycle corpus): one engine with nlcc_mode="device",
     once warm and once timed, asserting 169/346/56 and 105,906,296
     traversed edges and that both walk kernels were launched; then one
     search each with nlcc_mode="host" and the default "auto";
 12. each constraint of both s21 corpora on the state after the first LCC
     call, on the card and on the host engine: equal outcomes (forwarded
     keys included) and both placements' times, and the host time of the
     card's constraint 0 by function (cProfile); the walk kernels against
     their twins at the s21 cycle hop shapes, every route timed by
     CUDA-graph replay in turns (shipped, first design, summary;
     partitioned winners, global table; twin) beside their bounds; and
     both designs of each kernel on cuts of the largest hop (every k-th
     token or lane) around the size where the route changes;
 13. one s21 cycle search (device mode) under torch.profiler, and one
     under cProfile (host time by function);
 14. the s21 tree search in counting mode (counting=True, compact
     continuation), warm and timed: the anchors of phase 5, launches of
     rev_alive_lookup and of both fused supersteps (their counting
     instantiations), and none of gather_accept_or;
 15. the s21 tree search with edge metadata: every edge carries 55, the
     tree corpus's only pattern_edge_data value; the same anchors, launches
     of rev_alive_lookup and none of the walk kernels (metadata keeps every
     constraint on the host engine);
 16. the s21 tree search on the flat LCC engine (lcc_engine="flat"): the
     same anchors, and LP rows equal to phase 6's compact=False rows;
 17. the device time of one full-graph non-init superstep at the state
     after the init superstep, by CUDA-graph replay in turns: the bucketed
     engine's default, counting and metadata branches and the flat
     engine's superstep, each beside its bytes bound;
 18. the classic algorithms (algorithms/frontier.py) on the s21 graph of
     phase 5: BFS, connected components, the 4-core, PageRank, SSSP and the
     triangle count, each once warm and three times timed, asserting the
     s21 anchors on every run (SSSP with unit weights equal to BFS's
     levels; the triangle count also against a second formulation written
     here: each oriented edge's two sorted oriented rows intersected);
     iterations, the CSR upload, device ms of one iteration by CUDA-graph
     replay beside its bytes bound, and the triangle count's wedges and
     chunks;
 19. the port's CLIs end to end at s13: generate_rmat writes the golden
     tree_s13 graph, transfer_graph backs it up, run_pattern_matching
     restores it (-b) and searches --pattern-set 0 with -v labels and
     --output-vertex-data (the golden tree_s13 result tree, plus the
     vertex data), build_edge_metadata attaches weights, and every
     run_algorithms algorithm gives on the card what it gives with
     --device cpu (PageRank within rtol 1e-5, atol 1e-6);
 20. the mesh LCC superstep's kernels against their twins, exactly:
     pack_sends on payload tables of 1 to 2^22 + 5 words (lengths off 32
     and off G, G = 32 and 64), with INT_MIN words (alive, no candidates)
     and the appended zero word, alive bits clear, 0.5 %, 60 % and all
     set; gather_accept_or_payload in one call over a bucket table of
     width 1 and the mesh engine's widths 8..1024, each with 0, 1, 33 or
     1000 rows, random/all-zero/all-one masks, on index planes aligned and
     not; and every call of a tree_s13 full-plane search on 4 shards of
     the card, whose chunk boundaries split rows;
 21. the multi-device dryrun on the card: tree_s13 and cycle_s13 with
     lcc_engine="sharded", nlcc_mode="device", compact=False and
     num_ranks = n on meshes of 1, 2 and 4 shards of cuda:0: the golden
     anchors (the cycle in 2 iterations), no host fallback, per-rank
     counters on every row;
 22. the s21 tree search on a 4-shard mesh of the card (the graph of
     phase 5): the engine build, one warm and three timed searches with
     the compact continuation (the mesh runs the init superstep, the
     sub-engine the rest), one warm and one timed on the full plane (every
     superstep on the mesh), the anchors on every run, the kernels'
     launches, the per-shard working set and peak device memory; the mesh
     superstep's kernels against their twins on every call of one
     full-plane superstep at the post-init state, and timed there by
     CUDA-graph replay: the pair (a pack and a gather per shard) beside the
     bytes bound of the whole function, each part alone beside its own
     bound, the twins, the pair with every payload word alive and with
     every word sending; that superstep's eager time; the share of payload
     words that send in each superstep of a full-plane lcc_call;
 23. the s21 cycle search on the 4-shard mesh, nlcc_mode="device" (the
     mesh NLCC routes the tokens), one run: 169/346/56 and 105,906,296,
     no host fallback, the walk kernels' launches and each constraint's
     seconds; the share of payload words that send in each superstep of
     a full-plane lcc_call on its mesh engine;
 24. the mesh across processes: the s21 graph of phase 5 goes to 2
     processes as .npy files in a temporary directory; the port's launcher
     (cli/launch_multiprocess.py) starts them with one card visible, so
     the backend rule of utils/dist.placement puts both on it, 2 shards
     each, joined over gloo (4 shards in all); each builds the mesh LCC
     engine on the tree corpus and runs lcc_call from the init state (the
     global init superstep through the diameter) once warm and twice
     timed. Their rows equal those of the one-process 4-shard mesh of
     phase 22 (which runs the same calls), each shard's final tv block and
     alive slots equal that mesh's byte for byte, and each process
     launched both mesh kernels; the per-superstep times of both, and the
     bytes each process sent across the process boundary;
 25. the same with 2 cards visible, where the machine has them: the same
     rule then gives one process per card over NCCL, 2 shards each; on one
     card a line says it did not run and why;
 26. the measurement scripts (bench_torch.py, tools_torch/): bench_torch's
     measurement on the s21 graph of phase 5 (its anchors on every run, the
     launches of the bucketed engine's kernels in the search),
     profile_search's phase split and init_decompose's split of the init
     superstep on the same engine (device ms by part, the bytes bound, the
     post-init alive_pairs); the sweep at s13 over the bucketed and
     sharded engines in the default, counting, meta and full-plane modes
     against its pinned anchors, the mesh kernels launched in the
     full-plane cell; scaling_bench and comm_volume at s17 on 1, 2 and 4
     shards of the card; and python3 bench_torch.py as a process at
     BENCH_SCALE=13, through the graph cache the sweep wrote;
 27. the fused default-mode supersteps (ops/lcc_fused.py, K1
     init_superstep and K2 continuation_superstep) against their twins,
     exactly: right after phase 3 on seeded cases (every engine width
     8..8192 with a split widest bucket, widths 1-4 and slot bases off 8,
     split hubs in a width-16 bucket, 1, 4 and 2,000 output ranks, uint8
     and int32 label codes, templates of 1 to 16 vertices, empty buckets
     and none); after phase 7 on every superstep of one s21 tree search
     with the compact path and one with compact=False (phases 5-6's
     engines, anchors asserted), and both kernels timed at the post-init
     state of the full graph by CUDA-graph replay in turns with their
     twins (the plain per-bucket superstep), eagerly, and beside their
     bytes bounds. The counting instantiations the same way: seeded cases
     after phase 3 (requirement tables of 1 to 256 pairs, counts up to 15,
     every class present with no requirement met), and after phase 14
     every superstep of one s21 counting search with the compact path and
     one with compact=False held against the twin, then both timed at the
     post-init state of phase 14's full engine.

Any failure ends the run with a non-zero exit code, and so does a run
without a CUDA device or without the rest of the repository. The last two
lines are one JSON object with a record per kernel (launches during the
main-path search: the s21 tree search for the superstep kernels, the s21
cycle device search for the walk kernels; largest difference from the
twin, times and the least time the card could take; the mesh superstep's
kernels' launches are those of the phase 22 full-plane search) and the
result line ``{"ok": true, ...}``. gather_accept_or's launches there are
0: since both the default and the counting mode fused their supersteps no
search launches it (phase 7 holds it against its twin and times it).

Usage: python3 chip_smoke.py   (from the repository root; one CUDA card)
(``chip_smoke.py --mesh-child DIR ...`` is phase 24-25's per-process
part, which the launcher starts.)
"""

import argparse
import json
import os
import pickle
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bench_torch
from fuzzypatternmatching_tpu_torch import native
from fuzzypatternmatching_tpu_torch.algorithms import frontier
from fuzzypatternmatching_tpu_torch.cli import (
    build_edge_metadata,
    generate_rmat,
    run_algorithms,
    run_pattern_matching,
    transfer_graph,
)
from fuzzypatternmatching_tpu_torch.engine import lcc_bucketed, nlcc
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.generators.rmat import rmat_all_ranks
from fuzzypatternmatching_tpu_torch.golden import GOLDEN_BASE, REPO, build_config
from fuzzypatternmatching_tpu_torch.graph import storage
from fuzzypatternmatching_tpu_torch.graph.csr import Graph, degree_labels, from_edges
from fuzzypatternmatching_tpu_torch.ops import _build
from fuzzypatternmatching_tpu_torch.ops import lcc_fused as lf
from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops
from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf
from fuzzypatternmatching_tpu_torch.parallel import sharded as sharded_lcc
from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
    load_nonlocal_constraints,
)
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine
from fuzzypatternmatching_tpu_torch.utils.dist import (
    add_distributed_args,
    build_mesh,
    init_distributed,
    print_line,
)
from tools_torch import comm_volume, init_decompose, scaling_bench, sweep
from tools_torch.common import HBM_BYTES_PER_MS, superstep_bytes
from tools_torch.profile_search import phase_split

S21_ANCHORS = {
    "active_vertices": 147,
    "active_edges": 262,
    "subgraphs": 74,
    "traversed_edges": 13207467,
}
S21_CYCLE_ANCHORS = {
    "active_vertices": 169,
    "active_edges": 346,
    "subgraphs": 56,
    "traversed_edges": 105906296,
}
# algorithms/frontier.py on rmat_all_ranks(21, 4). The JAX package's
# frontier.py on the CPU gives the same (its triangle count only with
# jax_enable_x64, in 1,052 s); PageRank: damping 0.85, 20 steps.
S21_ALGO_ANCHORS = {
    "bfs_reached": 1363753,  # from vertex 0
    "bfs_max_level": 5,
    "bfs_parent_sum": 823700246002,  # over the reached vertices
    "components": 733022,
    "core4": 784409,
    "pagerank_top5": [1996217, 1579409, 1061996, 334934, 1830903],
    "pagerank_top5_values": [0.001769329304806888, 0.0006912612006999552,
                             0.0006856226245872676, 0.0006700065569020808,
                             0.0006667478010058403],
    "triangles": 926391645,
}
CYCLE_CORPUS = os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern")
KERNELS = {
    "pack_alive": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:187",
    "rev_alive_lookup": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:71",
    "gather_accept_or": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:105",
    # the same Pallas kernel's arithmetic on payload words, as the mesh
    # superstep (parallel/sharded.py:829-977) wraps it
    "gather_accept_or_payload": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:105",
    # the superstep's sends test on payload words (jnp, not a Pallas kernel),
    # packed into the table that gates the gather above
    "pack_sends": "fuzzypatternmatching_tpu/parallel/sharded.py:903",
    "expand_frontier": "fuzzypatternmatching_tpu/engine/nlcc_device.py:105",
    "forward_winners": "fuzzypatternmatching_tpu/engine/nlcc_device.py:188",
    # the supersteps XLA fused (not Pallas kernels): _superstep with
    # init=True (from _call_init1_seg :782) and init=False (in _call_impl's
    # scan :813)
    "init_superstep": "fuzzypatternmatching_tpu/engine/lcc_bucketed.py:529",
    "continuation_superstep": "fuzzypatternmatching_tpu/engine/lcc_bucketed.py:529",
    # the compact continuation's host lookup of the post-init alive set in
    # its closure and the sub-engine planes built from it (not a kernel)
    "map_alive": "fuzzypatternmatching_tpu/engine/driver.py:233-315",
}
WALK_KERNELS = ("expand_frontier", "forward_winners")
FUSED_KERNELS = ("init_superstep", "continuation_superstep")
KERNEL_SOURCES = {
    k: "fuzzypatternmatching_tpu_torch/csrc/"
    + ("nlcc_frontier.cu" if k in WALK_KERNELS
       else "lcc_fused.cu" if k in FUSED_KERNELS else "lcc_superstep.cu")
    for k in KERNELS
}
DENSITIES = (0.005, 0.6, 1.0)
# the bucketed engine's kernels in the default mode (phases 5-7, 27)
BUCKET_KERNELS = ("pack_alive", "rev_alive_lookup") + FUSED_KERNELS
# the mesh superstep's kernels (phases 20-24)
PAYLOAD = "gather_accept_or_payload"
SENDS = "pack_sends"
MESH_KERNELS = (SENDS, PAYLOAD)
MESH_SHARDS = 4  # the s21 mesh of phases 22-23, on the one card
# phases 24-25: 2 processes x 2 shards (the 4 shards of phase 22's mesh)
MESH_PROCESSES = 2
GRAPH_FILES = ("row_ptr", "cols", "rev_edge", "raw_degree", "edge_row")
CHILD_TIMEOUT = 420  # seconds the launcher and its processes may take


def log(msg):
    print_line(msg)  # the processes of phases 24-25 share one pipe


def summary(r):
    return {
        "active_vertices": len(r.active_vertices),
        "active_edges": len(r.active_edges),
        "subgraphs": sum(len(v) for v in r.subgraphs.values()),
        "traversed_edges": r.traversed_edges,
    }


def check_anchors(r, want, what):
    got = summary(r)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{what}: anchors differ (got, expected): {bad}")


def max_err(got, want):
    """Largest absolute difference between two integer/bool tensors."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} != {want.shape} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def table_err(got, want):
    if got.group_log2 != want.group_log2:
        raise AssertionError(f"group_log2 {got.group_log2} != {want.group_log2}")
    return max(max_err(got.words, want.words), max_err(got.summary, want.summary))


def ptxas_usage(out):
    """(kernel, registers, static shared bytes, spill bytes) per entry
    function, from the output of nvcc -Xptxas -v."""
    import re

    rows, name, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?N_\w*?\d+([a-z_]+kernel)(\w*)'", line)
        if m:
            tmpl = re.findall(r"L[ib](\d+)E", m.group(2))
            name = m.group(1) + (f"<{','.join(tmpl)}>" if tmpl else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0), spill))
            name = None
    return rows


def reset_launches():
    """Zero the launch counts of every kernel wrapper."""
    ops.reset_launches()
    lf.reset_launches()
    nf.reset_launches()


def superstep_launches():
    """The launch counts of the LCC superstep kernels."""
    return {**ops.launches, **lf.launches}


def check_errs(errs, where):
    for k, e in errs.items():
        if e != 0:
            raise AssertionError(f"{k}: kernel differs from its twin {where} by {e}")


def compare_kernels_small(dev, errs):
    """Phase 3: each kernel against its twin on seeded inputs."""
    for density in DENSITIES:
        for n, budget in ((1, 16), (1025, 16), (40000, 64), (300001, 256),
                          (1000003, 64), (1000003, ops.SUMMARY_BUDGET_BYTES)):
            rng = np.random.RandomState(n + budget)
            alive = torch.from_numpy(rng.rand(n) < density).to(dev)
            alive[-1] = False  # the pad slot
            got = ops.alive_table(alive, budget)
            torch.cuda.synchronize()
            errs["pack_alive"] = max(
                errs["pack_alive"], table_err(got, ops.alive_table_reference(alive, budget))
            )
            rev = torch.from_numpy(rng.randint(0, n, size=9999).astype(np.int32)).to(dev)
            e = max_err(ops.rev_alive_lookup(rev, got), ops.rev_alive_lookup_reference(rev, got))
            errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)

        for w in (8, 128, 1024, 8192):
            for n in (0, 1, 1000):
                rng = np.random.RandomState(n * 7 + w)
                S = 70000
                alive = rng.rand(S + 1) < density
                alive[S] = False
                rev = rng.randint(0, S + 1, size=(n, w)).astype(np.int32)
                rev[:, -1] = S  # pad sentinel reads the dead pad bit
                table = ops.alive_table(torch.from_numpy(alive).to(dev))
                rev_d = torch.from_numpy(rev).to(dev)
                got = ops.rev_alive_lookup(rev_d, table)
                torch.cuda.synchronize()
                e = max_err(got, ops.rev_alive_lookup_reference(rev_d, table))
                errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)

        for w in (8, 16, 64, 128, 512, 1024, 8192):
            for n in (0, 1, 33, 1000):
                rng = np.random.RandomState(n * 7 + w)
                V = 50000
                tv = rng.randint(0, 1 << 16, size=V + 1).astype(np.int32)
                tv[rng.rand(V + 1) < 0.5] = 0
                tv[V] = 0
                adj = rng.randint(0, V + 1, size=(n, w)).astype(np.int32)
                adj[:, -1] = V  # pad sentinel reads the zero table entry
                alive_rev = rng.rand(n, w) < density
                mask = rng.randint(0, 1 << 16, size=n).astype(np.int32)
                for m in (mask, np.zeros_like(mask), np.full_like(mask, 0xFFFF)):
                    args = [
                        torch.from_numpy(a).to(dev) for a in (adj, alive_rev, m, tv)
                    ]
                    got = ops.gather_accept_or(*args)
                    torch.cuda.synchronize()
                    want = ops.gather_accept_or_reference(*args)
                    for g, r in zip(got, want):
                        errs["gather_accept_or"] = max(
                            errs["gather_accept_or"], max_err(g, r)
                        )
    for kind in ("random", "pad_heavy", "all_dead", "outside"):
        for n in (1, 3, 4, 10_001, 300_000):
            for offset in (0, 1):
                planes = map_case(n + len(kind), kind, n, offset, dev)
                got = ops.map_alive(*planes)
                torch.cuda.synchronize()
                for g, r in zip(got, ops.map_alive_reference(*planes)):
                    errs["map_alive"] = max(errs["map_alive"], max_err(g, r))
    check_errs(errs, "at small shapes")
    log(f"[3] kernels equal their twins (tables n 1..1e6 at G 32..2048; widths "
        f"8..8192, n 0/1/33/1000; densities {DENSITIES}; slot maps of 1..300,000 "
        f"slots, aligned and not): {errs}")


def map_case(seed, kind, n, offset, dev, v=3_000, density=0.3):
    """map_alive's inputs on ``dev``: a full plane of S + 1 flags and an
    injective map of ``n`` closure slots into it, a share of them pads (the
    dead pad slot S), with their rows and columns, and tv over ``v``
    vertices (a few live ones that no slot may touch); "outside" sets alive
    slots off the map; ``offset`` 1 starts the map one element in (off 16
    bytes)."""
    rng = np.random.RandomState(seed)
    s_full = max(40_000, 2 * n)
    alive = rng.rand(s_full + 1) < (0.0 if kind == "all_dead" else density)
    alive[s_full] = False
    sub2full = rng.permutation(s_full)[: n + offset].astype(np.int32)
    pads = rng.rand(n + offset) < (0.9 if kind == "pad_heavy" else 0.1)
    sub2full[pads] = s_full
    if kind == "outside":
        off = np.setdiff1d(np.arange(s_full), sub2full)
        alive[off[: len(off) // 2]] = True
    row = rng.randint(0, v, size=n + offset).astype(np.int32)
    col = rng.randint(0, v, size=n + offset).astype(np.int32)
    row[pads] = col[pads] = 0
    maps = [torch.from_numpy(a).to(dev)[offset:] for a in (sub2full, row, col)]
    tv = np.where(rng.rand(v) < 0.002, rng.randint(1, 1 << 16, size=v), 0).astype(np.int32)
    return (torch.from_numpy(alive).to(dev), *maps, torch.from_numpy(tv).to(dev))


def timed_search(engine, anchors, what):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_anchors(r, anchors, what)
    lp = sum(x.seconds for x in r.rows if x.phase == "LP")
    tp = sum(x.seconds for x in r.rows if x.phase == "TP")
    return r, dt, lp, tp


def lp_rows(r):
    """(iteration, step, active vertices, active edges, messages) of each
    LP row."""
    return [(x.itr, x.step, x.active_vertices, x.active_edges, x.messages)
            for x in r.rows if x.phase == "LP"]


def compact_mode(engine, compact):
    """The s21 engine with its compact continuation on or off: what
    ``MatchEngine(compact=...)`` sets, without a second engine build."""
    engine._compact_engine = compact
    return engine


def run_s21(g, labels, pattern, constraints, dev, compact, engine=None):
    """Phases 5 and 6; phase 6 takes phase 5's engine (``engine``)."""
    tag = "[5]" if compact else "[6]"
    if engine is None:
        t0 = time.perf_counter()
        engine = MatchEngine(g, labels, pattern, constraints, device=dev)
        torch.cuda.synchronize()
        log(f"{tag} engine build (host ELL layout + upload): "
            f"{time.perf_counter() - t0:.3f} s, {engine.lcc.num_slots} slots")
    compact_mode(engine, compact)
    reset_launches()
    r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 compact={compact} warm")
    launches = superstep_launches()
    steps = len(lp_rows(r))
    log(f"{tag} warm search: {dt:.4f} s, iterations={r.iterations}, "
        f"{summary(r)}, {steps} supersteps, kernel launches {launches}, walk kernel "
        f"launches (nlcc_mode auto) {dict(nf.launches)}")
    for k in BUCKET_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k}: no launch during the s21 search")
    # the default mode's supersteps are the fused kernels, at most 2 launches
    # of each a superstep; no search launches gather_accept_or
    if (launches["continuation_superstep"] < 7 or launches["gather_accept_or"]
            or max(launches[k] for k in FUSED_KERNELS) > 2 * steps):
        raise AssertionError(f"s21 compact={compact}: {steps} supersteps, launches {launches}")
    times = []
    mapped = ops.launches["map_alive"]
    for i in range(3):
        r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 compact={compact} run {i}")
        times.append(dt)
        log(f"{tag} timed search {i}: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s, "
            f"other {dt - lp - tp:.4f} s), "
            f"{r.traversed_edges / dt / 1e6:.2f} M traversed edges/s, "
            f"host loadavg {os.getloadavg()}")
    log(f"{tag} anchors OK on every run {S21_ANCHORS}; best {min(times):.4f} s = "
        f"{r.traversed_edges / min(times) / 1e6:.2f} M traversed edges/s")
    # the warm search builds the closure; each timed one maps into it
    launches["map_alive"] = (ops.launches["map_alive"] - mapped) / 3
    if launches["map_alive"] != (1 if compact else 0):
        raise AssertionError(f"s21 compact={compact}: map_alive launches {launches['map_alive']} "
                             "a timed search")
    return engine, launches, r


def time_cuda(fn, reps=20, graph=True):
    """Milliseconds per call of ``fn`` by CUDA events. ``graph=True`` times
    the device work alone: the calls are captured once in a CUDA graph and
    the graph is replayed. ``graph=False`` times eager calls, host dispatch
    included (the device waits for the host between small launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain):
    """(kernel ms, plain ms) of device time, each the mean of two timings
    in turns (plain, kernel, kernel, plain), and the raw values."""
    p1 = time_cuda(plain)
    k1 = time_cuda(kernel)
    k2 = time_cuda(kernel)
    p2 = time_cuda(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def bucket_planes(lcc, alive_rev, masks):
    """(device bucket, row masks, its alive_rev view [n, w]) per bucket."""
    out = []
    for d, b, m in zip(lcc._dev, lcc.buckets, masks):
        n, w = d.adj.shape
        out.append((d, m, alive_rev[b.slot_base : b.slot_base + n * w].view(n, w)))
    return out


def bound_ms(lcc, table, planes):
    """Least time of each kernel on these inputs: the bytes it must move
    (each input read once, each output written once; the gathers only
    where this state's data needs them) over the HBM rate."""
    s = lcc.num_slots
    n_flags = s + 1
    g = table.group_log2
    # words of the groups with an alive bit are all the lookup may read
    group_bits = ((table.summary.view(-1, 1) >> torch.arange(32, device=table.summary.device)) & 1)
    alive_groups = int(group_bits.sum())
    word_bytes = 4 * min(alive_groups << (g - 5), table.words.numel())
    pack = n_flags + 4 * table.words.numel() + 4 * table.summary.numel()
    lookup = 5 * s + 4 * table.summary.numel() + word_bytes
    gather = 0
    for d, _, a in planes:
        n, w = d.adj.shape
        n_alive = int(a.sum())
        distinct_tv = int(torch.unique(d.adj[a]).numel())
        gather += 2 * n * w + 12 * n + 4 * n_alive + 4 * distinct_tv
    return {
        "pack_alive": pack / HBM_BYTES_PER_MS,
        "rev_alive_lookup": lookup / HBM_BYTES_PER_MS,
        "gather_accept_or": gather / HBM_BYTES_PER_MS,
    }, {"alive_groups_share": alive_groups / max(1, -(-n_flags >> g))}


def kernels_at_s21(lcc, errs):
    """Phase 7: every kernel against its twin on the inputs of a non-init
    superstep over the full s21 graph, on the state after the init
    superstep and on an all-alive state; times per superstep (all
    buckets), kernel and twin in turns: device time from CUDA-graph replay,
    and the kernel's eager time per superstep beside it."""
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv_table = torch.cat([st.tv, st.tv.new_zeros(1)])
    masks = [lcc._or_over_bits(st.tv[d.seg_rows])[d.seg_id] for d in lcc._dev]
    dense = torch.ones_like(st.alive)
    dense[-1] = False  # the pad slot stays dead
    rev = lcc._rev_flat
    results = {}
    for name, alive in (("post-init", st.alive), ("all-alive", dense)):
        table = ops.alive_table(alive)
        table_ref = ops.alive_table_reference(alive)
        errs["pack_alive"] = max(errs["pack_alive"], table_err(table, table_ref))
        alive_rev = ops.rev_alive_lookup(rev, table)
        e = max_err(alive_rev, ops.rev_alive_lookup_reference(rev, table_ref))
        errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)
        planes = bucket_planes(lcc, alive_rev, masks)
        for d, m, a in planes:
            got = ops.gather_accept_or(d.adj, a, m, tv_table)
            want = ops.gather_accept_or_reference(d.adj, a, m, tv_table)
            for g, r in zip(got, want):
                errs["gather_accept_or"] = max(errs["gather_accept_or"], max_err(g, r))
        torch.cuda.synchronize()
        check_errs(errs, f"at s21 ({name})")

        fns = {
            "pack_alive": (
                lambda: ops.alive_table(alive),
                lambda: ops.alive_table_reference(alive),
            ),
            "rev_alive_lookup": (
                lambda: ops.rev_alive_lookup(rev, table),
                lambda: ops.rev_alive_lookup_reference(rev, table),
            ),
            "gather_accept_or": (
                lambda: [ops.gather_accept_or(d.adj, a, m, tv_table) for d, m, a in planes],
                lambda: [
                    ops.gather_accept_or_reference(d.adj, a, m, tv_table)
                    for d, m, a in planes
                ],
            ),
        }
        bounds, info = bound_ms(lcc, table, planes)
        n_alive = int(alive[:-1].sum())
        log(f"[7] {name}: {n_alive} alive slots of {lcc.num_slots}, "
            f"G = {1 << table.group_log2}, summary {4 * table.summary.numel()} B, "
            f"alive groups {info['alive_groups_share']:.4f}, "
            f"alive_rev set {int(alive_rev.sum())}")
        times = {}
        for k, (kernel, plain) in fns.items():
            k_ms, p_ms, raw = time_pair(kernel, plain)
            times[k] = (k_ms, p_ms, bounds[k])
            log(f"[7] {name} {k} ({len(planes)} buckets): kernel "
                f"{raw[0]:.4f}/{raw[1]:.4f} ms, twin {raw[2]:.4f}/{raw[3]:.4f} ms, "
                f"bound {bounds[k]:.4f} ms (bytes), "
                f"{100 * bounds[k] / k_ms:.1f} % of bound; eager kernel calls "
                f"{time_cuda(kernel, graph=False):.4f} ms")
        per_bucket = [
            (tuple(d.adj.shape), int(a.sum()),
             round(time_cuda(lambda: ops.gather_accept_or(d.adj, a, m, tv_table)), 4))
            for d, m, a in planes
        ]
        log(f"[7] {name} gather_accept_or per bucket ((n, w), alive_rev set, ms): "
            f"{per_bucket}")
        rev_sorted = torch.sort(rev).values
        t_sorted = time_cuda(lambda: ops.rev_alive_lookup(rev_sorted, table))
        t_random = time_cuda(lambda: ops.rev_alive_lookup(rev, table))
        log(f"[7] {name} rev_alive_lookup with rev sorted: {t_sorted:.4f} ms "
            f"(as laid out: {t_random:.4f} ms)")
        # library yardstick: one PyTorch indexing call on the bool slot flags
        # computes what alive_table + rev_alive_lookup compute (the port
        # never calls it)
        if not torch.equal(alive[rev], alive_rev):
            raise AssertionError(f"alive[rev] differs from rev_alive_lookup ({name})")
        lib_ms = time_cuda(lambda: alive[rev])
        pair_ms = times["pack_alive"][0] + times["rev_alive_lookup"][0]
        times["rev_alive_lookup"] += (lib_ms,)
        log(f"[7] {name} library call alive[rev] (torch indexing): {lib_ms:.4f} ms, against "
            f"pack_alive + rev_alive_lookup {pair_ms:.4f} ms "
            f"({'the kernels' if pair_ms < lib_ms else 'the library call'} faster)")
        results[name] = times
        del table_ref
    return results


def map_alive_at_s21(engine, errs):
    """Phase 7: map_alive on the s21 post-init alive plane and the cached
    closure's slot map (what a search's first compact phase launches)
    against its twin; the kernel's device time by CUDA-graph replay, the
    twin's eager (its boolean-mask index reads a size back, which a graph
    cannot hold), beside the bytes bound: per closure slot the 4-byte map
    read, the 1-byte gather and the 1-byte write, per alive slot its row
    and column, the touched plane zeroed and read, tv read and the stats."""
    lcc, smap = engine.lcc, engine._sub_cache[5]
    st, rows, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    args = (st.alive, smap.sub2full, smap.row, smap.col, st.tv)
    got = ops.map_alive(*args)
    want = ops.map_alive_reference(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        errs["map_alive"] = max(errs["map_alive"], max_err(g, r))
    check_errs(errs, "at s21 (post-init, cached closure)")
    n, alive = smap.sub2full.numel(), int(got[2][0])
    if alive != rows[0][1]:
        raise AssertionError(f"map_alive: {alive} alive slots mapped, the init superstep {rows[0][1]}")
    bound = (6 * n + 8 * alive + 6 * lcc.num_vertices + 16) / HBM_BYTES_PER_MS
    k1, k2 = time_cuda(lambda: ops.map_alive(*args)), time_cuda(lambda: ops.map_alive(*args))
    p_ms = time_cuda(lambda: ops.map_alive_reference(*args), graph=False)
    eager = time_cuda(lambda: ops.map_alive(*args), graph=False)
    log(f"[7] post-init map_alive ({n} closure slots, {alive} alive, V {lcc.num_vertices}): "
        f"kernel {k1:.4f}/{k2:.4f} ms, twin (eager) {p_ms:.4f} ms, bound {bound:.4f} ms "
        f"(bytes), {100 * bound / ((k1 + k2) / 2):.1f} % of bound; eager kernel calls "
        f"{eager:.4f} ms")
    return {"map_alive": ((k1 + k2) / 2, p_ms, bound)}


def profile_search(engine, tag, anchors=S21_ANCHORS, phase="[8]"):
    """Phase 8 (and 13): one search under torch.profiler; device busy share
    and the largest device items (kernel self time summed by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_anchors(r, anchors, f"{tag} profiled search")

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in items) / 1e3
    if device_ms == 0:
        log(f"{phase} {tag}: the profiler recorded no device time (not measured)")
        return
    ours = [e for e in items if any(k in e.key for k in (
        "pack_alive_kernel", "rev_alive_kernel", "gather_narrow4_kernel", "superstep_kernel",
        "gather_wide_kernel", "gather_rowwise_kernel", "map_alive_kernel",
        "expand_count_kernel",
        "expand_write_kernel", "winner_insert_kernel", "winner_mark_kernel",
        "bit_plane_kernel", "plane_summary_kernel", "plane_count_kernel", "plane_write_kernel",
        "winner_hist_kernel", "winner_scan_kernel", "winner_scatter_kernel",
        "winner_table_kernel", "winner_gather_kernel"))]
    top = sorted(items, key=dev_us, reverse=True)[:8]
    log(f"{phase} {tag} profiled search: wall {wall * 1e3:.1f} ms, device "
        f"{device_ms:.2f} ms (busy {100 * device_ms / (wall * 1e3):.1f} %), "
        f"{sum(e.count for e in items)} device items; the port's kernels "
        f"{sum(dev_us(e) for e in ours) / 1e3:.3f} ms in "
        f"{sum(e.count for e in ours)} launches; largest (name, ms, count): "
        f"{[(e.key[:100], round(dev_us(e) / 1e3, 3), e.count) for e in top]}")


def walk_expand_inputs(seed, n, hubs, density, dev):
    """Seeded inputs of expand_frontier: a CSR over 3,000 vertices with
    zero-degree rows and a hub row of 20,000 neighbours (vertex 7), a
    frontier of ``n`` tokens (``hubs`` of them on the hub), ok bits set at
    ``density`` (bit 31 on half the vertices), and a third of the tokens
    with neighbours coming from their first neighbour."""
    rng = np.random.RandomState(seed)
    v = 3000
    deg = rng.randint(0, 12, size=v)
    deg[rng.rand(v) < 0.2] = 0
    deg[7] = 20000
    ptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    col = rng.randint(0, v, size=int(ptr[-1])).astype(np.int32)
    ok = (rng.rand(v, 31) < density).astype(np.uint64)
    bits = (ok << np.arange(31, dtype=np.uint64)).sum(axis=1)
    bits[rng.rand(v) < 0.5] |= np.uint64(1 << 31)
    cur = rng.randint(0, v, size=n).astype(np.int32)
    cur[rng.permutation(n)[:hubs]] = 7
    parent = rng.randint(0, v, size=n).astype(np.int32)
    back = np.nonzero(ptr[cur + 1] > ptr[cur])[0][::3]
    parent[back] = col[ptr[cur[back]]]
    arrays = (ptr, col, cur, parent, bits.astype(np.uint32).view(np.int32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def walk_winner_inputs(seed, n_lanes, n_keys, n_seen, dev):
    """Seeded inputs of forward_winners: ``n_lanes`` keys drawn from
    ``n_keys`` distinct ones, parents repeating within a key, and earlier
    keys (some among this hop's, ``n_seen`` others)."""
    rng = np.random.RandomState(seed)
    pool = np.unique(rng.randint(0, 1 << 40, size=max(n_keys, 1), dtype=np.int64))
    keys = pool[rng.randint(0, len(pool), size=n_lanes)]
    parents = rng.randint(0, 50, size=n_lanes).astype(np.int32)
    seen = np.concatenate([
        pool[rng.rand(len(pool)) < 0.3],
        np.unique(rng.randint(1 << 41, 1 << 42, size=n_seen, dtype=np.int64)),
    ])
    rng.shuffle(seen)
    return [torch.from_numpy(a).to(dev) for a in (keys, parents, seen)]


def expansion_err(got, want):
    if got.lanes != want.lanes:
        raise AssertionError(f"lanes {got.lanes} != {want.lanes}")
    return max(max_err(g, w) for g, w in zip(got[:3], want[:3]))


def compare_walk_kernels_small(dev, errs):
    """Phase 9: the NLCC walk kernels against their twins on seeded inputs."""
    expand_cases = [
        # (tokens, hub tokens, ok-bit density, h_next, ranks, drop parent)
        (0, 0, 0.5, 1, 1, False),
        (1, 1, 0.5, 2, 4, True),
        (1, 0, 0.5, 2, 1, True),
        (1000, 3, 0.5, 3, 1, True),
        (1000, 3, 0.5, 3, 4, False),
        (1000, 0, 0.0, 1, 4, True),
        (1000, 0, 1.0, 1, 1, True),
        (1000, 2, 0.3, -1, 4, False),
        (50000, 40, 0.02, 5, 1, True),
        (50000, 40, 0.02, 5, 5000, True),
    ]
    for i, (n, hubs, density, h, r, drop) in enumerate(expand_cases):
        args = walk_expand_inputs(i, n, hubs, density, dev)
        got = nf.expand_frontier(*args, h, r, drop)
        torch.cuda.synchronize()
        want = nf.expand_frontier_reference(*args, h, r, drop)
        errs["expand_frontier"] = max(errs["expand_frontier"], expansion_err(got, want))
    for i, case in enumerate([(0, 5, 0), (1, 1, 0), (1000, 37, 10), (100000, 5000, 3000),
                              (200000, 150000, 50000)]):
        args = walk_winner_inputs(i, *case, dev)
        got = nf.forward_winners(*args)
        torch.cuda.synchronize()
        e = max_err(got, nf.forward_winners_reference(*args))
        errs["forward_winners"] = max(errs["forward_winners"], e)
    # two hops: the first hop's winners join the earlier keys
    keys, parents, seen = walk_winner_inputs(9, 300000, 40000, 20000, dev)
    win = nf.forward_winners(keys, parents, seen)
    seen = torch.cat([seen, keys[win]])
    keys2 = torch.cat([keys[: 100000], keys[: 50000] + 1])
    parents2 = torch.cat([parents[: 100000], parents[: 50000]])
    got = nf.forward_winners(keys2, parents2, seen)
    torch.cuda.synchronize()
    e = max_err(got, nf.forward_winners_reference(keys2, parents2, seen))
    errs["forward_winners"] = max(errs["forward_winners"], e)
    check_errs(errs, "at small shapes (walk kernels)")
    log(f"[9] walk kernels equal their twins ({len(expand_cases)} expansions: "
        f"0..50,000 tokens, hub rows of 20,000, ranks 1/4/5000, filters none/all/-1; "
        f"winners: 0..300,000 lanes, repeats within and across hops): "
        f"{ {k: errs[k] for k in WALK_KERNELS} }")


# V: the route a large filtered expand_frontier call takes
ROUTE_VERTICES = {
    300: "summary-1",  # the summary is the plane
    (1 << 21) + 7: "summary-2",  # s21 (+7: V not a multiple of 32)
    1 << 22: "summary-4",
    (1 << 23) - 5: "summary-8",
    (1 << 24) + 3: "summary-16",  # s24
}


def walk_route_inputs(seed, v, dev, n_tok=3000, rows=2000):
    """expand_frontier inputs over ``v`` vertices: ``rows`` non-empty rows
    (one hub of 20,000 neighbours), neighbours spread over all of ``v``,
    random arrival words (half of them zero), tokens on full and empty
    rows, a third coming back from their first neighbour."""
    rng = np.random.RandomState(seed)
    deg = np.zeros(v, dtype=np.int64)
    full = rng.randint(0, v, size=rows)
    deg[full] = rng.randint(1, 40, size=rows)
    deg[full[0]] = 20000
    ptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    col = rng.randint(0, v, size=int(ptr[-1])).astype(np.int32)
    ok_bits = rng.randint(-(1 << 31), 1 << 31, size=v, dtype=np.int64)
    ok_bits[rng.rand(v) < 0.5] = 0
    cur = np.concatenate([full[rng.randint(0, rows, size=n_tok - 100)],
                          rng.randint(0, v, size=100)]).astype(np.int32)
    parent = rng.randint(0, v, size=n_tok).astype(np.int32)
    back = np.nonzero(ptr[cur + 1] > ptr[cur])[0][::3]
    parent[back] = col[ptr[cur[back]]]
    arrays = (ptr, col, cur, parent, ok_bits.astype(np.int32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def compare_walk_routes_small(dev, errs):
    """Phase 9: every route of the walk kernels against the twins: the
    plane's summary in shared memory at 1, 2, 4, 8 and 16 vertices a bit
    (chosen from V), the first design, the unfiltered design, h_next 0, 30
    and -1; the plane and summary kernels; the partitioned winners with
    their own tables and with tables forced small (partitions on their
    global-memory tables), and the global-table design."""
    seen_routes = set()
    big = nf.PLANE_MIN_LANES
    for v, summary in ROUTE_VERTICES.items():
        if nf.expand_route(v, 0, big) != summary:
            raise AssertionError(f"V={v}: route {nf.expand_route(v, 0, big)}")
        args = walk_route_inputs(v % 1000, v, dev)
        for h in (0, 30, -1):
            for r, drop in ((1, True), (5000, False)):
                want = nf.expand_frontier_reference(*args, h, r, drop)
                forced = [None] if h < 0 else [None, "summary"]
                for route in forced:
                    nf.reset_launches()
                    got = nf.expand_frontier_cuda(*args, h, r, drop, route=route)
                    torch.cuda.synchronize()
                    errs["expand_frontier"] = max(errs["expand_frontier"],
                                                  expansion_err(got, want))
                    seen_routes.update(nf.routes)
        n_words = nf.plane_words(v)
        for h in (0, 30, 31):
            plane = nf.bit_plane(args[4], h, n_words)
            e = max_err(plane, nf.bit_plane_reference(args[4], h, n_words))
            g, s_words = nf.summary_layout(v)
            for gl in {g, g + 1, 6}:
                e = max(e, max_err(nf.plane_summary(plane, gl, s_words),
                                   nf.plane_summary_reference(plane, gl, s_words)))
            errs["expand_frontier"] = max(errs["expand_frontier"], e)
        del args
    # a hop of PLANE_MIN_LANES lanes or more takes the summary route itself
    ptr, col, cur, parent, ok_bits = walk_route_inputs(5, 1 << 16, dev)
    hub = int(torch.argmax(ptr[1:] - ptr[:-1]))
    n_hub = big // 20000 + 50  # tokens on the hub row of 20,000
    cur = torch.cat([cur, torch.full((n_hub,), hub, dtype=torch.int32, device=dev)])
    parent = torch.cat([parent, parent[:n_hub]])
    nf.reset_launches()
    got = nf.expand_frontier(ptr, col, cur, parent, ok_bits, 3, 4, True)
    want = nf.expand_frontier_reference(ptr, col, cur, parent, ok_bits, 3, 4, True)
    if want.lanes < big or nf.routes != {"summary-1": 1}:
        raise AssertionError(f"{want.lanes} lanes took routes {nf.routes}")
    errs["expand_frontier"] = max(errs["expand_frontier"], expansion_err(got, want))
    del ptr, col, cur, parent, ok_bits
    cases = [(0, 5, 0), (1, 1, 0), (1000, 37, 10), (100000, 5000, 3000), (300000, 200000, 50000)]
    for i, case in enumerate(cases):
        args = walk_winner_inputs(20 + i, *case, dev)
        want = nf.forward_winners_reference(*args)
        for kw in ({}, {"route": "partition"}, {"route": "partition", "table_slots": 64},
                   {"route": "partition", "table_slots": 2}, {"route": "global-table"}):
            got = nf.forward_winners_cuda(*args, **kw)
            torch.cuda.synchronize()
            errs["forward_winners"] = max(errs["forward_winners"], max_err(got, want))
    check_errs(errs, "on the walk kernels' routes")
    log(f"[9] walk-kernel routes equal their twins: expand_frontier routes "
        f"{sorted(seen_routes)} at V {list(ROUTE_VERTICES)} (h_next 0/30/-1, ranks 1/5000; "
        f"summary-1 by itself at {big} lanes), the plane and summary kernels at bits "
        f"0/30/31; forward_winners partitioned (tables sized by winner_table_slots, and of 64 "
        f"and 2 slots: partitions on their global tables) and the first design, "
        f"{len(cases)} cases: {errs['expand_frontier']}, {errs['forward_winners']}")


def host_profile(fn, tag, top=12):
    """Run ``fn`` once under cProfile and log the functions with the most
    host time of their own (name, calls, own s, cumulative s)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:top]
    total = sum(v[2] for v in stats.values())
    log(f"{tag} host profile ({total:.3f} s of own time in all): " + str([
        (f"{os.path.basename(f)}:{line}({name})", nc, round(tt, 4), round(ct, 4))
        for (f, line, name), (_, nc, tt, ct, _) in rows
    ]))


def tp_rows(r):
    """(iteration, constraint, seconds, messages) of each TP row."""
    return [(x.itr, x.step, round(x.seconds, 4), x.messages) for x in r.rows if x.phase == "TP"]


def run_s21_cycle(g, labels, dev):
    """Phase 11: the s21 cycle search, device mode warm and timed, then one
    search each in host and auto mode on the same engine."""
    pattern = load_pattern_graph(CYCLE_CORPUS)
    constraints = load_nonlocal_constraints(CYCLE_CORPUS, pattern.vertex_data)
    t0 = time.perf_counter()
    engine = MatchEngine(g, labels, pattern, constraints, nlcc_mode="device", device=dev)
    torch.cuda.synchronize()
    log(f"[11] s21 cycle engine build: {time.perf_counter() - t0:.3f} s, "
        f"{engine.lcc.num_slots} slots, {len(constraints)} constraints")
    reset_launches()
    r, dt, lp, tp = timed_search(engine, S21_CYCLE_ANCHORS, "s21 cycle device warm")
    launches = {**ops.launches, **nf.launches}
    log(f"[11] device warm search: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s), "
        f"iterations={r.iterations}, {summary(r)}, kernel launches {launches}, "
        f"walk-kernel routes {nf.routes}, TP rows {tp_rows(r)}")
    for k in WALK_KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k}: no launch during the s21 cycle device search")
    if not nf.routes.get(nf.expand_route(g.num_vertices, 1, nf.PLANE_MIN_LANES)) or not (
        nf.routes.get("partition")
    ):
        raise AssertionError(f"s21 cycle device search took routes {nf.routes}")
    r, dt, lp, tp = timed_search(engine, S21_CYCLE_ANCHORS, "s21 cycle device timed")
    log(f"[11] device timed search: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s, "
        f"other {dt - lp - tp:.4f} s), {r.traversed_edges / dt / 1e6:.2f} M traversed "
        f"edges/s, TP rows {tp_rows(r)}, host loadavg {os.getloadavg()}")
    for mode in ("host", "auto"):
        engine.nlcc_mode = mode
        nf.reset_launches()
        r, dt, lp, tp = timed_search(engine, S21_CYCLE_ANCHORS, f"s21 cycle {mode}")
        log(f"[11] {mode} search (nlcc_device_min {engine.nlcc_device_min}): {dt:.4f} s "
            f"(LP {lp:.4f} s, TP {tp:.4f} s), TP rows {tp_rows(r)}, walk kernel "
            f"launches {dict(nf.launches)}, host loadavg {os.getloadavg()}")
        if mode == "auto" and nf.launches["expand_frontier"] == 0:
            raise AssertionError("auto mode kept s21 cycle constraint 0 on the host")
    engine.nlcc_mode = "device"
    log(f"[11] anchors OK on every run {S21_CYCLE_ANCHORS}")
    return engine, {k: launches[k] for k in WALK_KERNELS}


def sorted_rows(subgraphs):
    return sorted(map(tuple, subgraphs.tolist())) if subgraphs is not None else []


def assert_outcome_equal(h, d, what):
    """The comparison of tests/test_nlcc_device.py::_assert_outcome_equal."""
    same = (
        np.array_equal(h.sources, d.sources)
        and np.array_equal(h.validated, d.validated)
        and h.messages == d.messages
        and np.array_equal(h.msg_per_rank, d.msg_per_rank)
        and sorted(h.edge_marks) == sorted(d.edge_marks)
        and sorted_rows(h.subgraphs) == sorted_rows(d.subgraphs)
    )
    if not same:
        raise AssertionError(f"{what}: device and host outcomes differ "
                             f"(messages {d.messages} / {h.messages})")


def first_lcc_state(engine):
    """(AliveCsr, tv) after the search's first LCC call, as MatchEngine
    builds them for iteration 0's constraints."""
    state, _ = engine._lcc_phase(engine.lcc.init_state(), True, 0, MatchResult())
    tv, arow, acol, _ = engine._host_state(state)  # a device or the compact route's host state
    return nlcc.AliveCsr.from_pairs(arow, acol, tv != 0, engine.graph.num_vertices), tv


def constraint_placements(engine, tag, record=None):
    """Phase 12: each constraint of the engine's corpus on the state after
    the first LCC call, on the card (warm, then 3 timed runs) and on the
    host engine (3 runs, or 1 where one takes over a second); outcomes and
    forwarded keys must be equal. ``record`` (a constraint index) keeps the
    walk-kernel calls of one device run of that constraint."""
    acsr, tv = first_lcc_state(engine)
    V, labels, dn = engine.graph.num_vertices, engine.labels, engine._dev_nlcc
    fw = nlcc.ForwardedSets.empty()
    calls = {k: [] for k in WALK_KERNELS}
    rows = []
    for pl, c in enumerate(engine.constraints):
        cand = engine._cands[pl]
        first = dn._first_expansion(acsr, nlcc.token_sources(c, labels, tv, cand))
        fw.reset_for(c, labels, tv, V)
        keys_in = fw.keys.copy()
        kw = {"candidates": cand}

        def host_run(f):
            if c.is_tds:
                return nlcc.run_tds(acsr, labels, tv, c, V, forwarded=f, num_ranks=engine.num_ranks,
                                    source_batch=engine.source_batch, **kw)
            return nlcc.run_nem(acsr, labels, tv, c, V, forwarded=f, num_ranks=engine.num_ranks, **kw)

        def dev_run(f):
            fn = dn.run_tds if c.is_tds else dn.run_nem
            out = fn(acsr, labels, tv, c, V, forwarded=f, **kw)
            torch.cuda.synchronize()
            return out

        host_s = []
        while len(host_s) < 3 and (not host_s or host_s[0] < 1.0):
            f_h = nlcc.ForwardedSets(keys_in.copy())
            t0 = time.perf_counter()
            out_h = host_run(f_h)
            host_s.append(time.perf_counter() - t0)
        dev_run(nlcc.ForwardedSets(keys_in.copy()))  # warm
        dev_s = []
        for _ in range(3):
            f_d = nlcc.ForwardedSets(keys_in.copy())
            t0 = time.perf_counter()
            out_d = dev_run(f_d)
            dev_s.append(time.perf_counter() - t0)
        assert_outcome_equal(out_h, out_d, f"{tag} constraint {pl}")
        if not np.array_equal(f_h.keys, f_d.keys):
            raise AssertionError(f"{tag} constraint {pl}: forwarded keys differ")
        if record == pl:
            host_profile(lambda: dev_run(nlcc.ForwardedSets(keys_in.copy())),
                         f"[12] {tag} constraint {pl} on the card")
            originals = {k: getattr(nf, k) for k in WALK_KERNELS}

            def recorder(name):
                def call(*a, **k):
                    out = originals[name](*a, **k)
                    calls[name].append((a, out))
                    return out
                return call

            for k in WALK_KERNELS:
                setattr(nf, k, recorder(k))
            try:
                dev_run(nlcc.ForwardedSets(keys_in.copy()))
            finally:
                for k, fn in originals.items():
                    setattr(nf, k, fn)
        rows.append((pl, "tds" if c.is_tds else "nem", first, out_h.messages,
                     len(f_d.keys), min(host_s), min(dev_s)))
        log(f"[12] {tag} constraint {pl} ({rows[-1][1]}, cycle_length {c.cycle_length}): "
            f"first expansion {first} lanes, messages {out_h.messages}, "
            f"{int(out_h.validated.sum())}/{len(out_h.validated)} validated, forwarded keys "
            f"{len(f_d.keys)}; host {[round(x, 4) for x in host_s]} s, device "
            f"{[round(x, 4) for x in dev_s]} s; equal outcomes")
        fw = f_d
    return rows, calls


def time_turns(fns):
    """Device ms of each named function by CUDA-graph replay, timed in turns
    forward then backward (a, b, c, c, b, a): the mean of the two, and the
    raw values."""
    raw = {k: [] for k in fns}
    for k in list(fns) + list(reversed(fns)):
        raw[k].append(time_cuda(fns[k]))
    return {k: sum(v) / 2 for k, v in raw.items()}, raw


def walk_kernels_at_s21(calls, errs):
    """Phase 12: each recorded walk-kernel call of one s21 constraint run
    against its twin (every route), and timed by CUDA-graph replay in
    turns: the shipped design, the first design (the arrival bit read from
    the int32 ok_bits word; one global hash table), the other design (the
    plane's summary; the hash partitions) and the twin; beside the bound
    (bytes read and written once over the HBM rate)."""
    totals = {k: [0.0, 0.0, 0.0] for k in WALK_KERNELS}
    first_design = {k: 0.0 for k in WALK_KERNELS}
    for i, (a, out) in enumerate(calls["expand_frontier"]):
        ptr, col, cur, parent, ok_bits, h, r, drop = a
        sizes = (out.lanes, out.tok.shape[0])
        twin = nf.expand_frontier_reference(*a, sizes=sizes)
        errs["expand_frontier"] = max(errs["expand_frontier"], expansion_err(out, twin))
        fns = {"shipped": lambda: nf.expand_frontier(*a, sizes=sizes)}
        if h >= 0:
            for route in ("first-design", "summary"):
                fns[route] = (lambda route=route:
                              nf.expand_frontier_cuda(*a, sizes=sizes, route=route))
                errs["expand_frontier"] = max(errs["expand_frontier"],
                                              expansion_err(fns[route](), twin))
        fns["twin"] = lambda: nf.expand_frontier_reference(*a, sizes=sizes)
        every = nf.expand_frontier_reference(ptr, col, cur, parent, ok_bits, -1, 1, False,
                                             sizes=(out.lanes, out.lanes))
        distinct = int(torch.unique(every.nbr).numel())
        messages = int(out.msg_per_rank.sum())
        density = ""
        if h >= 0:
            # how much of the hop the plane's summary filters out
            g = nf.summary_layout(ok_bits.shape[0])[0]
            bit = ((ok_bits >> h) & 1).bool()
            grouped = torch.zeros(-(-bit.numel() >> g) << g, dtype=torch.bool, device=bit.device)
            grouped[: bit.numel()] = bit
            group_set = grouped.view(-1, 1 << g).any(1)
            density = (f"; {100 * float(bit.float().mean()):.2f} % of vertices hold the bit, "
                       f"{100 * float(group_set[every.nbr.long() >> g].float().mean()):.2f} % of "
                       f"lanes land on a set summary bit ({1 << g} vertices a bit)")
        del twin, every
        nbytes = 4 * out.lanes + 24 * cur.shape[0] + 4 * distinct + 8 * sizes[1] + 8 * r
        bound = nbytes / HBM_BYTES_PER_MS
        ms, raw = time_turns(fns)
        totals["expand_frontier"] = [
            x + y for x, y in zip(totals["expand_frontier"], (ms["shipped"], ms["twin"], bound))
        ]
        first_design["expand_frontier"] += ms.get("first-design", ms["shipped"])
        log(f"[12] expand_frontier call {i} (h_next {h}, drop {drop}, route "
            f"{nf.expand_route(ok_bits.shape[0], h, out.lanes)}): {cur.shape[0]} tokens, "
            f"{out.lanes} lanes, "
            f"{messages} messages, {sizes[1]} survivors, {distinct} distinct neighbours; "
            f"ms (two turns each): {raw}; bound {bound:.4f} ms ({nbytes} B); shipped "
            f"{ms['shipped']:.4f} ms = {100 * bound / ms['shipped']:.1f} % of bound"
            + density
            + (f", first design {ms['first-design']:.4f} ms, summary route "
               f"{ms['summary']:.4f} ms" if h >= 0 else ""))
    for i, (a, win) in enumerate(calls["forward_winners"]):
        keys, parents, seen = a
        want = nf.forward_winners_reference(*a)
        errs["forward_winners"] = max(errs["forward_winners"], max_err(win, want))
        for route in ("global-table", "partition"):
            e = max_err(nf.forward_winners_cuda(*a, route=route), want)
            errs["forward_winners"] = max(errs["forward_winners"], e)
        n, m = keys.shape[0], seen.shape[0]
        nbytes = 13 * n + 8 * m
        bound = nbytes / HBM_BYTES_PER_MS
        ms, raw = time_turns({
            "shipped": lambda: nf.forward_winners(*a),
            "first-design": lambda: nf.forward_winners_cuda(*a, route="global-table"),
            "partition": lambda: nf.forward_winners_cuda(*a, route="partition"),
            "twin": lambda: nf.forward_winners_reference(*a),
        })
        totals["forward_winners"] = [
            x + y for x, y in zip(totals["forward_winners"], (ms["shipped"], ms["twin"], bound))
        ]
        first_design["forward_winners"] += ms["first-design"]
        log(f"[12] forward_winners call {i} (route {nf.winner_route(n + m)}): {n} lanes, {m} "
            f"earlier keys, {int(win.sum())} winners, {nf.winner_partitions(n + m)} "
            f"partitions; ms (two turns each): {raw}; bound {bound:.4f} ms ({nbytes} B); "
            f"shipped {ms['shipped']:.4f} ms = {100 * bound / ms['shipped']:.1f} % of bound, "
            f"first design {ms['first-design']:.4f} ms, partitioned {ms['partition']:.4f} ms")
    check_errs(errs, "at the s21 cycle hop shapes")
    log(f"[12] walk kernels over one s21 cycle constraint-0 run (shipped, twin, bound ms): "
        f"{totals}; first design {first_design}")
    route_crossovers(calls, errs)
    return {k: (*v, None) for k, v in totals.items()}


# Cuts of the largest hop for route_crossovers: every k-th token of the
# largest filtered expansion (75 M lanes at the s21 cycle hop 3), every
# k-th lane of the largest winners call (855 K entries at hop 2).
EXPAND_CUTS = (64, 40, 32, 24, 20, 16, 12, 8)
WINNER_CUTS = (8, 6, 4, 3, 2, 1)


def route_crossovers(calls, errs):
    """Phase 12: both designs of each walk kernel, timed in turns by
    CUDA-graph replay, on cuts of the largest recorded call around the
    size where the shipped route changes (``PLANE_MIN_LANES``,
    ``WINNER_PARTITION_MIN``); the two outputs must be equal."""
    filtered = [(a, out) for a, out in calls["expand_frontier"] if a[5] >= 0]
    a, out = max(filtered, key=lambda c: c[1].lanes)
    ptr, col, cur, parent, ok_bits, h, r, drop = a
    rows = []
    for k in EXPAND_CUTS:
        cut = (ptr, col, cur[::k].contiguous(), parent[::k].contiguous(), ok_bits, h, r, drop)
        one = nf.expand_frontier_cuda(*cut, route="first-design")
        other = nf.expand_frontier_cuda(*cut, route="summary")
        errs["expand_frontier"] = max(errs["expand_frontier"], expansion_err(other, one))
        sizes = (one.lanes, one.tok.shape[0])
        ms, _ = time_turns({
            route: (lambda route=route: nf.expand_frontier_cuda(*cut, sizes=sizes, route=route))
            for route in ("first-design", "summary")
        })
        rows.append((one.lanes, round(ms["first-design"], 4), round(ms["summary"], 4)))
    log(f"[12] expand_frontier crossover (every k-th token of the {out.lanes}-lane hop, k "
        f"{EXPAND_CUTS}; lanes, first design ms, summary ms; PLANE_MIN_LANES "
        f"{nf.PLANE_MIN_LANES}): {rows}")
    keys, parents, seen = max(calls["forward_winners"], key=lambda c: c[0][0].shape[0])[0]
    rows = []
    for k in WINNER_CUTS:
        cut = (keys[::k].contiguous(), parents[::k].contiguous(), seen)
        one = nf.forward_winners_cuda(*cut, route="global-table")
        other = nf.forward_winners_cuda(*cut, route="partition")
        errs["forward_winners"] = max(errs["forward_winners"], max_err(other, one))
        ms, _ = time_turns({
            route: (lambda route=route: nf.forward_winners_cuda(*cut, route=route))
            for route in ("global-table", "partition")
        })
        rows.append((cut[0].shape[0] + seen.shape[0], round(ms["global-table"], 4),
                     round(ms["partition"], 4)))
    check_errs(errs, "on the crossover cuts")
    log(f"[12] forward_winners crossover (every k-th lane of the hop, k {WINNER_CUTS}, with its "
        f"{seen.shape[0]} earlier keys; entries, global table ms, partitioned ms; "
        f"WINNER_PARTITION_MIN {nf.WINNER_PARTITION_MIN}): {rows}")


def mode_search(g, labels, pattern, constraints, dev, tag, what, **kw):
    """Build a MatchEngine and run its s21 tree search warm and timed,
    asserting the anchors on both; returns (engine, result, launches of
    the superstep kernels, launches of the walk kernels)."""
    t0 = time.perf_counter()
    engine = MatchEngine(g, labels, pattern, constraints, device=dev, **kw)
    torch.cuda.synchronize()
    log(f"{tag} {what} engine build: {time.perf_counter() - t0:.3f} s")
    reset_launches()
    r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 {what} warm")
    launches, walk = superstep_launches(), dict(nf.launches)
    log(f"{tag} {what} warm search: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s), "
        f"iterations={r.iterations}, {summary(r)}, kernel launches {launches}, "
        f"walk kernel launches {walk}")
    r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 {what} timed")
    log(f"{tag} {what} timed search: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s, "
        f"other {dt - lp - tp:.4f} s), {r.traversed_edges / dt / 1e6:.2f} M traversed "
        f"edges/s, host loadavg {os.getloadavg()}; anchors OK {S21_ANCHORS}")
    return engine, r, launches, walk


def run_s21_modes(g, labels, pattern, constraints, dev, rows_full):
    """Phases 14-16: the s21 tree search in counting mode, with edge
    metadata, and on the flat LCC engine. Returns their engines and the
    counting search's launches."""
    counting, _, counting_launches, _ = mode_search(
        g, labels, pattern, constraints, dev, "[14]", "counting", counting=True
    )
    for k in ("rev_alive_lookup", *FUSED_KERNELS):
        if counting_launches[k] == 0:
            raise AssertionError(f"{k}: no launch during the s21 counting search")
    if counting_launches["gather_accept_or"]:
        raise AssertionError(f"s21 counting search launched gather_accept_or: "
                             f"{counting_launches}")
    # the tree corpus's pattern_edge_data carries 55 on every pattern edge
    # (pattern/builtin.py): every graph edge carries 55 too
    values = set(pattern.edge_data.tolist())
    if values != {55}:
        raise AssertionError(f"tree corpus pattern_edge_data values {values}")
    edge_data = np.full(g.num_edges, 55, dtype=np.int64)
    meta, _, launches, walk = mode_search(
        g, labels, pattern, constraints, dev, "[15]", "metadata", edge_data=edge_data
    )
    if meta._meta is None or launches["rev_alive_lookup"] == 0 or any(walk.values()):
        raise AssertionError(f"s21 metadata search: launches {launches}, walk kernels {walk}")
    flat, r, launches, _ = mode_search(
        g, labels, pattern, constraints, dev, "[16]", "flat engine", lcc_engine="flat"
    )
    if lp_rows(r) != rows_full:
        raise AssertionError("s21 flat engine: LP rows differ from the compact=False rows")
    if launches["rev_alive_lookup"] == 0:
        raise AssertionError("s21 flat engine: no rev_alive_lookup launch")
    log(f"[16] flat engine LP rows equal the bucketed compact=False rows "
        f"({len(rows_full)} rows)")
    return {"counting": counting, "metadata": meta, "flat": flat}, counting_launches


def time_mode_supersteps(engines):
    """Phase 17: one non-init superstep over the full s21 graph at the
    state after the init superstep, per branch, timed by CUDA-graph replay
    in turns beside its bytes bound."""
    fns, bounds = {}, {}
    for name in ("default", "counting", "metadata", "flat"):
        lcc = engines[name].lcc
        st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
        alive = st.alive if hasattr(st, "alive") else st.edge_alive
        fns[name] = (lambda lcc=lcc, st=st, alive=alive:
                     lcc._superstep(st.tv, alive, st.tp_flag, init=False))
        nbytes = superstep_bytes(lcc)
        bounds[name] = (nbytes, nbytes / HBM_BYTES_PER_MS)
        log(f"[17] {name}: {int(alive.sum())} alive flags of {alive.numel()}, "
            f"{int((st.tv != 0).sum())} live vertices after the init superstep")
    raw = {k: [] for k in fns}
    for k in list(fns) + list(reversed(fns)):
        raw[k].append(time_cuda(fns[k], reps=5))
    for k, (nbytes, bound) in bounds.items():
        ms = sum(raw[k]) / 2
        log(f"[17] {k} superstep: {ms:.4f} ms (two turns {[round(x, 4) for x in raw[k]]}), "
            f"bound {bound:.4f} ms ({nbytes} B over {HBM_BYTES_PER_MS:.3g} B/ms), "
            f"{100 * bound / ms:.1f} % of bound")


INF32 = 2**31 - 1


def triangles_by_row_intersection(g, dev, chunk=1 << 26):
    """The triangle count by a second formulation: orient each edge from the
    lower to the higher rank of (degree, id), sort the oriented rows, and for
    each oriented edge (u, w) look every vertex of the shorter of the two
    rows up in the other by a binary search over it. Returns (triangles,
    lookups)."""
    v = g.num_vertices
    row_ptr = torch.from_numpy(g.row_ptr).to(dev)
    deg = row_ptr[1:] - row_ptr[:-1]
    ids = torch.arange(v, dtype=torch.int64, device=dev)
    rank = torch.empty_like(ids)
    rank[torch.argsort(deg * v + ids)] = ids
    src = torch.repeat_interleave(ids, deg, output_size=g.num_edges)
    dst = torch.from_numpy(g.cols.astype(np.int64)).to(dev)
    up = rank[src] < rank[dst]
    key = torch.sort(src[up] * v + dst[up]).values
    del src, dst, up, rank
    src, nbr = key // v, key % v
    del key
    optr = torch.zeros(v + 1, dtype=torch.int64, device=dev)
    optr[1:] = torch.cumsum(torch.bincount(src, minlength=v), 0)
    m = nbr.numel()
    row_len = optr[1:] - optr[:-1]
    # per oriented edge: walk the shorter row, search the longer
    short_u = row_len[src] <= row_len[nbr]
    walk = torch.where(short_u, src, nbr)
    search = torch.where(short_u, nbr, src)
    del short_u
    per_edge = row_len[walk]
    cum = torch.cumsum(per_edge, 0)
    lookups = int(cum[-1]) if m else 0
    if lookups == 0:
        return 0, 0
    steps = int(row_len.max()).bit_length() + 1
    targets = chunk * torch.arange(1, -(-lookups // chunk), dtype=torch.int64, device=dev)
    ends = torch.unique(torch.cat([torch.searchsorted(cum, targets, right=True),
                                   torch.tensor([m], device=dev)]))
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    lo_exp = torch.where(starts > 0, cum[(starts - 1).clamp(min=0)], 0)
    bounds = torch.stack([starts, ends, lo_exp, cum[ends - 1]], 1).cpu().tolist()
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for e0, e1, x0, x1 in bounds:
        if x1 == x0:
            continue
        eid = torch.repeat_interleave(torch.arange(e0, e1, device=dev), per_edge[e0:e1],
                                      output_size=x1 - x0)
        off = torch.arange(x0, x1, device=dev) - (cum[eid] - per_edge[eid])
        z = nbr[optr[walk[eid]] + off]
        s_row = search[eid]
        del off
        lo, hi = optr[s_row], optr[s_row + 1]
        end = hi
        del eid, s_row
        for _ in range(steps):
            mid = (lo + hi) >> 1
            less = nbr[mid.clamp(max=m - 1)] < z
            open_ = lo < hi
            lo = torch.where(open_ & less, mid + 1, lo)
            hi = torch.where(open_ & ~less, mid, hi)
        total += ((lo < end) & (nbr[lo.clamp(max=m - 1)] == z)).sum()
    return int(total), lookups


def algo_bytes(g):
    """Bytes one iteration of each algorithm must move (the whole call for
    the triangle count): the CSR read once (cols int32, row_ptr int64),
    each vertex array read and written once, SSSP's float32 weights."""
    v, e = g.num_vertices, g.num_edges
    csr = 4 * e + 8 * (v + 1)
    return {"bfs": csr + 16 * v, "cc": csr + 8 * v, "kcore": csr + 2 * v,
            "pagerank": csr + 8 * v, "sssp": csr + 4 * e + 8 * v, "triangles": csr}


def step_fns(g, dev):
    """One iteration of each iterative algorithm on ``g``, at the state after
    two iterations (PageRank: its first), for CUDA-graph replay."""
    col, erow, deg = frontier._device_csr(g, dev)
    v = g.num_vertices
    level = torch.full((v,), INF32, dtype=torch.int32, device=dev)
    parent = torch.full((v,), -1, dtype=torch.int32, device=dev)
    level[0], parent[0] = 0, 0
    w = torch.ones(g.num_edges, dtype=torch.float32, device=dev)
    dist = torch.full((v,), torch.inf, dtype=torch.float32, device=dev)
    dist[0] = 0.0
    steps = {
        "bfs": (lambda lv, p: frontier._bfs_step(col, erow, lv, p), [level, parent]),
        "cc": (lambda c: frontier._cc_step(col, erow, c),
               [torch.arange(v, dtype=torch.int32, device=dev)]),
        "kcore": (lambda a: frontier._kcore_step(col, erow, a, 4),
                  [torch.ones(v, dtype=torch.bool, device=dev)]),
        "sssp": (lambda d: frontier._sssp_step(col, erow, w, d), [dist]),
    }
    fns = {}
    for name, (step, state) in steps.items():
        for _ in range(2):
            state = list(step(*state)[:-1])
        fns[name] = (lambda step=step, state=state: step(*state))
    pr = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    out_deg = deg.to(torch.float32)
    fns["pagerank"] = lambda: frontier._pagerank_step(col, erow, out_deg, pr, 0.85)
    return fns


def check_algorithm(name, out, anchors):
    """Assert the anchors on one algorithm's output; returns a summary."""
    if name == "bfs":
        level, parent = out
        reached = level < INF32
        got = (int(reached.sum()), int(level[reached].max()),
               int(parent[reached].astype(np.int64).sum()))
        want = (anchors["bfs_reached"], anchors["bfs_max_level"], anchors["bfs_parent_sum"])
    elif name == "cc":
        got, want = len(np.unique(out)), anchors["components"]
    elif name == "kcore":
        got, want = int(out.sum()), anchors["core4"]
    elif name == "pagerank":
        top = np.argsort(out)[-5:][::-1]
        got, want = [int(x) for x in top], anchors["pagerank_top5"]
        if got == want and not np.allclose(out[top], anchors["pagerank_top5_values"],
                                           rtol=1e-5, atol=1e-6):
            raise AssertionError(f"pagerank top-5 values {out[top]}")
        if abs(float(out.sum()) - 1.0) > 1e-5:
            raise AssertionError(f"pagerank sums to {float(out.sum())}")
    elif name == "sssp":
        got, want = int(np.isfinite(out).sum()), anchors["bfs_reached"]
    else:
        got, want = out, anchors["triangles"]
    if got != want:
        raise AssertionError(f"{name}: got {got}, expected {want}")
    return got


def run_algorithms_s21(g, dev, anchors=S21_ALGO_ANCHORS):
    """Phase 18: each classic algorithm on ``g``, warm and three times
    timed, its anchors asserted on every run; then its iteration's device
    time against the bytes bound. Returns the table rows."""
    t0 = time.perf_counter()
    csr = frontier._device_csr(g, dev)
    torch.cuda.synchronize()
    log(f"[18] CSR upload + edge rows on the card (what each call does first): "
        f"{time.perf_counter() - t0:.4f} s for V={g.num_vertices} E={g.num_edges}")
    del csr
    ones = np.ones(g.num_edges)
    calls = {
        "bfs": lambda: frontier.breadth_first_search(g, 0, device=dev),
        "cc": lambda: frontier.connected_components(g, device=dev),
        "kcore": lambda: frontier.kth_core(g, 4, device=dev),
        "pagerank": lambda: frontier.pagerank(g, device=dev),
        "sssp": lambda: frontier.sssp(g, 0, ones, device=dev),
        "triangles": lambda: frontier.triangle_count(g, device=dev),
    }
    seconds, outs = {}, {}
    for name, call in calls.items():
        runs = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t)
            got = check_algorithm(name, out, anchors)
        seconds[name], outs[name] = runs, out
        log(f"[18] {name}: warm {runs[0]:.4f} s, timed "
            f"{[round(x, 4) for x in runs[1:]]} s, {frontier.last_stats[name]}, "
            f"anchors OK ({got}), host loadavg {os.getloadavg()}")
    level = outs["bfs"][0]
    as_dist = np.where(level < INF32, level.astype(np.float32), np.float32(np.inf))
    if not np.array_equal(outs["sssp"], as_dist):
        raise AssertionError("sssp with unit weights differs from the BFS levels")
    t = time.perf_counter()
    second, lookups = triangles_by_row_intersection(g, dev)
    torch.cuda.synchronize()
    log(f"[18] triangles by oriented-row intersection: {second} ({lookups} row lookups, "
        f"{time.perf_counter() - t:.2f} s); the package's count {outs['triangles']}")
    if second != outs["triangles"]:
        raise AssertionError(f"triangle counts differ: {outs['triangles']} / {second}")
    nbytes = algo_bytes(g)
    fns = step_fns(g, dev)
    rows = []
    for name in calls:
        stats = frontier.last_stats[name]
        best = min(seconds[name][1:])
        bound = nbytes[name] / HBM_BYTES_PER_MS
        if name == "triangles":
            iters, ms = stats["chunks"], 1e3 * best / stats["chunks"]
            extra = (f"{stats['wedges']} wedges in {stats['chunks']} chunks, "
                     f"{stats['wedges'] / best / 1e9:.3f} G wedges/s (timed call)")
            share = 100 * bound / (1e3 * best)
        else:
            iters = stats["iterations"]
            ms = time_cuda(fns[name], reps=5)
            extra = f"{1e3 * best / iters:.3f} ms of search time per iteration"
            share = 100 * bound / ms
        rows.append((name, iters, round(seconds[name][0], 4),
                     [round(x, 4) for x in seconds[name][1:]], round(ms, 4),
                     round(bound, 4), round(share, 2)))
        log(f"[18] {name}: {iters} {'chunks' if name == 'triangles' else 'iterations'}, "
            f"device {ms:.4f} ms per {'chunk (timed call / chunks)' if name == 'triangles' else 'iteration (CUDA-graph replay)'}, "
            f"bound {bound:.4f} ms ({nbytes[name]} B{' for the whole call' if name == 'triangles' else ' per iteration'}), "
            f"{share:.2f} % of bound; {extra}")
    log(f"[18] (algorithm, iterations or chunks, warm s, timed s, device ms per "
        f"iteration or chunk, bound ms, share %): {rows}")
    return rows


def result_tree(base):
    """{relative path: rows} of a result tree, wall-clock fields stripped
    (tests/test_golden_results.py's normalisation)."""
    tree = {}
    for root, _, files in os.walk(base):
        for fn in files:
            rows = []
            with open(os.path.join(root, fn)) as f:
                for line in f:
                    parts = [p.strip() for p in line.rstrip("\n").split(",")]
                    if fn in ("result_superstep", "result_step", "result_iteration"):
                        parts = parts[:-1]
                    elif fn == "result_pattern_set":
                        parts[3] = "0.0"
                    rows.append(", ".join(parts))
            tree[os.path.relpath(os.path.join(root, fn), base)] = rows
    return tree


def quiet(main, argv):
    """Run a CLI's main(argv); returns what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


CLI_ALGORITHMS = (
    ("bfs", ["-s", "3"]), ("cc", []), ("pagerank", []), ("kcore", ["-k", "4"]),
    ("sssp", ["-s", "3"]), ("triangles", []), ("fuzzywalk", ["--walk-labels", "3,4,3"]),
)


def run_cli_s13(golden, card="cuda"):
    """Phase 19: the port's CLIs end to end at s13 (see the module
    docstring); ``card`` is the device the CLIs are given."""
    cfg = golden["configs"]["tree_s13"]
    corpus = os.path.join(REPO, cfg["corpus"])
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        db, backup, out = (os.path.join(tmp, x) for x in ("db", "backup", "out"))
        quiet(generate_rmat.main, ["-s", "13", "--no-scramble", "-p", "4", "-o", db])
        g, stored, _ = storage.load(db)
        gg, labels, _, _ = build_config(cfg["scale"], corpus)
        for name in ("row_ptr", "cols", "rev_edge", "raw_degree"):
            if not np.array_equal(getattr(g, name), getattr(gg, name)):
                raise AssertionError(f"generate_rmat -s 13: {name} is not the golden graph's")
        if not np.array_equal(stored, labels):
            raise AssertionError("generate_rmat -s 13: stored labels are not degree labels")
        vdata = os.path.join(tmp, "vdata_")
        np.savetxt(vdata + "0", np.stack([np.arange(g.num_vertices), labels], 1), fmt="%d")
        quiet(transfer_graph.main, [db, backup])
        printed = quiet(run_pattern_matching.main, [
            "-i", db, "-b", backup, "-p", os.path.join(REPO, "examples", "patterns"),
            "-o", out, "--pattern-set", "0", "-v", vdata, "--output-vertex-data",
            "--device", card,
        ])
        tree = result_tree(out)
        vfiles = sorted(k for k in tree if "all_ranks_vertex_data" in k)
        want = result_tree(os.path.join(GOLDEN_BASE, "tree_s13"))
        if {k: v for k, v in tree.items() if k not in vfiles} != want:
            raise AssertionError("run_pattern_matching: the result tree is not tree_s13's")
        rows = sorted(r for k in vfiles for r in tree[k])
        expect = sorted(f"{v % 4}, l, {v}, {int(g.raw_degree[v])}, {int(labels[v])}"
                        for v in range(g.num_vertices))
        if len(vfiles) != golden["num_ranks"] or rows != expect:
            raise AssertionError("run_pattern_matching: vertex data rows differ")
        log(f"[19] generate_rmat -s 13 wrote the golden graph; run_pattern_matching "
            f"(-b, --pattern-set 0, -v, --output-vertex-data) on {card}: the tree_s13 "
            f"golden tree ({len(want)} files) and {len(vfiles)} vertex data files; "
            + " | ".join(ln for ln in printed.splitlines() if ln.startswith("pattern [0]: it")))
        src = np.repeat(np.arange(g.num_vertices), np.diff(g.row_ptr))
        wfile = os.path.join(tmp, "weights_0")
        np.savetxt(wfile, np.stack([src, g.cols, 1 + (src * 7 + g.cols * 3) % 5], 1), fmt="%d")
        quiet(build_edge_metadata.main, ["-i", db, wfile])
        if storage.load(db)[2] is None:
            raise AssertionError("build_edge_metadata stored no edge data")
        lines = []
        for algo, flags in CLI_ALGORITHMS:
            res = {}
            for device in (card, "cpu"):
                path = os.path.join(tmp, f"{algo}_{device}.npy")
                text = quiet(run_algorithms.main, [algo, "-i", db, "--device", device,
                                                   "-o", path] + flags)
                res[device] = ([ln for ln in text.splitlines()
                                if not ln.startswith(("time:", "wrote "))],
                               np.load(path) if os.path.exists(path) else None)
            (text, got), (text_cpu, want) = res[card], res["cpu"]
            if algo == "pagerank":
                same = np.allclose(got, want, rtol=1e-5, atol=1e-6)
            else:
                same = text == text_cpu and (got is None or np.array_equal(got, want, equal_nan=True))
            if not same:
                raise AssertionError(f"run_algorithms {algo}: {card} and cpu differ: {text} / {text_cpu}")
            lines.append(text[1])
        log(f"[19] build_edge_metadata, then run_algorithms on {card} equal to --device cpu: "
            f"{lines}; phase {time.perf_counter() - t_start:.2f} s")


class PayloadCheck:
    """Wraps the mesh engine's ``gather_accept_or_payload`` and the
    ``sends_table`` it packs with: every call also runs its twin on the
    same inputs and records the largest difference; with ``keep`` each
    gather call's inputs (revmap, masks, payload, buckets) are kept, for
    timing."""

    def __init__(self, errs, keep=False):
        self.errs, self.keep, self.calls, self.n = errs, keep, [], 0
        self.real = ops.sends_table, sharded_lcc.gather_accept_or_payload

    def __enter__(self):
        real_sends, real_gather = self.real

        def sends(payload, *budget):
            out = real_sends(payload, *budget)
            want = ops.sends_table_reference(payload, *budget)
            self.errs[SENDS] = max(self.errs[SENDS], table_err(out, want))
            return out

        def gather(revmap, masks, payload, buckets):
            out = real_gather(revmap, masks, payload, buckets)
            want = ops.gather_accept_or_payload_reference(revmap, masks, payload, buckets)
            for g, r in zip(out, want):
                self.errs[PAYLOAD] = max(self.errs[PAYLOAD], max_err(g, r))
            self.n += 1
            if self.keep:
                self.calls.append((revmap, masks, payload, buckets))
            return out

        ops.sends_table = sends  # what the gather's wrapper packs with
        sharded_lcc.gather_accept_or_payload = gather
        return self

    def __exit__(self, *exc):
        ops.sends_table, sharded_lcc.gather_accept_or_payload = self.real


def split_rows(g, n):
    """Rows whose edges span a chunk boundary of an n-shard mesh."""
    ec = max(-(-g.num_edges // n), 1)
    cuts = np.arange(1, n) * ec
    cuts = cuts[cuts < g.num_edges]
    return int(np.sum(g.edge_row[cuts - 1] == g.edge_row[cuts]))


def payload_words(rng, S, density):
    """Payload words alive << 31 | tv, uint32 [S + 1], the last the
    appended zero word; a tenth of tv is 0, so INT_MIN words (alive, no
    candidates) occur."""
    tv = rng.randint(0, 1 << 16, size=S + 1).astype(np.uint32)
    tv[rng.rand(S + 1) < 0.1] = 0
    alive = rng.rand(S + 1) < density
    payload = tv | (alive.astype(np.uint32) << np.uint32(31))
    payload[S] = 0
    return payload


def bucket_case(rng, S, density, rows, mask_kind):
    """A shard's bucket table over widths 1 and the mesh engine's WIDTHS,
    with ``rows(i)`` rows at the i-th width: (payload, buckets, revmap,
    masks); pad sentinels read the appended zero word."""
    payload = payload_words(rng, S, density)
    buckets, revmaps, masks = [], [], []
    for i, w in enumerate((1,) + tuple(sharded_lcc.WIDTHS)):
        nb = rows(i)
        adj = rng.randint(0, S + 1, size=(nb, w)).astype(np.int32)
        adj[:, -1] = S
        buckets.append((w, nb))
        revmaps.append(adj.reshape(-1))
        masks.append({"random": rng.randint(0, 1 << 16, size=nb), "zero": np.zeros(nb),
                      "one": np.full(nb, 0xFFFF)}[mask_kind].astype(np.int32))
    return payload, buckets, np.concatenate(revmaps), np.concatenate(masks)


def compare_payload_small(dev, golden, errs):
    """Phase 20: the mesh superstep's kernels against their twins on seeded
    inputs, and on every call of a tree_s13 full-plane search on 4 shards."""
    sizes = ((1, ops.SUMMARY_BUDGET_BYTES), (33, ops.SUMMARY_BUDGET_BYTES),
             (1000, ops.SUMMARY_BUDGET_BYTES), (5000, 16), (70001, 64),
             ((1 << 22) + 5, ops.SUMMARY_BUDGET_BYTES))
    densities = (0.0,) + DENSITIES
    for density in densities:
        for n, budget in sizes:
            rng = np.random.RandomState(n + budget)
            words = payload_words(rng, n - 1, density) if n > 1 else np.zeros(1, np.uint32)
            table = torch.from_numpy(words.view(np.int32)).to(dev)
            got = ops.sends_table(table, budget)
            torch.cuda.synchronize()
            errs[SENDS] = max(errs[SENDS], table_err(got, ops.sends_table_reference(table, budget)))
        for k in range(4):  # each width gets 0, 1, 33 and 1000 rows over k
            for mask_kind in ("random", "zero", "one"):
                rng = np.random.RandomState(31 * k + len(mask_kind))
                payload, buckets, revmap, masks = bucket_case(
                    rng, 60000, density, lambda i: (0, 1, 33, 1000)[(i + k) % 4], mask_kind
                )
                table = torch.from_numpy(payload.view(np.int32)).to(dev)
                sends = ops.sends_table(table)
                m_d = torch.from_numpy(masks).to(dev)
                buf = torch.from_numpy(np.concatenate([[0], revmap]).astype(np.int32)).to(dev)
                # 16-byte aligned and packing in the call, then not aligned
                # and through the table packed above
                for r_d, st in ((buf[1:].clone(), None), (buf[1:], sends)):
                    got = ops.gather_accept_or_payload(r_d, m_d, table, buckets, sends=st)
                    torch.cuda.synchronize()
                    want = ops.gather_accept_or_payload_reference(r_d, m_d, table, buckets)
                    for g, r in zip(got, want):
                        errs[PAYLOAD] = max(errs[PAYLOAD], max_err(g, r))
    check_errs(errs, "at small shapes")
    cfg = golden["configs"]["tree_s13"]
    g, labels, pattern, constraints = build_config(cfg["scale"], os.path.join(REPO, cfg["corpus"]))
    n_split = split_rows(g, MESH_SHARDS)
    if n_split == 0:
        raise AssertionError("tree_s13 on 4 shards: no row spans a chunk boundary")
    with PayloadCheck(errs) as chk:
        r = MatchEngine(
            g, labels, pattern, constraints, num_ranks=golden["num_ranks"],
            lcc_engine="sharded", mesh=build_mesh(shards=MESH_SHARDS, device=dev),
            compact=False,
        ).run()
    check_anchors(r, {k: cfg[k] for k in ("active_vertices", "active_edges", "subgraphs")},
                  "tree_s13 on 4 shards")
    check_errs(errs, "in the tree_s13 mesh search")
    log(f"[20] pack_sends equals its twin (tables of {[n for n, _ in sizes]} words, G 32 "
        f"and 64, INT_MIN and zero pad words, alive densities {densities}) and "
        f"gather_accept_or_payload its twin (one call over buckets of widths 1 and "
        f"{sharded_lcc.WIDTHS[0]}..{sharded_lcc.WIDTHS[-1]} with 0/1/33/1000 rows, "
        f"random/zero/full masks, index planes aligned and not); and all {chk.n} gather "
        f"calls of a tree_s13 full-plane search on {MESH_SHARDS} shards, {n_split} rows "
        f"split across shards: max_abs_err {errs[SENDS]} / {errs[PAYLOAD]}")


def mesh_dryrun(golden, dev):
    """Phase 21: the JAX package's dryrun_multichip contract on meshes of
    1, 2 and 4 shards of the card."""
    for n in (1, 2, 4):
        for name in ("tree_s13", "cycle_s13"):
            cfg = golden["configs"][name]
            g, labels, pattern, constraints = build_config(
                cfg["scale"], os.path.join(REPO, cfg["corpus"])
            )
            t0 = time.perf_counter()
            engine = MatchEngine(
                g, labels, pattern, constraints, lcc_engine="sharded",
                mesh=build_mesh(shards=n, device=dev), nlcc_mode="device",
                num_ranks=max(n, 1), compact=False,
            )
            nf.reset_launches()
            r = engine.run()
            torch.cuda.synchronize()
            want = {k: cfg[k] for k in ("active_vertices", "active_edges", "subgraphs")}
            check_anchors(r, want, f"{name} on {n} shards")
            n_tp = sum(1 for x in r.rows if x.phase == "TP")
            if (engine.nlcc_fallbacks or n_tp == 0 or r.rows[0].active_vertices == 0
                    or any(x.per_rank is None for x in r.rows)
                    or (name == "cycle_s13" and r.iterations != 2)
                    or nf.launches["expand_frontier"] == 0):
                raise AssertionError(
                    f"{name} on {n} shards: fallbacks {engine.nlcc_fallbacks}, {n_tp} TP "
                    f"rows, iterations {r.iterations}, walk launches {dict(nf.launches)}"
                )
            log(f"[21] {name} on {n} shards of {dev}: anchors OK {want}, {r.iterations} "
                f"iterations, {sum(1 for x in r.rows if x.phase == 'LP')} LP supersteps, "
                f"{n_tp} TP runs on the mesh, nlcc_fallbacks 0, per_rank on every row, "
                f"{time.perf_counter() - t0:.3f} s")


def payload_bound_ms(calls):
    """Least time of the mesh superstep's payload gather as a function of
    its index planes, row masks and payload tables, packs included: each
    input read once (the index planes, the row masks, and each distinct
    payload word they reach), each output written once (accept, tn,
    sendok)."""
    nbytes = 0
    for revmap, masks, _, _ in calls:
        nbytes += 5 * revmap.numel() + 12 * masks.numel() + 4 * int(torch.unique(revmap).numel())
    return nbytes / HBM_BYTES_PER_MS, nbytes


def gather_bound_ms(calls, tables):
    """Least time of the gather kernels alone, given the packed sends
    tables: the index planes read and accept written (5 bytes a slot), the
    row masks read and tn and sendok written (12 bytes a row), the summary
    read, the distinct sends words that slots in a set summary group reach,
    and the distinct payload words that send."""
    nbytes = 0
    for (revmap, masks, payload, _), tab in zip(calls, tables):
        idx = revmap.long()
        grp = idx >> tab.group_log2
        gated = idx[((tab.summary[grp >> 5] >> (grp & 31)) & 1) != 0]
        word = payload[gated]
        sending = gated[(word < 0) & (word != ops.INT32_MIN)]
        nbytes += (5 * revmap.numel() + 12 * masks.numel() + 4 * tab.summary.numel()
                   + 4 * int(torch.unique(gated >> 5).numel())
                   + 4 * int(torch.unique(sending).numel()))
    return nbytes / HBM_BYTES_PER_MS, nbytes


def sends_share(calls):
    """(payload words, of them sending, slots, of them reading a sending
    word) over one superstep's gather calls."""
    words = sending = slots = reads = 0
    for revmap, _, payload, _ in calls:
        sends = (payload < 0) & (payload != ops.INT32_MIN)
        words += payload.numel()
        sending += int(sends.sum())
        slots += revmap.numel()
        reads += int(sends[revmap.long()].sum())
    return words, sending, slots, reads


def sends_bound_ms(calls):
    """Least time of the packs: each payload word read once, the sends
    words and the summary written once."""
    nbytes = 0
    for _, _, payload, _ in calls:
        n = payload.numel()
        g = ops.summary_group_log2(n)
        nbytes += 4 * n + 4 * -(-n // 32) + 4 * ops._summary_words(n, g)
    return nbytes / HBM_BYTES_PER_MS, nbytes


def time_mesh_gather(calls):
    """Phase 22's kernel timings on one full-plane mesh superstep's calls
    (one per shard), by CUDA-graph replay: the pair (every pack and gather),
    each part alone, the twins, and the pair with every word alive and with
    every word sending."""
    sends = [ops.sends_table(t) for _, _, t, _ in calls]
    # every word alive (words with tv 0 still send nothing), and every word
    # sending (bit 0 set too), where the gate can skip nothing
    alive = [(r, m, t | ops.INT32_MIN, b) for r, m, t, b in calls]
    every = [(r, m, t | (ops.INT32_MIN | 1), b) for r, m, t, b in calls]

    def pair(cs):
        return lambda: [ops.gather_accept_or_payload(r, m, t, b) for r, m, t, b in cs]

    out = {"sends": sends}
    out["pair"], out["twin"], out["raw"] = time_pair(pair(calls), lambda: [
        ops.gather_accept_or_payload_reference(r, m, t, b) for r, m, t, b in calls])
    out["pack"], out["pack_twin"], _ = time_pair(
        lambda: [ops.sends_table(t) for _, _, t, _ in calls],
        lambda: [ops.sends_table_reference(t) for _, _, t, _ in calls])
    out["gather"] = time_cuda(lambda: [ops.gather_accept_or_payload(r, m, t, b, sends=st)
                                       for (r, m, t, b), st in zip(calls, sends)])
    out["pair_alive"] = time_cuda(pair(alive))
    out["pair_every"] = time_cuda(pair(every))
    out["sends_alive"] = sends_share(alive)[1]
    return out


def run_s21_mesh(g, labels, pattern, constraints, dev, errs):
    """Phase 22: the s21 tree search on a 4-shard mesh. Returns the mesh
    kernels' (ms, plain ms, bound ms, library ms), their launches per
    full-plane search, and phase 24's reference (the one-process mesh's
    lcc_call rows, final shards and times)."""
    mesh = build_mesh(shards=MESH_SHARDS, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = MatchEngine(g, labels, pattern, constraints, lcc_engine="sharded", mesh=mesh)
    torch.cuda.synchronize()
    lcc = engine.lcc
    log(f"[22] s21 mesh engine build ({MESH_SHARDS} shards of {dev}): "
        f"{time.perf_counter() - t0:.3f} s; {lcc.S} ELL slots per shard in "
        f"{len(lcc.ell_buckets)} buckets, block {lcc.block}, halo sizes H {lcc.halo_h} "
        f"Hrev {lcc.halo_hrev} K {lcc.halo_k}, per_device_elems {lcc.per_device_elems()}, "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    launches = {}
    for compact, timed in ((True, 3), (False, 1)):
        # the same engine on the full plane is what compact=False sets
        engine._compact_engine = compact
        what = "compact" if compact else "full plane"
        reset_launches()
        with PayloadCheck(errs) as chk:
            r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 mesh {what} warm")
        launches[what] = superstep_launches()
        log(f"[22] {what} warm search: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s), "
            f"iterations={r.iterations}, {summary(r)}, kernel launches {launches[what]} "
            f"({chk.n} payload calls checked against the twin), walk kernel launches "
            f"{dict(nf.launches)}")
        for i in range(timed):
            r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 mesh {what} run {i}")
            log(f"[22] {what} timed search {i}: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s, "
                f"other {dt - lp - tp:.4f} s), {r.traversed_edges / dt / 1e6:.2f} M "
                f"traversed edges/s, LP rows {len(lp_rows(r))}, host loadavg {os.getloadavg()}")
    check_errs(errs, "in the s21 mesh searches")
    # compact: the mesh runs the init superstep, the sub-engine the rest
    need = {"compact": ("pack_alive", "rev_alive_lookup", "continuation_superstep"),
            "full plane": MESH_KERNELS}
    for what, names in need.items():
        for k in names:
            if launches[what][k] == 0:
                raise AssertionError(f"{k}: no launch during the s21 mesh {what} search")
    log(f"[22] anchors OK on every run {S21_ANCHORS}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # one full-plane superstep at the post-init state: every call of the
    # mesh kernels, checked against the twins and kept for timing
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    with PayloadCheck(errs, keep=True) as chk:
        lcc._superstep(st.tv, st.alive, st.tp_flag, init=False)
        torch.cuda.synchronize()
    check_errs(errs, "at s21 (one mesh superstep)")
    calls = chk.calls
    bound, nbytes = payload_bound_ms(calls)
    pack_bound, pack_bytes = sends_bound_ms(calls)
    t = time_mesh_gather(calls)
    gather_bound, gather_bytes = gather_bound_ms(calls, t["sends"])
    step_ms = time_cuda(lambda: lcc._superstep(st.tv, st.alive, st.tp_flag, init=False),
                        reps=3, graph=False)
    slots = sum(r.numel() for r, _, _, _ in calls)
    sent = sum(int((p[r.long()] < 0).sum()) for r, _, p, _ in calls)
    words, sending, _, reads = sends_share(calls)
    groups = []
    for (_, _, p, _), tab in zip(calls, t["sends"]):
        bits = torch.stack([(tab.summary >> k) & 1 for k in range(32)], dim=1).reshape(-1)
        groups.append((int(bits.sum()), -(-p.numel() >> tab.group_log2), 1 << tab.group_log2))
    n_calls = len(calls)
    log(f"[22] mesh superstep gather at the post-init state ({n_calls} shards x "
        f"{len(lcc.ell_buckets)} buckets, {slots} slots, {sent} reading an alive word and "
        f"{reads} a sending one; payload tables {words} words, {sending} of them sending "
        f"({100 * sending / words:.3f} %); summary groups set / all (G) per shard {groups}): "
        f"the pair ({n_calls} pack_sends + {n_calls} gather_accept_or_payload) "
        f"{t['raw'][0]:.4f}/{t['raw'][1]:.4f} ms against the bound of the whole function "
        f"{bound:.4f} ms ({nbytes} B, bytes): {100 * bound / t['pair']:.1f} % of bound; pack "
        f"alone {t['pack']:.4f} ms (its bound {pack_bound:.4f} ms, {pack_bytes} B, "
        f"{100 * pack_bound / t['pack']:.1f} %; twin {t['pack_twin']:.4f} ms), gather alone "
        f"{t['gather']:.4f} ms (its bound {gather_bound:.4f} ms, {gather_bytes} B, "
        f"{100 * gather_bound / t['gather']:.1f} %); twin {t['raw'][2]:.4f}/{t['raw'][3]:.4f} "
        f"ms; library call: none")
    log(f"[22] with every payload word alive ({t['sends_alive']} of them sending): the pair "
        f"{t['pair_alive']:.4f} ms; with every word sending: the pair {t['pair_every']:.4f} ms")
    log(f"[22] the whole mesh superstep (eager, host dispatch included) {step_ms:.3f} ms")
    log(f"[22] s21 tree, full-plane lcc_call on the mesh: the payload words that send and "
        f"the slots that read one, % per non-init superstep: {sends_by_superstep(lcc, errs)}")
    times = {SENDS: (t["pack"], t["pack_twin"], pack_bound, None),
             PAYLOAD: (t["gather"], t["twin"], gather_bound, None)}
    del calls, chk, st

    # what phase 24's processes run, on this one-process mesh
    rows, died, st, ms, _ = time_lcc_calls(lcc)
    ref = {"rows": mesh_rows(rows), "died": died, "blocks": lcc.local_blocks(st), "ms": ms,
           "exchange_ms": time_exchanges(lcc)}
    log(f"[22] lcc_call from the init state on the one-process mesh ({len(rows)} "
        f"supersteps, the reference of phase 24): timed {[round(t, 3) for t in ms]} ms, "
        f"{min(ms) / len(rows):.3f} ms a superstep; a non-init superstep's exchanges "
        f"alone {ref['exchange_ms']:.3f} ms; rows {[r[:3] for r in rows]}")
    return times, {k: launches["full plane"][k] for k in MESH_KERNELS}, ref


def sends_by_superstep(lcc, errs):
    """One full-plane lcc_call from the init state, each payload-gather
    call checked against the twins: per superstep that gathers, the share
    (%) of the payload words that send and of the slots that read one."""
    with PayloadCheck(errs, keep=True) as chk:
        lcc.lcc_call(lcc.init_state(), True)
        torch.cuda.synchronize()
    check_errs(errs, "in a full-plane mesh lcc_call")
    n = lcc.mesh.local
    out = []
    for i in range(0, len(chk.calls), n):
        words, sending, slots, reads = sends_share(chk.calls[i : i + n])
        out.append((round(100 * sending / words, 4), round(100 * reads / slots, 4)))
    return out


def run_s21_mesh_cycle(g, labels, dev, errs):
    """Phase 23: the s21 cycle search on the 4-shard mesh with the mesh
    NLCC, one run; and the sending share of its full-plane supersteps."""
    pattern = load_pattern_graph(CYCLE_CORPUS)
    constraints = load_nonlocal_constraints(CYCLE_CORPUS, pattern.vertex_data)
    t0 = time.perf_counter()
    engine = MatchEngine(
        g, labels, pattern, constraints, lcc_engine="sharded",
        mesh=build_mesh(shards=MESH_SHARDS, device=dev), nlcc_mode="device",
    )
    torch.cuda.synchronize()
    log(f"[23] s21 cycle mesh engine build: {time.perf_counter() - t0:.3f} s")
    reset_launches()
    r, dt, lp, tp = timed_search(engine, S21_CYCLE_ANCHORS, "s21 cycle on the mesh")
    walk = dict(nf.launches)
    if engine.nlcc_fallbacks or any(walk[k] == 0 for k in WALK_KERNELS):
        raise AssertionError(f"s21 cycle on the mesh: fallbacks {engine.nlcc_fallbacks}, "
                             f"walk kernel launches {walk}")
    log(f"[23] s21 cycle search on {MESH_SHARDS} shards: {dt:.4f} s (LP {lp:.4f} s, "
        f"TP {tp:.4f} s, other {dt - lp - tp:.4f} s), iterations={r.iterations}, "
        f"{summary(r)}, anchors OK {S21_CYCLE_ANCHORS}, nlcc_fallbacks 0; kernel launches "
        f"{superstep_launches()}, walk kernel launches {walk}; TP rows (iteration, "
        f"constraint, seconds, messages) {tp_rows(r)}")
    log(f"[23] s21 cycle, full-plane lcc_call on the mesh: the payload words that send "
        f"and the slots that read one, % per non-init superstep: "
        f"{sends_by_superstep(engine.lcc, errs)}")


def time_lcc_calls(lcc, calls=3):
    """``calls`` runs of ``lcc_call`` from the init state (the global init
    superstep through the diameter), the first warm: (rows, died, final
    state, ms of each timed call, bytes sent across processes per call)."""
    ms, cross = [], []
    for i in range(calls):
        b0 = lcc.mesh.cross_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, rows, died = lcc.lcc_call(lcc.init_state(), True)
        torch.cuda.synchronize()
        if i:
            ms.append(1000 * (time.perf_counter() - t0))
        cross.append(lcc.mesh.cross_bytes - b0)
    return rows, died, st, ms, cross


def time_exchanges(lcc, reps=3):
    """ms of one non-init default-mode superstep's exchanges alone, on
    buffers of its shapes (the best of ``reps``): the row-tv and payload
    halos, the partials to the owners and the new tv back (int32
    all_to_all), the counters (psum) and the died flag (pmax)."""
    mesh, n, dev = lcc.mesh, lcc.n, lcc.mesh.devices[0]

    def bufs(*shape, dtype=torch.int32):
        return [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(mesh.local)]

    sends = [bufs(n, lcc.halo_h), bufs(n, lcc.halo_hrev), bufs(n, lcc.halo_k, 1),
             bufs(n, lcc.halo_k)]
    counters = bufs(3 * lcc.num_ranks, dtype=torch.int64)
    died = bufs(1, dtype=torch.int64)

    def step():
        for x in sends:
            mesh.all_to_all(x)
        mesh.psum(counters)
        mesh.pmax(died)

    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i:
            times.append(1000 * (time.perf_counter() - t0))
    return min(times)


def mesh_rows(rows):
    return [(av, ae, msg, {k: v.tolist() for k, v in per.items()}) for av, ae, msg, per in rows]


def mesh_child(argv) -> int:
    """Phases 24-25 in one of the launcher's processes: the graph from the
    directory's files, this process's shards of the mesh, the mesh LCC
    engine on the tree corpus, three lcc_calls; the result to the
    directory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-child", required=True, help="directory of the graph files")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke --mesh-child: no CUDA device")
    d = args.mesh_child
    backend = init_distributed(args, "cuda")  # utils/dist.placement's rule
    tag = "[24]" if backend == "gloo" else "[25]"
    try:
        arr = {k: np.load(os.path.join(d, f"{k}.npy")) for k in GRAPH_FILES + ("labels",)}
        g = Graph(len(arr["row_ptr"]) - 1, *(arr[k] for k in GRAPH_FILES))
        with tempfile.TemporaryDirectory() as tmp:
            pattern, _ = load_tree_pattern(tmp)
        mesh = build_mesh(shards=MESH_SHARDS // MESH_PROCESSES, device="cuda")
        pid = mesh.process_index
        t0 = time.perf_counter()
        lcc = ShardedLccEngine(g, arr["labels"], pattern, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ops.reset_launches()
        rows, died, st, ms, cross = time_lcc_calls(lcc)
        launches = {k: ops.launches[k] for k in MESH_KERNELS}
        exchange_ms = time_exchanges(lcc)
        log(f"{tag} process {pid}: {mesh}, engine build {build_s:.3f} s; lcc_call "
            f"({len(rows)} supersteps) timed {[round(t, 3) for t in ms]} ms, "
            f"{min(ms) / len(rows):.3f} ms a superstep; a non-init superstep's exchanges "
            f"alone {exchange_ms:.3f} ms; bytes sent to the other process per call "
            f"{cross} ({cross[-1] / len(rows):.0f} a superstep); mesh kernel "
            f"launches {launches}")
        res = {"backend": backend, "card": torch.cuda.current_device(),
               "rows": mesh_rows(rows), "died": died, "ms": ms, "cross": cross,
               "launches": launches, "blocks": lcc.local_blocks(st), "build_s": build_s,
               "exchange_ms": exchange_ms}
        with open(os.path.join(d, f"result_{pid}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_mesh_processes(g, labels, ref, cards, backend, tag):
    """Phase 24 (``cards`` = 1, gloo) or 25 (2 cards, NCCL): the launcher
    runs ``mesh_child`` in ``MESH_PROCESSES`` processes that see the first
    ``cards`` cards, and each picks its backend and card by the port's rule
    (``utils/dist.placement``), which must give ``backend``; their rows and
    shards against ``ref``, the one-process mesh's."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = visible.split(",") if visible else [str(i) for i in range(torch.cuda.device_count())]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(ids[:cards]))
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for k in GRAPH_FILES:
            np.save(os.path.join(d, k), getattr(g, k))
        np.save(os.path.join(d, "labels"), labels)
        hand_s = time.perf_counter() - t0
        cmd = [sys.executable, "-m", "fuzzypatternmatching_tpu_torch.cli.launch_multiprocess",
               "-n", str(MESH_PROCESSES), "--", sys.executable, os.path.abspath(__file__),
               "--mesh-child", d]
        t0 = time.perf_counter()
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=REPO, env=env, start_new_session=True)
        try:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, _ = p.communicate()
            raise AssertionError(f"{tag}: the processes ran past {CHILD_TIMEOUT} s:\n{out}")
        run_s = time.perf_counter() - t0
        print(out, end="", flush=True)
        if p.returncode != 0:
            raise AssertionError(f"{tag}: the launcher exited with {p.returncode}")
        results = []
        for pid in range(MESH_PROCESSES):
            with open(os.path.join(d, f"result_{pid}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by mesh_child
    seen = []
    for pid, res in enumerate(results):
        if res["backend"] != backend:
            raise AssertionError(f"{tag} process {pid}: backend {res['backend']} on "
                                 f"{cards} card(s), want {backend}")
        if res["rows"] != ref["rows"] or res["died"] != ref["died"]:
            raise AssertionError(f"{tag} process {pid}: rows {[r[:3] for r in res['rows']]} "
                                 f"!= the one-process mesh's {[r[:3] for r in ref['rows']]}")
        for r, (tv, alive) in res["blocks"].items():
            tv_w, alive_w = ref["blocks"][r]
            if tv.tobytes() != tv_w.tobytes() or alive.tobytes() != alive_w.tobytes():
                raise AssertionError(f"{tag} process {pid}: shard {r}'s final tv or alive "
                                     "differs from the one-process mesh's")
            seen.append(r)
        if min(res["launches"].values()) < 1:
            raise AssertionError(f"{tag} process {pid}: mesh kernel launches {res['launches']}")
    if sorted(seen) != list(range(MESH_SHARDS)):
        raise AssertionError(f"{tag}: the processes held shards {sorted(seen)}")
    steps = len(ref["rows"])
    per_step = [min(res["ms"]) / steps for res in results]
    how = (" (gloo takes the CUDA tensors in every collective and copies them through "
           "host memory itself)" if backend == "gloo" else "")
    log(f"{tag} {MESH_PROCESSES} processes x {MESH_SHARDS // MESH_PROCESSES} shards over "
        f"{backend} on cards {[res['card'] for res in results]}{how}: "
        f"rows equal the one-process mesh's, and every shard's final tv and alive slots byte "
        f"for byte; mesh kernel launches per process {[res['launches'] for res in results]}; "
        f"ms a superstep per process {[round(x, 3) for x in per_step]} against "
        f"{min(ref['ms']) / steps:.3f} on the one-process mesh; a non-init superstep's "
        f"exchanges alone {[round(res['exchange_ms'], 3) for res in results]} ms against "
        f"{ref['exchange_ms']:.3f}; bytes sent across the process boundary a superstep per "
        f"process {[round(res['cross'][-1] / steps) for res in results]}; "
        f"graph hand-off {hand_s:.2f} s, launch to exit {run_s:.2f} s (engine builds "
        f"{[round(res['build_s'], 2) for res in results]} s)")


# -- phase 27: the fused supersteps K1 and K2 ---------------------------------

FUSED_WIDTHS = tuple(8 << i for i in range(11))  # the engine's widths, 8 .. 8192


def fused_case(seed, buckets, dev, ranks=1, code8=True, k=5, density=0.6, V=20000,
               required=None, cycle_classes=False):
    """Seeded inputs of both fused supersteps: ``SuperstepPlanes`` over
    ``buckets`` ((rows, width, split) in slot order; a split bucket's rows
    fall in runs of 1-4 rows a segment, the engine's split hubs), a random
    template of k vertices, and a state: the label tv and tv (bits below
    k, 30 % zero), alive and tp_flag (pad slot dead) and alive_rev, set
    with probability ``density``; a fifth of the slots are padding (adj V,
    label code 0). With ``required`` ([k, L]) the counting rule: each
    slot's sender class drawn from 0..L, or with ``cycle_classes`` class
    1 + (slot mod L) (every class in every long row, none more than
    ceil(width / L) times a row); padding class 0."""
    rng = np.random.RandomState(seed)
    n_codes = 200 if code8 else 1000
    verts = rng.permutation(V)  # every segment its own vertex
    widths, rows, seg_id, seg_rows, adj, code = [], [], [], [], [], []
    used = 0
    for n, w, split in buckets:
        runs = []
        while sum(runs) < n:
            runs.append(min(n - sum(runs), rng.randint(1, 5) if split else 1))
        sid = np.repeat(np.arange(len(runs)), runs).astype(np.int64)
        sv = verts[used : used + len(runs)]
        used += len(runs)
        a = rng.randint(0, V, size=(n, w)).astype(np.int32)
        c = rng.randint(1, n_codes, size=(n, w))
        pad = rng.rand(n, w) < 0.2
        a[pad], c[pad] = V, 0
        widths.append(w)
        rows.append(sv[sid])
        seg_id.append(sid)
        seg_rows.append(sv)
        adj.append(a)
        code.append(c.astype(np.uint8 if code8 else np.int32))
    code_tv = rng.randint(0, 1 << k, size=n_codes)
    code_tv[rng.rand(n_codes) < 0.3] = 0
    code_tv[0] = 0
    cls = None
    if required is not None:
        n_cls = np.asarray(required).shape[1]
        crng = np.random.RandomState(seed + 7919)
        cls = [np.where(a == V, 0, 1 + np.arange(a.size).reshape(a.shape) % n_cls
                        if cycle_classes else crng.randint(0, n_cls + 1, size=a.shape))
               .astype(np.uint8) for a in adj]
    planes = lf.build_planes(widths, rows, seg_id, seg_rows, adj, code, code_tv, V, ranks, dev,
                             cls=cls)
    adj_all = rng.randint(1, 1 << k, size=k)
    mand = np.where(rng.rand(k) < 0.5, adj_all & (1 << rng.randint(0, k, size=k)), 0)
    opt = adj_all & ~mand & rng.randint(0, 1 << k, size=k)
    opt_min = np.where(opt != 0, rng.randint(0, 3, size=k), 0)
    tmpl = lf.Template(*(tuple(int(x) for x in t) for t in (adj_all, mand, opt, opt_min)),
                       None if required is None else tuple(map(tuple, np.asarray(required).tolist())))

    def tv_of():
        t = rng.randint(0, 1 << k, size=V).astype(np.int32)
        t[rng.rand(V) < 0.3] = 0
        return torch.from_numpy(t).to(dev)

    def flags(size, dead_pad=True):
        f = rng.rand(size) < density
        if dead_pad:
            f[-1] = False
        return torch.from_numpy(f).to(dev)

    S = planes.num_slots
    state = (tv_of(), tv_of(), flags(S + 1), flags(S + 1), flags(S, dead_pad=False))
    return planes, tmpl, state


def fused_errs(planes, tmpl, state, errs):
    """Both fused supersteps against their twins on one case's inputs."""
    label_tv, tv, alive, flag, alive_rev = state
    pairs = {
        "init_superstep": (
            lf.init_superstep(planes, label_tv, tmpl),
            lf.init_superstep_reference(planes, label_tv, tmpl),
        ),
        "continuation_superstep": (
            lf.continuation_superstep(planes, tv, alive, flag, alive_rev, tmpl),
            lf.continuation_superstep_reference(planes, tv, alive, flag, alive_rev, tmpl),
        ),
    }
    torch.cuda.synchronize()
    for name, (got, want) in pairs.items():
        errs[name] = max(errs[name], max(max_err(g, r) for g, r in zip(got, want)))


def required_table(seed, k, n_cls, pairs, top):
    """A seeded [k, n_cls] requirement table with ``pairs`` entries in 1..top
    (at least one of them top) and zeros elsewhere."""
    rng = np.random.RandomState(seed)
    req = np.zeros(k * n_cls, dtype=np.int64)
    at = rng.choice(k * n_cls, size=pairs, replace=False)
    req[at] = rng.randint(1, top + 1, size=pairs)
    if pairs:
        req[at[0]] = top
    return req.reshape(k, n_cls)


# the counting cases: (k, classes, requirement pairs, largest requirement)
COUNTING_TABLES = ((7, 4, 11, 2), (16, 16, 40, 3), (3, 2, 6, 1), (16, 16, 256, 15), (1, 1, 0, 0))


def compare_counting_small(dev, errs):
    """Phase 27, small counting cases: the counting instantiations against
    the twin, exactly: requirement tables of 0 to 256 pairs (1 to 16 register
    groups) with counts up to 15 on every engine width (the widest split),
    1, 4 and 2,000 ranks, uint8 and int32 codes; then every class present
    in every row and every requirement 15, none met, on short rows and on
    split hubs in a width-16 bucket."""
    n_cases = 0
    for seed, (k, n_cls, pairs, top) in enumerate(COUNTING_TABLES):
        req = required_table(seed, k, n_cls, pairs, top)
        rng = np.random.RandomState(300 + seed)
        for ranks in (1, 4, 2000):
            for code8 in (True, False):
                n_rows = rng.choice([0, 1, 33, 257], size=len(FUSED_WIDTHS))
                buckets = [(int(n), w, w == FUSED_WIDTHS[-1]) for n, w in zip(n_rows, FUSED_WIDTHS)]
                fused_errs(*fused_case(500 + 10 * seed + ranks, buckets, dev, ranks, code8, k=k,
                                       density=DENSITIES[seed % 3], required=req), errs)
                n_cases += 1
    unmet = np.full((16, 16), 15, dtype=np.int64)
    for ranks in (1, 4):
        fused_errs(*fused_case(900 + ranks, [(40, 8, False), (30, 16, False), (60, 16, True)],
                               dev, ranks, k=16, density=1.0, required=unmet,
                               cycle_classes=True), errs)
        n_cases += 1
    check_errs({k: errs[k] for k in FUSED_KERNELS}, "under the counting rule at small shapes")
    log(f"[27] counting supersteps equal their twins on {n_cases} small cases (tables "
        f"(k, classes, pairs, largest) {COUNTING_TABLES}, every width, split hubs, ranks "
        f"1/4/2000, uint8 and int32 codes, every requirement unmet): "
        f"{ {k: errs[k] for k in FUSED_KERNELS} }")


def compare_fused_small(dev, errs):
    """Phase 27, small cases: both fused supersteps against their twins,
    exactly: every engine width 8..8192 (the widest a split bucket) with
    0, 1, 33 or 257 rows, 1, 4 and 2,000 output ranks (the last past the
    kernel's shared-memory partials), uint8 and int32 label codes,
    templates of 1 to 16 vertices, flags set at 0.5 %, 60 % and 100 %;
    then widths 1-4 and slot bases off 8 (one-slot lanes), split hubs in a
    width-16 bucket (the tests' max_width=16), buckets with no rows, and
    no buckets."""
    n_cases = 0
    for seed in range(4):
        rng = np.random.RandomState(seed)
        for ranks in (1, 4, 2000):
            for code8 in (True, False):
                n_rows = rng.choice([0, 1, 33, 257], size=len(FUSED_WIDTHS))
                buckets = [(int(n), w, w == FUSED_WIDTHS[-1]) for n, w in zip(n_rows, FUSED_WIDTHS)]
                fused_errs(*fused_case(100 * seed + ranks, buckets, dev, ranks, code8,
                                       k=(5, 16, 1, 7)[seed], density=DENSITIES[seed % 3]), errs)
                n_cases += 1
    odd = (
        [(3, 1, False), (5, 2, False), (7, 4, False), (9, 8, False), (11, 16, False),
         (13, 64, False), (5, 512, False), (6, 8192, True)],
        [(50, 8, False), (120, 16, True)],
        [(0, 8, False), (0, 64, False), (0, 8192, True)],
        [],
    )
    for i, buckets in enumerate(odd):
        for ranks in (1, 4):
            fused_errs(*fused_case(1000 + 10 * i + ranks, buckets, dev, ranks), errs)
            n_cases += 1
    check_errs({k: errs[k] for k in FUSED_KERNELS}, "at small shapes")
    log(f"[27] fused supersteps equal their twins on {n_cases} small cases (widths 1..8192, "
        f"split hubs, ranks 1/4/2000, uint8 and int32 codes, empty buckets): "
        f"{ {k: errs[k] for k in FUSED_KERNELS} }")
    compare_counting_small(dev, errs)


class FusedCheck:
    """Wraps the engine's fused supersteps (``engine/lcc_bucketed.py``):
    every launch also runs its twin on the same inputs (the twin launches
    no kernel) and records the largest difference."""

    def __init__(self, errs):
        self.errs, self.n = errs, dict.fromkeys(FUSED_KERNELS, 0)
        self.real = {k: getattr(lcc_bucketed, k) for k in FUSED_KERNELS}
        self.twins = {"init_superstep": lf.init_superstep_reference,
                      "continuation_superstep": lf.continuation_superstep_reference}

    def __enter__(self):
        for name in FUSED_KERNELS:
            setattr(lcc_bucketed, name, self._checked(name))
        return self

    def _checked(self, name):
        def call(*args):
            got = self.real[name](*args)
            want = self.twins[name](*args)
            torch.cuda.synchronize()
            self.errs[name] = max(self.errs[name], max(max_err(g, w) for g, w in zip(got, want)))
            self.n[name] += 1
            return got
        return call

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(lcc_bucketed, name, fn)


def fused_bound_ms(lcc, alive_rev):
    """Least time of each fused superstep on these inputs: the bytes it must
    move over the HBM rate. Both read each segment's vertex (8 B), its tv
    (4 B), the split hubs' row starts, the ranks' planes where there are
    several, and write new_tv (4 B a vertex), new_alive and the cleared
    tp_flag (S + 1 B each) and the stats. K1 also reads the label codes
    and their table; K2 reads alive_rev, alive and tp_flag (a byte a slot
    each) and, only where alive_rev is set, the neighbour id (4 B) and the
    tv entries of the distinct neighbours (4 B each). Under the counting
    rule K1 also reads each slot's class byte, K2 the class bytes where
    alive_rev is set."""
    pl = lcc._planes
    s, v, r = pl.num_slots, pl.num_vertices, pl.num_ranks
    n_seg = pl.seg_rows.numel()
    common = (12 * n_seg + 8 * pl.seg_start.numel() + (8 * n_seg if r > 1 else 0)
              + 4 * v + 2 * (s + 1) + 8 * (3 * r + 1))
    k1 = common + s * pl.code.element_size() + 4 * pl.code_tv.numel()
    n_rev = int(alive_rev.sum())
    distinct = int(torch.unique(pl.adj[alive_rev]).numel())
    k2 = common + s + 2 * (s + 1) + 4 * n_rev + 4 * distinct
    if pl.cls is not None:
        k1, k2 = k1 + s, k2 + n_rev
    return {"init_superstep": k1, "continuation_superstep": k2}


def fused_at_s21(engine, errs):
    """Phase 27 at s21, on phases 5-6's engine: one s21 tree search each
    with the compact path and with compact=False in which every fused
    superstep is held against its twin on the same inputs, anchors
    asserted; then both kernels at the
    post-init state of the full graph (K2 over every slot), timed by
    CUDA-graph replay in turns (twin, kernel, kernel, twin) beside the
    twin (the plain per-bucket superstep), each also eagerly (host dispatch
    included), and their bytes bounds. Phase 17 times the engine's whole
    continuation superstep (pack_alive, rev_alive_lookup, K2)."""
    for compact, what in ((True, "compact"), (False, "compact=False")):
        with FusedCheck(errs) as chk:
            r = compact_mode(engine, compact).run()
        check_anchors(r, S21_ANCHORS, f"[27] s21 {what} checked search")
        log(f"[27] s21 tree {what}: every fused superstep equals its twin "
            f"({chk.n} checked, {len(lp_rows(r))} supersteps), anchors OK")
    check_errs({k: errs[k] for k in FUSED_KERNELS}, "on the s21 searches' supersteps")

    return time_fused_post_init(engine.lcc, "[27]")


def fused_counting_at_s21(engine, errs):
    """Phase 27 after phase 14, on its counting engine: one s21 counting
    search each with the compact path and with compact=False in which every
    fused superstep (the counting instantiations) is held against its twin
    on the same inputs, anchors asserted; then both timed at the post-init
    state of the full engine as ``fused_at_s21`` times the default mode's."""
    for compact, what in ((True, "compact"), (False, "compact=False")):
        with FusedCheck(errs) as chk:
            r = compact_mode(engine, compact).run()
        check_anchors(r, S21_ANCHORS, f"[27] s21 counting {what} checked search")
        log(f"[27] s21 counting {what}: every fused superstep equals its twin "
            f"({chk.n} checked, {len(lp_rows(r))} supersteps), anchors OK")
    check_errs({k: errs[k] for k in FUSED_KERNELS}, "on the s21 counting searches' supersteps")
    compact_mode(engine, True)
    return time_fused_post_init(engine.lcc, "[27] counting")


def time_fused_post_init(lcc, tag):
    """Both fused supersteps of ``lcc`` at its post-init state of the full
    graph (K2 over every slot), by CUDA-graph replay in turns (twin, kernel,
    kernel, twin) beside the twin, each also eagerly, and their bytes
    bounds."""
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    alive_rev = ops.rev_alive_lookup(lcc._rev_flat, ops.alive_table(st.alive))
    planes, tmpl = lcc._planes, lcc._tmpl
    fns = {
        "init_superstep": (
            lambda: lf.init_superstep(planes, lcc.label_tv, tmpl),
            lambda: lf.init_superstep_reference(planes, lcc.label_tv, tmpl),
        ),
        "continuation_superstep": (
            lambda: lf.continuation_superstep(planes, st.tv, st.alive, st.tp_flag, alive_rev, tmpl),
            lambda: lf.continuation_superstep_reference(
                planes, st.tv, st.alive, st.tp_flag, alive_rev, tmpl),
        ),
    }
    nbytes = fused_bound_ms(lcc, alive_rev)
    split = planes.table[:, lf.SPLIT] == 1
    longest = int(planes.table[split, lf.W].max() * planes.seg_start.diff().max()) if split.any() else 0
    log(f"{tag} post-init state: {int(st.alive.sum())} alive slots of {lcc.num_slots}, "
        f"alive_rev set {int(alive_rev.sum())}, {planes.seg_rows.numel()} segments in "
        f"{len(planes.table)} buckets (rows, width) {planes.table[:, :2].tolist()}, the longest "
        f"split segment {longest} slots; superstep_bytes {superstep_bytes(lcc, init=True)} B "
        f"(init), {superstep_bytes(lcc)} B (continuation)")
    times = {}
    for k, (kernel, plain) in fns.items():
        raw = [time_cuda(plain, reps=5), time_cuda(kernel), time_cuda(kernel),
               time_cuda(plain, reps=5)]
        k_ms, p_ms = (raw[1] + raw[2]) / 2, (raw[0] + raw[3]) / 2
        bound = nbytes[k] / HBM_BYTES_PER_MS
        times[k] = (k_ms, p_ms, bound)
        log(f"{tag} {k}: kernel {raw[1]:.4f}/{raw[2]:.4f} ms, twin {raw[0]:.4f}/{raw[3]:.4f} "
            f"ms (CUDA-graph replay); eager kernel {time_cuda(kernel, graph=False):.4f} ms, "
            f"eager twin {time_cuda(plain, reps=3, graph=False):.4f} ms; bound {bound:.4f} ms "
            f"({nbytes[k]} B, bytes), {100 * bound / k_ms:.1f} % of bound")
    return times


TOOL_SHARDS = (1, 2, 4)  # phase 26's mesh sizes, shards of the one card
TOOL_SCALE = 17  # phase 26's scaling and communication-volume graph
BENCH_CHILD_TIMEOUT = 300  # seconds the bench_torch.py process may take


def run_tools(g, labels, dev):
    """Phase 26: the port's measurement scripts on the card. bench_torch's
    measurement on the s21 graph of phase 5 (its anchors on every run, the
    kernels' launches), profile_search's phase split and init_decompose's
    split of the init superstep on the same engine; the sweep at s13 over
    both engines and four modes against its pinned anchors (the mesh pair
    launched in the full-plane cells); scaling_bench and comm_volume at
    s17 on 1, 2 and 4 shards of the card; and bench_torch.py as its own
    process at BENCH_SCALE=13, through its graph cache."""
    t0 = time.perf_counter()
    engine = bench_torch.build_engine(g, labels, dev)
    build_s = time.perf_counter() - t0
    rec = bench_torch.measure(engine, 21)
    log(f"[26] bench_torch.measure, s21 tree (engine build {build_s:.3f} s): best "
        f"{rec['best_seconds']:.4f} s of {[round(x, 4) for x in rec['seconds_all']]}, warm-up "
        f"{rec['warmup_seconds']:.4f} s, {rec['value'] / 1e6:.2f} M traversed edges/s; anchors "
        f"OK {rec['anchors']}; kernel launches in the search {rec['launches']}; host loadavg "
        f"{rec['host_loadavg']}; {rec['card']}")
    for k in BUCKET_KERNELS:
        if rec["launches"][k] == 0:
            raise AssertionError(f"[26] {k}: no launch in bench_torch's s21 search")
    (split,) = phase_split(engine, runs=1)
    log(f"[26] profile_search phase split, s21 tree: {split['total']:.4f} s = LP "
        f"{split['lp']:.4f} + TP {split['tp']:.4f} + other {split['other']:.4f} s; TP and "
        f"step-0 rows (itr, phase, step, s) {[(i, p, st, round(x, 4)) for i, p, st, x in split['rows']]}")
    dec = init_decompose.decompose(engine.lcc, reps=3)
    parts = {k: round(v, 4) for k, v in dec["parts_ms"].items()}
    log(f"[26] init_decompose, s21 init superstep's plain twin, device ms by part {parts}, "
        f"total {dec['profiled_total_ms']:.4f} ms (profiled window "
        f"{dec['profiled_wall_ms']:.3f} ms on the host clock); the twin alone "
        f"{dec['plain_best_ms']:.4f} ms of {[round(x, 4) for x in dec['plain_ms']]}, the "
        f"engine's (K1) {dec['superstep_best_ms']:.4f} ms of "
        f"{[round(x, 4) for x in dec['superstep_ms']]}, against its bytes bound "
        f"{dec['bound_ms']:.4f} ms ({dec['bound_bytes']} B); post-init alive_pairs "
        f"({dec['alive_pairs']} pairs) {dec['alive_pairs_best_ms']:.4f} ms of "
        f"{[round(x, 4) for x in dec['alive_pairs_ms']]}")
    del engine
    torch.cuda.empty_cache()

    matrix, failed = sweep.run_sweep([13], ["bucketed", "sharded"], sweep.MODES, 2, dev)
    if failed:
        raise AssertionError(f"[26] sweep cells failed or diverged: "
                             f"{ {k: matrix[k]['error'] for k in failed} }")
    for name, cell in matrix.items():
        log(f"[26] sweep {name}: best {cell['seconds_best']:.4f} s of "
            f"{[round(x, 4) for x in cell['seconds_all']]}, warm-up {cell['warmup_seconds']:.4f} "
            f"s, {cell['edges_per_sec'] / 1e6:.3f} M edges/s, launches {cell['launches']}")
    need = {"s13/bucketed/default": BUCKET_KERNELS, "s13/sharded/full_plane": MESH_KERNELS}
    for name, kernels in need.items():
        if min(matrix[name]["launches"][k] for k in kernels) == 0:
            raise AssertionError(f"[26] {name}: launches {matrix[name]['launches']}")
    log(f"[26] sweep: every s13 cell equals {sweep.PINNED_ANCHORS[(13, 'tree')]}")

    g17, labels17 = scaling_bench.rmat_graph(TOOL_SCALE)
    rows = scaling_bench.scaling(g17, labels17, TOOL_SHARDS, 3, dev, shards=True)
    log(f"[26] scaling_bench s{TOOL_SCALE}, shards of the card: "
        f"{[(r['n'], round(r['ms_per_superstep'], 3)) for r in rows]} (n, ms a superstep)")
    vol = comm_volume.volumes([TOOL_SCALE], TOOL_SHARDS, dev, True)
    log(f"[26] comm_volume s{TOOL_SCALE} (n, cut share, cross B, wire B a shard and "
        f"superstep): {[(r['n'], round(r['cut_fraction'], 4), r['cross_bytes_max_per_device_per_superstep'], r['wire_bytes_per_device_per_superstep']) for r in vol]}")
    if [r["n"] for r in rows] != list(TOOL_SHARDS) or [r["n"] for r in vol] != list(TOOL_SHARDS):
        raise AssertionError("[26] a mesh size was skipped")

    env = dict(os.environ, BENCH_SCALE="13")
    env.pop("BENCH_FRESH", None)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=BENCH_CHILD_TIMEOUT)
    if p.returncode != 0:
        raise AssertionError(f"[26] bench_torch.py exited with {p.returncode}:\n{p.stderr}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    if line["anchors"] != bench_torch.ANCHORS[13] or "cached graph" not in p.stderr:
        raise AssertionError(f"[26] bench_torch.py at s13: {line}\n{p.stderr}")
    log(f"[26] python3 bench_torch.py at BENCH_SCALE=13 (the sweep's cached graph) in "
        f"{time.perf_counter() - t0:.1f} s: {line}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log("[1] card (nvidia-smi name, power.limit):")
    print(smi, flush=True)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[2] kernels built (one nvcc per source, in parallel) and loaded in "
        f"{time.perf_counter() - t0:.2f} s (nvcc seconds {_build.build_seconds})")
    for name, out in _build.build_logs.items():
        log(f"[2] {name}.cu, nvcc -Xptxas -v (kernel, registers, static smem B, spill "
            f"stores + loads B): {ptxas_usage(out)}")

    errs = {k: 0 for k in KERNELS}
    compare_kernels_small(dev, errs)
    compare_fused_small(dev, errs)
    compare_walk_kernels_small(dev, errs)
    compare_walk_routes_small(dev, errs)

    with open(os.path.join(GOLDEN_BASE, "golden_meta.json")) as f:
        golden = json.load(f)
    for mode in ("auto", "device"):
        tag = "[4]" if mode == "auto" else "[10]"
        for name in ("tree_s13", "cycle_s13"):
            cfg = golden["configs"][name]
            g, labels, pattern, constraints = build_config(
                cfg["scale"], os.path.join(REPO, cfg["corpus"])
            )
            t0 = time.perf_counter()
            r = MatchEngine(
                g, labels, pattern, constraints, num_ranks=golden["num_ranks"],
                nlcc_mode=mode, device=dev,
            ).run()
            want = {k: cfg[k] for k in ("active_vertices", "active_edges", "subgraphs")}
            check_anchors(r, want, f"{name} nlcc_mode={mode}")
            if r.iterations != cfg["iterations"]:
                raise AssertionError(f"{name}: {r.iterations} iterations, want {cfg['iterations']}")
            log(f"{tag} {name} nlcc_mode={mode}: anchors OK {want}, iterations "
                f"{r.iterations}, {time.perf_counter() - t0:.3f} s")

    log(f"[5] native library available: {native.available()}")
    t0 = time.perf_counter()
    src, dst = rmat_all_ranks(21, 4)
    t1 = time.perf_counter()
    g = from_edges(src, dst, num_vertices=1 << 21)
    labels = degree_labels(g)
    del src, dst
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pattern, constraints = load_tree_pattern(tmp)
    log(f"[5] R-MAT s21: V={g.num_vertices} E={g.num_edges}; generate "
        f"{t1 - t0:.2f} s, CSR + labels {t2 - t1:.2f} s")
    engine, launches, _ = run_s21(g, labels, pattern, constraints, dev, True)
    _, launches_full, r_full = run_s21(g, labels, pattern, constraints, dev, False, engine)
    times = kernels_at_s21(engine.lcc, errs)["post-init"]
    times.update(map_alive_at_s21(engine, errs))
    t0 = time.perf_counter()
    times.update(fused_at_s21(engine, errs))
    log(f"[27] the fused supersteps at s21 took {time.perf_counter() - t0:.1f} s")
    profile_search(compact_mode(engine, True), "s21 compact")
    profile_search(compact_mode(engine, False), "s21 compact=False")
    compact_mode(engine, True)

    cycle, walk_launches = run_s21_cycle(g, labels, dev)
    launches.update(walk_launches)
    tree_rows, _ = constraint_placements(engine, "s21 tree")
    cycle_rows, calls = constraint_placements(cycle, "s21 cycle", record=0)
    times.update(walk_kernels_at_s21(calls, errs))
    for tag, rows in (("tree", tree_rows), ("cycle", cycle_rows)):
        log(f"[12] s21 {tag} placements (constraint, kind, first expansion, messages, "
            f"forwarded keys, host s, device s): {rows}")
    profile_search(cycle, "s21 cycle nlcc_mode=device", S21_CYCLE_ANCHORS, "[13]")
    host_profile(cycle.run, "[13] s21 cycle nlcc_mode=device search")
    del cycle

    engines, _ = run_s21_modes(g, labels, pattern, constraints, dev, lp_rows(r_full))
    t0 = time.perf_counter()
    fused_counting_at_s21(engines["counting"], errs)
    log(f"[27] the counting supersteps at s21 took {time.perf_counter() - t0:.1f} s")
    engines["default"] = engine
    time_mode_supersteps(engines)
    del engines, engine
    torch.cuda.empty_cache()

    run_algorithms_s21(g, dev)
    run_cli_s13(golden)

    t0 = time.perf_counter()
    compare_payload_small(dev, golden, errs)
    mesh_dryrun(golden, dev)
    mesh_times, mesh_launches, ref = run_s21_mesh(g, labels, pattern, constraints, dev, errs)
    times.update(mesh_times)
    launches.update(mesh_launches)
    torch.cuda.empty_cache()
    run_s21_mesh_cycle(g, labels, dev, errs)
    torch.cuda.empty_cache()
    log(f"[20-23] the multi-device plane's phases took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_mesh_processes(g, labels, ref, 1, "gloo", "[24]")
    if torch.cuda.device_count() >= MESH_PROCESSES:
        run_mesh_processes(g, labels, ref, MESH_PROCESSES, "nccl", "[25]")
    else:
        log(f"[25] NCCL across processes not run: {torch.cuda.device_count()} CUDA "
            f"device here, and NCCL takes one process per card ({MESH_PROCESSES} cards "
            f"needed; it refuses two processes on one card)")
    log(f"[24-25] the mesh across processes took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_tools(g, labels, dev)
    log(f"[26] the measurement scripts took {time.perf_counter() - t0:.1f} s")

    bad = sorted(
        k for k in sys.modules
        if k in ("jax", "fuzzypatternmatching_tpu")
        or k.startswith(("jax.", "fuzzypatternmatching_tpu."))
    )
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"launches with compact=False: {launches_full}")
    print(json.dumps({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": KERNEL_SOURCES[k],
            "replaces": KERNELS[k],
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": times[k][0],
            "plain_ms": times[k][1],
            "bound_ms": times[k][2],
            "bound_by": "bytes",
            "library_ms": times[k][3] if len(times[k]) > 3 else None,
        }
        for k in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if "--mesh-child" in sys.argv[1:]:
        sys.exit(mesh_child(sys.argv[1:]))
    sys.exit(main())
