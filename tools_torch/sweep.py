#!/usr/bin/env python3
"""Benchmark sweep of the port: {scale} x {engine} x {mode} x {corpus} on
one card, every cell stamped, merged into one JSON matrix. The
counterpart of ``tools/sweep.py``.

    python3 tools_torch/sweep.py [--scales 13,21] [--engines bucketed,sharded]
        [--modes default,counting,meta,full_plane] [--runs 3]
        [--corpora tree,cycle] [--shards N] [--device cuda|cpu] [--out FILE]

Modes:
  default    the production path (compact continuation).
  full_plane the sharded engine with compact=False (every superstep on the
             mesh data plane); skipped for the other engines.
  counting   counting-LCC.
  meta       edge-metadata matching: every edge carries the value the tree
             corpus's pattern edges require, so the anchors are unchanged.

The sharded engine runs on a mesh of ``--shards`` shards (default 1) of the
one device, as the JAX sweep's one-device mesh. Its cells beside the
bucketed cells of the same scale give the mesh plane's constant factor on
one card (what ``tools/sharded_chip_bench.py`` measured on the TPU).

Each cell records the best and every time over ``--runs`` warm runs (each
ended by a device synchronise), the warm-up, traversed edges, edges/s,
iterations, the anchors (active vertices and edges, subgraphs), the
kernels' launches in the warm-up search, and its own stamp (the card's
name and power limit, the commit, a hash of the sources, the time), so
that a rerun of a subset never relabels older cells. Every cell of a pinned (scale, corpus) must
equal ``PINNED_ANCHORS``; an unpinned one must agree with the first cell
of its key. A cell that fails or diverges is recorded with its error and
the sweep goes on, then exits 1. The matrix goes to ``--out`` (default
``.bench_cache/sweep_torch.json``), merged with what the file held.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine  # noqa: E402
from fuzzypatternmatching_tpu_torch.ops import lcc_fused  # noqa: E402
from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops  # noqa: E402
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh  # noqa: E402
from tools_torch.common import CACHE, clock, device_of, log, stamp  # noqa: E402

# tools/sweep.py's pins: the golden trees' fixpoints (s11, s13) and the
# JAX package's validated runs, on the sweep's scrambled stream
PINNED_ANCHORS = {
    (11, "tree"): {
        "active_vertices": 0, "active_edges": 0, "subgraphs": 0,
        "traversed_edges": 25734,
    },
    (13, "tree"): {
        "active_vertices": 12, "active_edges": 22, "subgraphs": 6,
        "traversed_edges": 94524,
    },
    (13, "cycle"): {
        "active_vertices": 254, "active_edges": 5500, "subgraphs": 109,
        "traversed_edges": 1037191,
    },
    (17, "cycle"): {
        "active_vertices": 0, "active_edges": 0, "subgraphs": 0,
        "traversed_edges": 282425,
    },
    (19, "cycle"): {
        "active_vertices": 54, "active_edges": 122, "subgraphs": 18,
        "traversed_edges": 4170009,
    },
    (21, "cycle"): {
        "active_vertices": 169, "active_edges": 346, "subgraphs": 56,
        "traversed_edges": 105906296,
    },
    (21, "tree"): {
        "active_vertices": 147, "active_edges": 262, "subgraphs": 74,
        "traversed_edges": 13207467,
    },
    (22, "tree"): {
        "active_vertices": 412, "active_edges": 744, "subgraphs": 296,
        "traversed_edges": 30730528,
    },
    (23, "tree"): {
        "active_vertices": 7, "active_edges": 12, "subgraphs": 1,
        "traversed_edges": 27971377,
    },
}
MODES = ("default", "full_plane", "counting", "meta")


def tree_edge_meta(graph, pattern):
    """Edge data under which the tree-corpus search is unchanged: the
    corpus requires the single value 55 on every pattern edge, so a graph
    whose edges all carry it prunes as without metadata while the metadata
    machinery runs. None where the pattern has no single such value."""
    if pattern.edge_data is None:
        return None
    vals = np.unique(np.asarray(pattern.edge_data))
    if len(vals) != 1:
        return None
    return np.full(graph.num_edges, int(vals[0]), dtype=np.int64)


def run_cell(scale, engine, mode, runs, dev, corpus="tree", shards=1):
    """One cell's record, or None where the mode does not apply."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    g, labels = bench_torch.build_or_load_graph(scale)
    pattern, constraints = bench_torch.load_corpus(corpus)
    kw = {}
    if engine == "sharded":
        kw["mesh"] = build_mesh(shards=shards, device=dev)
    if mode == "full_plane":
        if engine != "sharded":
            return None
        kw["compact"] = False
    if mode == "counting":
        kw["counting"] = True
    if mode == "meta":
        ed = tree_edge_meta(g, pattern)
        if ed is None:
            log(f"  [skip] {engine}/{mode}: corpus has no single pattern edge value")
            return None
        kw["edge_data"] = ed
    eng = MatchEngine(g, labels, pattern, constraints, lcc_engine=engine, device=dev, **kw)
    log(f"  warm-up scale={scale} engine={engine} mode={mode}...")
    ops.reset_launches()
    lcc_fused.reset_launches()
    t0 = clock(dev)
    r = eng.run()
    warmup = clock(dev) - t0
    launches = {**ops.launches, **lcc_fused.launches}
    times = []
    for i in range(runs):
        t0 = clock(dev)
        r = eng.run()
        times.append(clock(dev) - t0)
        log(f"    run {i}: {times[-1]:.4f}s")
    dt = min(times)
    return {
        "seconds_best": dt,
        "seconds_all": times,
        "warmup_seconds": warmup,
        "traversed_edges": r.traversed_edges,
        "edges_per_sec": r.traversed_edges / dt,
        "iterations": r.iterations,
        **bench_torch.summary(r),
        "launches": launches,
        "shards": shards if engine == "sharded" else None,
    }


def anchor_error(cell, key, seen) -> str | None:
    """Why the cell's result is wrong, or None: against the pinned anchors
    of its (scale, corpus), else against the first cell of that key."""
    pinned = PINNED_ANCHORS.get(key)
    if pinned is not None:
        bad = {k: (cell[k], v) for k, v in pinned.items() if cell[k] != v}
        return f"pinned anchor divergence (got, expected): {bad}" if bad else None
    log(f"  (no pinned anchors for {key}; cross-cell check only)")
    want = seen.setdefault(key, cell["active_vertices"])
    if cell["active_vertices"] != want:
        return f"anchor divergence: active={cell['active_vertices']}, expected {want}"
    return None


def run_sweep(scales, engines, modes, runs, dev, corpora=("tree",), shards=1, out=None):
    """Run every cell, merge the matrix into ``out`` after each one (when
    given); returns (matrix, names of the cells that failed)."""
    matrix = {}
    if out and os.path.exists(out):
        with open(out) as f:
            matrix.update(json.load(f).get("matrix", {}))
    seen = {}
    for cell in matrix.values():
        if "active_vertices" in cell:
            seen.setdefault((cell["scale"], cell.get("corpus", "tree")), cell["active_vertices"])
    st = stamp(dev)
    failed = []
    for corpus in corpora:
        for scale in scales:
            for engine in engines:
                for mode in modes:
                    name = f"s{scale}/{engine}/{mode}"
                    if corpus != "tree":
                        name = f"s{scale}/{corpus}/{engine}/{mode}"
                    log(f"[{name}]")
                    try:
                        cell = run_cell(scale, engine, mode, runs, dev, corpus, shards)
                    except Exception as e:  # record the cell, go on, exit 1 at the end
                        traceback.print_exc()
                        cell = {"error": f"{type(e).__name__}: {e}"}
                    if cell is None:
                        continue
                    cell.update(scale=scale, engine=engine, mode=mode, corpus=corpus, **st)
                    if "error" not in cell:
                        err = anchor_error(cell, (scale, corpus), seen)
                        if err is not None:
                            cell["error"] = err
                    if "error" in cell:
                        log(f"  FAILED: {cell['error']}")
                        failed.append(name)
                    else:
                        log(f"  -> {cell['seconds_best']:.4f}s "
                            f"({cell['edges_per_sec']:.1f} edges/s)")
                    matrix[name] = cell
                    if out:
                        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
                        with open(out, "w") as f:
                            json.dump({"matrix": matrix}, f, indent=1)
    return matrix, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="benchmark sweep of the port")
    ap.add_argument("--scales", default="21")
    ap.add_argument("--engines", default="bucketed,sharded")
    ap.add_argument("--modes", default="default,full_plane")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--corpora", default="tree", help="comma list: tree,cycle")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards of the sharded engine's mesh, all on the one device")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(CACHE, "sweep_torch.json"))
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    matrix, failed = run_sweep(
        [int(s) for s in args.scales.split(",")], args.engines.split(","),
        args.modes.split(","), args.runs, dev, args.corpora.split(","), args.shards,
        args.out,
    )
    print(json.dumps({"matrix": matrix}, indent=1), flush=True)
    if failed:
        log(f"{len(failed)} cell(s) failed or diverged: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
