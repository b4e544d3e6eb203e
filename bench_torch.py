#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: traversed edges per second on one
card, on the reference workload of ``bench.py``.

Workload: R-MAT at ``BENCH_SCALE`` (default 21; ``rmat_all_ranks(scale,
4)``, the scrambled, undirected 4-rank stream), degree labels, the tree
pattern corpus (``pattern.builtin.load_tree_pattern``) and a default
``MatchEngine``: the whole LCC + NLCC prune-to-fixpoint search with TDS
enumeration.

Metric: traversed edges (LCC messages plus NLCC token hops) over the
search's seconds, the best of three warm runs, each ended by a device
synchronise. The warm-up run's result must equal the pinned anchors of
its scale (``ANCHORS``), and so must every timed run: otherwise the
script exits 1 and prints no result. A scale with no anchors runs
unchecked, with a note.

Prints one JSON line: the metric, its value and unit, the best, every run
and the warm-up seconds, the traversed edges, the anchors, the host load
average, the kernels' launches in the warm-up search, the card's name and
power limit, the commit and a hash of the sources, and the time.

    python3 bench_torch.py                 # on the card
    BENCH_SCALE=13 python3 bench_torch.py --device cpu

The graph is cached in ``.bench_cache/rmat_s<scale>`` through the port's
``graph/storage.py``, whose files are the JAX package's byte for byte;
``BENCH_FRESH=1`` builds it anew.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine  # noqa: E402
from fuzzypatternmatching_tpu_torch.ops import lcc_fused  # noqa: E402
from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops  # noqa: E402
from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern  # noqa: E402
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (  # noqa: E402
    load_nonlocal_constraints,
)
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph  # noqa: E402
from tools_torch.common import CACHE, clock, device_of, log, stamp  # noqa: E402

# The fixpoints of the tree corpus per scale (bench.py's anchors, and
# tools/sweep.py's s13 tree pin), which the JAX package's oracle-validated
# engine gives. A run that diverges is a semantic fault, not a datum.
ANCHORS = {
    13: {
        "active_vertices": 12,
        "active_edges": 22,
        "subgraphs": 6,
        "traversed_edges": 94524,
    },
    21: {
        "active_vertices": 147,
        "active_edges": 262,
        "subgraphs": 74,
        "traversed_edges": 13207467,
    },
    22: {
        "active_vertices": 412,
        "active_edges": 744,
        "subgraphs": 296,
        "traversed_edges": 30730528,
    },
    23: {
        "active_vertices": 7,
        "active_edges": 12,
        "subgraphs": 1,
        "traversed_edges": 27971377,
    },
}


class AnchorMismatch(AssertionError):
    """A search whose result differs from its scale's pinned anchors."""


def build_or_load_graph(scale: int):
    """(graph, labels) of the R-MAT workload, from the cache when it holds
    the scale (and ``BENCH_FRESH`` is unset), else generated and cached."""
    from fuzzypatternmatching_tpu_torch.generators.rmat import rmat_all_ranks
    from fuzzypatternmatching_tpu_torch.graph import storage
    from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges

    base = os.path.join(CACHE, f"rmat_s{scale}")
    if os.path.exists(os.path.join(base, "meta.json")) and not os.environ.get("BENCH_FRESH"):
        log(f"loading cached graph {base}")
        g, labels, _ = storage.load(base)
        return g, labels
    t0 = time.perf_counter()
    log(f"generating R-MAT s{scale} (4-rank stream, scrambled)...")
    src, dst = rmat_all_ranks(scale=scale, n_ranks=4)
    log(f"  {src.size} directed entries in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    g = from_edges(src, dst, num_vertices=1 << scale)
    labels = degree_labels(g)
    log(f"  CSR: V={g.num_vertices} E={g.num_edges} "
        f"max_deg={int(g.raw_degree.max())} in {time.perf_counter() - t0:.1f}s")
    storage.save(g, base, num_shards=4, labels=labels)
    return g, labels


def load_corpus(corpus: str = "tree"):
    """(pattern, constraints): the tree corpus (``pattern.builtin``) or the
    cycle corpus (``examples/patterns_cycle``)."""
    if corpus == "tree":
        with tempfile.TemporaryDirectory() as tmp:
            return load_tree_pattern(tmp)
    if corpus == "cycle":
        prefix = os.path.join(REPO, "examples", "patterns_cycle", "0", "pattern")
        return load_pattern_graph(prefix), load_nonlocal_constraints(prefix)
    raise ValueError(f"unknown corpus {corpus!r}")


def build_engine(g, labels, device, corpus: str = "tree", **kw) -> MatchEngine:
    """The benchmark's engine: the corpus, ``MatchEngine``'s defaults."""
    pattern, constraints = load_corpus(corpus)
    return MatchEngine(g, labels, pattern, constraints, device=device, **kw)


def summary(r) -> dict:
    return {
        "active_vertices": len(r.active_vertices),
        "active_edges": len(r.active_edges),
        "subgraphs": sum(len(v) for v in r.subgraphs.values()),
        "traversed_edges": r.traversed_edges,
    }


def check_anchors(want: dict | None, r, what: str) -> None:
    """Raises ``AnchorMismatch`` where ``r`` differs from the anchors
    ``want`` (None: nothing is pinned)."""
    if want is None:
        return
    got = summary(r)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AnchorMismatch(f"{what}: anchors differ (got, expected): {bad}")


def measure(engine: MatchEngine, scale: int, runs: int = 3) -> dict:
    """The warm-up search, then ``runs`` timed ones, each checked against
    the anchors; the record that ``main`` prints."""
    dev = engine.device
    ops.reset_launches()
    lcc_fused.reset_launches()
    t0 = clock(dev)
    r = engine.run()
    warmup = clock(dev) - t0
    launches = {**ops.launches, **lcc_fused.launches}
    anchors = ANCHORS.get(scale)
    check_anchors(anchors, r, f"s{scale} warm-up")
    log(f"  warm-up: {warmup:.3f}s, iterations={r.iterations}, {summary(r)}, "
        f"kernel launches {launches}")
    if anchors is None:
        log(f"  (no pinned anchors for s{scale}; the result is not checked)")
    times = []
    for i in range(runs):
        t0 = clock(dev)
        r = engine.run()
        times.append(clock(dev) - t0)
        check_anchors(anchors, r, f"s{scale} run {i}")
        log(f"  measured run {i}: {times[-1]:.4f}s")
    best = min(times)
    rate = r.traversed_edges / best
    log(f"  best of {runs}: {best:.4f}s, {rate / 1e6:.2f} M traversed edges/s")
    return {
        "metric": f"traversed edges/sec/chip (LCC+NLCC, R-MAT s{scale} tree pattern)",
        "value": rate,
        "unit": "edges/s",
        "best_seconds": best,
        "seconds_all": times,
        "warmup_seconds": warmup,
        "traversed_edges": r.traversed_edges,
        "iterations": r.iterations,
        "anchors": anchors,
        "launches": launches,
        "host_loadavg": list(os.getloadavg()),
        **stamp(dev),
    }


def run_bench(g, labels, device, runs: int = 3, scale: int | None = None) -> dict:
    """``measure`` on a graph the caller holds (its scale from V)."""
    scale = int(g.num_vertices).bit_length() - 1 if scale is None else scale
    return measure(build_engine(g, labels, device), scale, runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    scale = int(os.environ.get("BENCH_SCALE", "21"))
    g, labels = build_or_load_graph(scale)
    try:
        rec = run_bench(g, labels, dev, args.runs, scale)
    except AnchorMismatch as e:
        log(f"ANCHOR MISMATCH: {e}")
        log("refusing to emit a bench number for a semantically wrong search")
        return 1
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
