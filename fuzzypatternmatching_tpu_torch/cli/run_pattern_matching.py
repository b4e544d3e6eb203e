"""Fuzzy pattern matching search on the torch engine.

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.run_pattern_matching \\
      -i <graph_db> -p <pattern_dir> -o <result_dir> \\
      [-r <output_ranks>] [-x <tds_batch>] [--max-iterations N] \\
      [--no-compact] [--device {cuda,cpu}]

Searches ``<pattern_dir>/0`` on a graph DB (the JAX package's
``graph.storage.save`` writes one; ``graph/storage.py`` reads it) and writes
the result tree with ``io/results.py::write_results`` — the layout of the
JAX package's CLI.
``--device cuda`` (the default) requires a CUDA card; there is no fallback
to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..engine.driver import MatchEngine
from ..graph import storage
from ..io.labels import resolve_labels
from ..io.results import write_results
from ..pattern.nonlocal_constraint import load_nonlocal_constraints
from ..pattern.pattern_graph import load_pattern_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description="fuzzy pattern matching (torch)")
    ap.add_argument("-i", "--input", required=True, help="graph DB directory")
    ap.add_argument("-p", "--pattern-dir", required=True)
    ap.add_argument("-o", "--output", required=True, help="result directory")
    ap.add_argument("-r", "--ranks", type=int, default=None,
                    help="output ranks (default: graph DB shard count)")
    ap.add_argument("-x", "--batch", type=int, default=1 << 16,
                    help="token-source batch size (TDS)")
    ap.add_argument("--max-iterations", type=int, default=100)
    ap.add_argument("--no-compact", action="store_true",
                    help="run every LCC superstep on the full graph instead "
                         "of a pruned-subgraph engine after the first "
                         "superstep (results identical)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    graph, stored_labels, _ = storage.load(args.input)
    print(f"opened graph DB: V={graph.num_vertices} E={graph.num_edges}")
    labels = resolve_labels(graph, None, stored_labels)
    if stored_labels is None:
        print("using degree labels ceil(log2(d+1))")

    num_ranks = args.ranks
    if num_ranks is None:
        with open(os.path.join(args.input, "meta.json")) as f:
            num_ranks = json.load(f)["num_shards"]

    os.makedirs(args.output, exist_ok=True)
    pattern_set_path = os.path.join(args.output, "result_pattern_set")
    if os.path.exists(pattern_set_path):
        os.remove(pattern_set_path)

    prefix = os.path.join(args.pattern_dir, "0", "pattern")
    if not os.path.isdir(os.path.dirname(prefix)):
        ap.error(f"pattern subdirectory 0 not found under {args.pattern_dir}")
    pattern = load_pattern_graph(prefix)
    constraints = load_nonlocal_constraints(prefix, pattern.vertex_data)
    print(
        f"pattern [0]: K={pattern.vertex_count} diameter={pattern.diameter} "
        f"constraints={len(constraints)}"
    )
    t0 = time.time()
    engine = MatchEngine(
        graph, labels, pattern, constraints, num_ranks=num_ranks,
        source_batch=args.batch, compact=not args.no_compact,
        device=args.device,
    )
    result = engine.run(max_iterations=args.max_iterations)
    print(
        f"pattern [0]: iterations={result.iterations} "
        f"time={time.time()-t0:.2f}s "
        f"active_vertices={len(result.active_vertices)} "
        f"active_edges={len(result.active_edges)} "
        f"found={result.pattern_found}"
    )
    for pl, subs in sorted(result.subgraphs.items()):
        print(f"  constraint [{pl}]: {len(subs)} enumerated subgraphs")
    write_results(
        args.output, 0, result, labels, num_ranks,
        pattern.edge_count, pattern.vertex_count, len(constraints),
    )
    print(f"results written to {args.output}")


if __name__ == "__main__":
    main()
