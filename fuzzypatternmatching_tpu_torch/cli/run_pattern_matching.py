"""Fuzzy pattern matching search on the torch engine.

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.run_pattern_matching \\
      -i <graph_db> -p <pattern_dir> -o <result_dir> \\
      [-v <vertex_data_base>] [-b <backup_db>] [--pattern-set N] \\
      [--output-vertex-data] [-r <output_ranks>] [-x <tds_batch>] \\
      [--max-iterations N] [-e <edge_data_base | db>] [--counting] \\
      [--lcc-engine {bucketed,flat,sharded}] [--shards N] [--mmap] \\
      [--superstep-timing] [--no-compact] [--device {cuda,cpu}]

``pattern_dir`` contains numbered subdirectories (the "pattern set"); like
the reference, only ``<pattern_dir>/0`` is searched by default
(beta.cpp:424); ``--pattern-set N`` searches 0..N-1 and ``--pattern-set 0``
every numbered subdirectory. The graph DB is what ``graph/storage.py``
writes (``cli.generate_rmat``, ``cli.ingest_edge_list``); ``-b`` restores
it from a backup first (``storage.transfer``). The result tree is the
layout of the JAX package's CLI (``io/results.py``). ``-v``, ``-e``,
``--counting``, ``--lcc-engine``, ``--mmap``, ``--superstep-timing`` and
``--output-vertex-data`` behave as the JAX package's flags of the same
names. ``--lcc-engine sharded`` runs on a mesh (``utils/dist.build_mesh``):
one shard per visible CUDA device, or ``--shards N`` shards on one device
(the port's own flag; with ``--device cpu``, N shards on the CPU).
``--mmap`` opens the DB shard by shard with no global CSR
(``storage.open_db``), on the sharded engine only. ``--distributed`` (a
multi-process run, ``cli/launch_multiprocess.py``) joins the process group
(``utils/dist.placement``: gloo for ``--device cpu`` and for processes that
share a card, else NCCL, one process per card); the mesh of ``--lcc-engine sharded`` then spans the processes, and
the search stops with the driver's error: its match loop is
single-controller, as in the JAX package, whose multi-process run covers
the LCC data plane (``cli/sharded_lcc_demo.py``). ``--device cuda`` (the
default) requires a CUDA card; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..engine.driver import MatchEngine
from ..graph import storage
from ..io.labels import resolve_labels
from ..io.results import write_results, write_vertex_data
from ..pattern.nonlocal_constraint import load_nonlocal_constraints
from ..pattern.pattern_graph import load_pattern_graph
from ..utils.dist import add_distributed_args, build_mesh, init_distributed


def _edge_data_from_files(ap, graph, base: str) -> np.ndarray:
    """Per-CSR-edge metadata from the files ``<base>*`` (src dst data
    rows). Each row applies to BOTH CSR directions (graphs are
    symmetrized; a file listing each undirected edge once must not leave
    the reverse direction at the default, which the enforcement would kill
    asymmetrically). Conflicting values for one direction are an input
    error; edges with no row get value 0."""
    import glob

    from ..generators.edge_list import read_edge_lists

    files = sorted(glob.glob(base + "*")) or [base]
    src, dst, data = read_edge_lists(files, undirected=False)
    if data is None:
        ap.error("edge metadata files need a third (data) column")
    vv = np.uint64(graph.num_vertices)
    src2 = np.concatenate([src, dst]).astype(np.uint64)
    dst2 = np.concatenate([dst, src]).astype(np.uint64)
    data2 = np.concatenate([data, data])
    want = src2 * vv + dst2
    order = np.argsort(want, kind="stable")
    w_s, d_s = want[order], data2[order]
    dup = w_s[1:] == w_s[:-1]
    if np.any(dup & (d_s[1:] != d_s[:-1])):
        bad = np.nonzero(dup & (d_s[1:] != d_s[:-1]))[0][0]
        u, v = int(w_s[bad] // vv), int(w_s[bad] % vv)
        ap.error(
            f"conflicting edge metadata for ({u}, {v}): "
            f"{int(d_s[bad])} vs {int(d_s[bad + 1])}"
        )
    first = np.concatenate([[True], ~dup])
    w_s, d_s = w_s[first], d_s[first]
    keys = graph.edge_row.astype(np.uint64) * vv + graph.cols.astype(np.uint64)
    pos = np.minimum(np.searchsorted(w_s, keys), len(w_s) - 1)
    ok = w_s[pos] == keys
    edge_data = np.zeros(graph.num_edges, dtype=np.int64)
    edge_data[ok] = d_s[pos[ok]]
    matched = int(ok.sum())
    print(f"edge metadata: matched {matched}/{graph.num_edges} CSR directions")
    if matched < graph.num_edges:
        print(
            f"WARNING: {graph.num_edges - matched} graph edges have "
            "no metadata row and default to value 0 — they will "
            "match only pattern edges requiring 0"
        )
    return edge_data


def main(argv=None):
    ap = argparse.ArgumentParser(description="fuzzy pattern matching (torch)")
    ap.add_argument("-i", "--input", required=True, help="graph DB directory")
    ap.add_argument("-p", "--pattern-dir", required=True)
    ap.add_argument("-o", "--output", required=True, help="result directory")
    ap.add_argument("-v", "--vertex-data", default=None,
                    help="vertex label file base (default: degree labels)")
    ap.add_argument("-b", "--backup", default=None,
                    help="restore the graph DB from this backup first")
    ap.add_argument("-e", "--edge-data", default=None,
                    help="activate edge-metadata-constrained matching: "
                         "'db' uses the metadata stored in the graph DB, "
                         "anything else is an edge metadata file base (src "
                         "dst data rows). Requires a pattern_edge_data file "
                         "in the pattern dir. (The reference parses -e but "
                         "never enforces it — beta.cpp:114-115, :575; "
                         "enforcement is this framework's opt-in extension.)")
    ap.add_argument("-r", "--ranks", type=int, default=None,
                    help="output ranks (default: graph DB shard count)")
    ap.add_argument("-x", "--batch", type=int, default=1 << 16,
                    help="token-source batch size (TDS)")
    ap.add_argument("--pattern-set", type=int, default=1,
                    help="number of pattern subdirectories to search "
                         "(0 = every numbered subdirectory present)")
    ap.add_argument("--max-iterations", type=int, default=100)
    ap.add_argument("--lcc-engine", choices=["bucketed", "flat", "sharded"],
                    default="bucketed",
                    help="LCC engine; with --distributed, 'sharded' builds "
                         "a mesh across the processes, which the search "
                         "refuses (its match loop is single-controller; "
                         "the LCC data plane alone runs across processes: "
                         "cli/sharded_lcc_demo.py)")
    ap.add_argument("--counting", action="store_true",
                    help="counting-LCC: require per-neighbor-label-class "
                         "count thresholds from the template "
                         "(label_propagation_pattern_matching_nonunique_"
                         "counting_ee.hpp); works with every --lcc-engine")
    ap.add_argument("--shards", type=int, default=None,
                    help="--lcc-engine sharded: this many shards on the one "
                         "--device (default: one shard per visible CUDA device)")
    ap.add_argument("--mmap", action="store_true",
                    help="per-shard open (db_open analog): edge arrays stay "
                         "memmapped, no global CSR on this host; requires "
                         "--lcc-engine sharded")
    ap.add_argument("--output-vertex-data", action="store_true",
                    help="dump all_ranks_vertex_data files (beta.cpp:379)")
    ap.add_argument("--superstep-timing", action="store_true",
                    help="dispatch one superstep per device call and record "
                         "real per-step seconds in result_superstep "
                         "(beta.cpp:592-596); default runs every superstep of "
                         "an LCC call at once and divides its total")
    ap.add_argument("--no-compact", action="store_true",
                    help="run every LCC superstep on the full graph instead "
                         "of a pruned-subgraph engine after the first "
                         "superstep (results identical)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    add_distributed_args(ap)
    args = ap.parse_args(argv)
    if args.mmap and args.lcc_engine != "sharded":
        ap.error("--mmap requires --lcc-engine sharded")
    if args.shards is not None and args.lcc_engine != "sharded":
        ap.error("--shards requires --lcc-engine sharded")

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    init_distributed(args, args.device)
    mesh = (
        build_mesh(shards=args.shards, device=args.device)
        if args.lcc_engine == "sharded" else None
    )

    if args.backup:
        storage.transfer(args.backup, args.input)
    if args.mmap:
        graph = storage.open_db(args.input)
        stored_labels, stored_edata = graph.labels, None
    else:
        graph, stored_labels, stored_edata = storage.load(args.input)
    print(f"opened graph DB: V={graph.num_vertices} E={graph.num_edges}")
    labels = resolve_labels(graph, args.vertex_data, stored_labels)
    if args.vertex_data is None and stored_labels is None:
        print("using degree labels ceil(log2(d+1))")

    edge_data = None
    if args.edge_data == "db":
        edge_data = stored_edata
        if edge_data is None:
            ap.error(
                f"-e db: {args.input} has no stored edge metadata "
                "(run cli.build_edge_metadata first)"
            )
    elif args.edge_data:
        edge_data = _edge_data_from_files(ap, graph, args.edge_data)

    num_ranks = args.ranks
    if num_ranks is None:
        with open(os.path.join(args.input, "meta.json")) as f:
            num_ranks = json.load(f)["num_shards"]

    if args.output_vertex_data:
        write_vertex_data(args.output, labels, graph.raw_degree, num_ranks)

    pattern_set_path = os.path.join(args.output, "result_pattern_set")
    os.makedirs(args.output, exist_ok=True)
    if os.path.exists(pattern_set_path):
        os.remove(pattern_set_path)

    available = sorted(
        int(d) for d in os.listdir(args.pattern_dir)
        if d.isdigit() and os.path.isdir(os.path.join(args.pattern_dir, d))
    )
    if args.pattern_set == 0:
        pattern_sets = available
    else:
        pattern_sets = list(range(args.pattern_set))
        missing = [p for p in pattern_sets if p not in available]
        if missing:
            ap.error(
                f"pattern subdirectories {missing} not found under "
                f"{args.pattern_dir} (available: {available}); "
                "use --pattern-set 0 to search every set present"
            )

    for ps in pattern_sets:
        prefix = os.path.join(args.pattern_dir, str(ps), "pattern")
        pattern = load_pattern_graph(prefix)
        constraints = load_nonlocal_constraints(prefix, pattern.vertex_data)
        print(
            f"pattern [{ps}]: K={pattern.vertex_count} "
            f"diameter={pattern.diameter} constraints={len(constraints)}"
        )
        if edge_data is not None and pattern.edge_data is None:
            print(
                f"pattern [{ps}]: no pattern_edge_data file — edge-metadata "
                "constraints inactive for this pattern"
            )
        t0 = time.time()
        engine = MatchEngine(
            graph, labels, pattern, constraints, num_ranks=num_ranks,
            source_batch=args.batch, lcc_engine=args.lcc_engine, mesh=mesh,
            counting=args.counting, edge_data=edge_data,
            compact=not args.no_compact, superstep_timing=args.superstep_timing,
            device=args.device,
        )
        result = engine.run(max_iterations=args.max_iterations)
        print(
            f"pattern [{ps}]: iterations={result.iterations} "
            f"time={time.time()-t0:.2f}s "
            f"active_vertices={len(result.active_vertices)} "
            f"active_edges={len(result.active_edges)} "
            f"found={result.pattern_found}"
        )
        for pl, subs in sorted(result.subgraphs.items()):
            print(f"  constraint [{pl}]: {len(subs)} enumerated subgraphs")
        write_results(
            args.output, ps, result, labels, num_ranks,
            pattern.edge_count, pattern.vertex_count, len(constraints),
        )
    print(f"results written to {args.output}")


if __name__ == "__main__":
    main()
