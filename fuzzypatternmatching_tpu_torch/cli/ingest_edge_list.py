"""Ingest edge-list files into a graph DB — the src/ingest_edge_list.cpp driver
(the port's own copy of ``fuzzypatternmatching_tpu/cli/ingest_edge_list.py``;
the same DB).

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.ingest_edge_list -o /path/db \\
      [-u] [-p 4] file1 file2 ...
"""

from __future__ import annotations

import argparse

from ..generators.edge_list import read_edge_lists
from ..graph import storage
from ..graph.csr import from_edges
from ..utils.dist import add_distributed_args


def main(argv=None):
    ap = argparse.ArgumentParser(description="edge list ingest")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-u", "--undirected", action="store_true",
                    help="emit both directions of each entry")
    ap.add_argument("-p", "--partitions", type=int, default=4)
    ap.add_argument("--chunked", action="store_true",
                    help="bounded-memory build: one file at a time spills "
                         "to owner shards (needs --num-vertices)")
    ap.add_argument("--num-vertices", type=int, default=None,
                    help="vertex-id space for --chunked (max id + 1)")
    ap.add_argument("files", nargs="+")
    add_distributed_args(ap)
    args = ap.parse_args(argv)

    if (args.num_processes or 1) > 1:
        # multi-process ingest: input files round-robin per process (the
        # parallel_edge_list_reader.hpp:175 assignment), owner-partitioned
        # spill through the shared output dir (ipp:398-608 analog)
        if args.num_vertices is None:
            ap.error("multi-process ingest requires --num-vertices")
        from ..graph.build import build_db_from_chunks_distributed

        pid = args.process_id or 0
        my_files = args.files[pid :: args.num_processes]

        def chunks():
            for path in my_files:
                s, d, _ = read_edge_lists([path], undirected=args.undirected)
                yield s, d

        build_db_from_chunks_distributed(
            args.output, chunks(), args.num_vertices, pid,
            args.num_processes, num_shards=args.partitions,
        )
        if pid == 0:
            db = storage.open_db(args.output)
            print(
                f"{args.num_processes}-process build: V={db.num_vertices} "
                f"E={db.num_edges}"
            )
            print(f"saved graph DB to {args.output}")
        return

    if args.chunked:
        if args.num_vertices is None:
            ap.error("--chunked requires --num-vertices")
        from ..graph.build import build_db_from_chunks

        def chunks():
            for path in args.files:
                s, d, _ = read_edge_lists([path], undirected=args.undirected)
                yield s, d

        build_db_from_chunks(
            args.output, chunks(), args.num_vertices,
            num_shards=args.partitions,
        )
        db = storage.open_db(args.output)
        print(f"chunked build: V={db.num_vertices} E={db.num_edges}")
    else:
        src, dst, edge_data = read_edge_lists(
            args.files, undirected=args.undirected
        )
        g = from_edges(src, dst)
        print(f"built CSR: V={g.num_vertices} E={g.num_edges}")
        storage.save(g, args.output, num_shards=args.partitions)
    print(f"saved graph DB to {args.output}")


if __name__ == "__main__":
    main()
