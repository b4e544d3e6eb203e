"""Generate an R-MAT graph DB — the src/generate_rmat.cpp driver (the port's
own copy of ``fuzzypatternmatching_tpu/cli/generate_rmat.py``; the same DB).

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.generate_rmat -s 21 -o /path/db \\
      [-p 4] [-d 16] [--no-scramble] [-b backup_dir]

Flags mirror generate_rmat.cpp:93-150 (-s scale, -o output, -p partitions,
-b backup via transfer; -d edges/vertex instead of hardcoded 16).

Multi-process: under scripts/launch_multiprocess.py (which appends
``--distributed --num-processes N --process-id i``) each process generates
its own slice of the generator ranks, spills by owner shard into the
shared output directory, and builds the shards it owns — the
owner-partitioned parallel construction of
delegate_partitioned_graph.ipp:398-608, synchronized via the shared
filesystem instead of MPI collectives. The resulting DB is byte-identical
to the single-process build.
"""

from __future__ import annotations

import argparse
import time

from ..generators.rmat import rmat_all_ranks
from ..graph import storage
from ..graph.csr import from_edges
from ..utils.dist import add_distributed_args


def main(argv=None):
    ap = argparse.ArgumentParser(description="R-MAT graph generator")
    ap.add_argument("-s", "--scale", type=int, required=True)
    ap.add_argument("-o", "--output", required=True, help="graph DB directory")
    ap.add_argument("-p", "--partitions", type=int, default=4,
                    help="generator ranks AND storage shards")
    ap.add_argument("-d", "--edges-per-vertex", type=int, default=16)
    ap.add_argument("--no-scramble", action="store_true")
    ap.add_argument("-b", "--backup", default=None)
    ap.add_argument("--in-memory", action="store_true",
                    help="materialize the full stream and CSR in RAM "
                         "(default: chunked spill build with "
                         "O(V + E/partitions) peak memory, "
                         "ipp:398-608 analog)")
    add_distributed_args(ap)
    args = ap.parse_args(argv)

    t0 = time.time()
    if (args.num_processes or 1) > 1:
        # multi-process construction exchanges through the shared output
        # dir + file barriers: no process group and no device are needed
        if args.in_memory:
            ap.error("--in-memory is single-process only")
        from ..graph.build import build_rmat_db_distributed

        pid = args.process_id or 0
        build_rmat_db_distributed(
            args.output, scale=args.scale, process_id=pid,
            num_processes=args.num_processes, n_ranks=args.partitions,
            num_shards=args.partitions,
            edges_per_vertex=args.edges_per_vertex,
            scramble=not args.no_scramble,
        )
        if pid == 0:
            db = storage.open_db(args.output)
            print(
                f"{args.num_processes}-process build: V={db.num_vertices} "
                f"E={db.num_edges} in {time.time()-t0:.1f}s"
            )
            print(f"saved graph DB to {args.output}")
            if args.backup:
                storage.transfer(args.output, args.backup)
                print(f"transferred to backup {args.backup}")
        return
    if args.in_memory:
        src, dst = rmat_all_ranks(
            scale=args.scale,
            n_ranks=args.partitions,
            edges_per_vertex=args.edges_per_vertex,
            scramble=not args.no_scramble,
        )
        print(
            f"generated {src.size} directed edge entries in "
            f"{time.time()-t0:.1f}s"
        )
        t0 = time.time()
        g = from_edges(src, dst, num_vertices=1 << args.scale)
        print(
            f"built CSR: V={g.num_vertices} E={g.num_edges} "
            f"max_degree={int(g.raw_degree.max())} in {time.time()-t0:.1f}s"
        )
        storage.save(g, args.output, num_shards=args.partitions)
    else:
        from ..graph.build import build_rmat_db

        build_rmat_db(
            args.output,
            scale=args.scale,
            n_ranks=args.partitions,
            num_shards=args.partitions,
            edges_per_vertex=args.edges_per_vertex,
            scramble=not args.no_scramble,
        )
        db = storage.open_db(args.output)
        print(
            f"chunked build: V={db.num_vertices} E={db.num_edges} "
            f"max_degree={int(db.raw_degree.max())} in {time.time()-t0:.1f}s"
        )
    print(f"saved graph DB to {args.output}")
    if args.backup:
        storage.transfer(args.output, args.backup)
        print(f"transferred to backup {args.backup}")


if __name__ == "__main__":
    main()
