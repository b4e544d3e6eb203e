"""Classic-algorithm drivers on the torch engine (the reference's
src/run_bfs.cpp, run_cc.cpp, run_page_rank.cpp, run_kth_core.cpp,
run_triangle_count.cpp): the port of ``fuzzypatternmatching_tpu/cli/
run_algorithms.py``, with the same flags and lines plus ``--device``.

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms bfs -i <db> -s 0
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms cc -i <db>
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms pagerank -i <db>
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms kcore -i <db> -k 2
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms sssp -i <db> -s 0
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms triangles -i <db>
  python -m fuzzypatternmatching_tpu_torch.cli.run_algorithms fuzzywalk -i <db> \\
      --walk-labels 1,2,1

``--device cuda`` (the default) requires a CUDA card; there is no fallback
to the CPU. ``--sharded`` (the multi-device plane) is not ported and exits
with an error.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..algorithms import frontier
from ..graph import storage


def main(argv=None):
    ap = argparse.ArgumentParser(description="classic graph algorithms (torch)")
    ap.add_argument("algo", choices=["bfs", "cc", "pagerank", "kcore", "sssp",
                                     "triangles", "fuzzywalk"])
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-s", "--source", type=int, default=0)
    ap.add_argument("-k", type=int, default=2)
    ap.add_argument("--damping", type=float, default=0.85)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--walk-labels", default=None,
                    help="fuzzywalk: comma-separated label sequence "
                         "(run_fuzzy_pattern_matching.cpp pattern)")
    ap.add_argument("--walk-indices", default=None,
                    help="fuzzywalk: comma-separated history indices "
                         "(default 0,1,..,len-1 = all-distinct walk)")
    ap.add_argument("-o", "--output", default=None, help="write results here")
    ap.add_argument("--sharded", action="store_true",
                    help="run distributed over all visible devices (not "
                         "ported: exits with an error)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.sharded:
        ap.error("--sharded: the multi-device plane is not ported")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    g, stored_labels, edge_data = storage.load(args.input)
    print(f"opened graph: V={g.num_vertices} E={g.num_edges}")
    dev = args.device
    t0 = time.time()
    out = None
    if args.algo == "bfs":
        level, parent = frontier.breadth_first_search(g, args.source, device=dev)
        reached = int(np.sum(level < 2**31 - 1))
        print(f"bfs from {args.source}: visited {reached} vertices, "
              f"max level {int(level[level < 2**31 - 1].max())}")
        out = np.stack([level, parent], axis=1)
    elif args.algo == "cc":
        comp = frontier.connected_components(g, device=dev)
        print(f"components: {len(np.unique(comp))}")
        out = comp
    elif args.algo == "pagerank":
        pr = frontier.pagerank(g, args.damping, args.iterations, device=dev)
        top = np.argsort(pr)[-5:][::-1]
        print("top-5 pagerank:", [(int(v), float(pr[v])) for v in top])
        out = pr
    elif args.algo == "kcore":
        alive = frontier.kth_core(g, args.k, device=dev)
        print(f"{args.k}-core size: {int(alive.sum())}")
        out = alive
    elif args.algo == "sssp":
        w = edge_data.astype(np.float64) if edge_data is not None else np.ones(g.num_edges)
        dist = frontier.sssp(g, args.source, w, device=dev)
        print(f"sssp from {args.source}: reached {int(np.isfinite(dist).sum())}")
        out = dist
    elif args.algo == "triangles":
        print(f"triangles: {frontier.triangle_count(g, device=dev)}")
    elif args.algo == "fuzzywalk":
        from ..algorithms.fuzzy_walk import fuzzy_walk_ranks
        from ..graph.csr import degree_labels

        if args.walk_labels is None:
            ap.error("fuzzywalk requires --walk-labels")
        wl = np.array([int(x) for x in args.walk_labels.split(",")],
                      dtype=np.uint64)
        wi = (np.array([int(x) for x in args.walk_indices.split(",")])
              if args.walk_indices else np.arange(len(wl)))
        labels = stored_labels if stored_labels is not None else degree_labels(g)
        rank = fuzzy_walk_ranks(g, labels, wl, wi)
        nz = np.nonzero(rank)[0]
        print(f"fuzzywalk: {len(nz)} ranked vertices, total rank {int(rank.sum())}")
        out = rank
    print(f"time: {time.time()-t0:.2f}s")
    if args.output is not None and out is not None:
        np.save(args.output, out)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
