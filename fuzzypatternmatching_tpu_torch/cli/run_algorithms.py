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
to the CPU. ``--sharded`` runs BFS, CC, PageRank, k-core and SSSP over a
mesh (``algorithms/frontier_sharded.py``): one shard per visible CUDA
device, the first ``--num-devices`` of them (with ``--device cpu``, that
many shards on the CPU). Neither package has a sharded triangle count:
``triangles --sharded`` exits with an error.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..algorithms import frontier, frontier_sharded
from ..graph import storage
from ..utils.dist import build_mesh


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
                    help="run distributed over a mesh of the visible devices "
                         "(algorithms/frontier_sharded.py; the analog of "
                         "the reference's all-rank MPI drivers)")
    ap.add_argument("--num-devices", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.sharded and args.algo == "triangles":
        ap.error("triangles --sharded: there is no sharded triangle count")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")

    g, stored_labels, edge_data = storage.load(args.input)
    print(f"opened graph: V={g.num_vertices} E={g.num_edges}")
    dev = args.device
    if args.sharded:
        algos = frontier_sharded
        mesh = build_mesh(num_devices=args.num_devices, device=dev)
        kw = {"mesh": mesh}
        print(f"sharded over {mesh.n} devices")
    else:
        algos, kw = frontier, {"device": dev}
    t0 = time.time()
    out = None
    if args.algo == "bfs":
        level, parent = algos.breadth_first_search(g, args.source, **kw)
        reached = int(np.sum(level < 2**31 - 1))
        print(f"bfs from {args.source}: visited {reached} vertices, "
              f"max level {int(level[level < 2**31 - 1].max())}")
        out = np.stack([level, parent], axis=1)
    elif args.algo == "cc":
        comp = algos.connected_components(g, **kw)
        print(f"components: {len(np.unique(comp))}")
        out = comp
    elif args.algo == "pagerank":
        pr = algos.pagerank(g, args.damping, args.iterations, **kw)
        top = np.argsort(pr)[-5:][::-1]
        print("top-5 pagerank:", [(int(v), float(pr[v])) for v in top])
        out = pr
    elif args.algo == "kcore":
        alive = algos.kth_core(g, args.k, **kw)
        print(f"{args.k}-core size: {int(alive.sum())}")
        out = alive
    elif args.algo == "sssp":
        w = edge_data.astype(np.float64) if edge_data is not None else np.ones(g.num_edges)
        dist = algos.sssp(g, args.source, w, **kw)
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
