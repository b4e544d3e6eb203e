#!/usr/bin/env python3
"""Scaling of the port's mesh LCC superstep across mesh sizes: the
counterpart of ``tools/scaling_bench.py``.

The sharded engine's non-init superstep time at each mesh size n on the
same graph (R-MAT at ``--scale``, degree labels, the tree corpus), with
the speedup and parallel efficiency against the first n. ``-d/--devices``
lists the sizes: n cards, one shard each (an n with fewer cards visible is
skipped, as the JAX tool does), or, with ``--shards``, n shards of the one
card, which measures the mesh plane's per-shard overhead rather than a
speedup. On the CPU (``--device cpu``) every shard is a CPU shard: a check
of the harness, not a measurement of the card.

    python3 tools_torch/scaling_bench.py -s 17 -d 1,2,4 --shards
    python3 tools_torch/scaling_bench.py -s 11 -d 1,2 --device cpu

Each size: one ``lcc_call`` from the init state (warm-up), then
``--iters`` non-init calls from its result, the device synchronised
around them; the time per superstep. Writes the rows as JSON to ``--out``
(default ``.bench_cache/scaling_torch_s<scale>.json``), stamped with the
card's name and power limit, the commit, a hash of the sources and the
time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from fuzzypatternmatching_tpu_torch.generators.rmat import rmat_all_ranks  # noqa: E402
from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges  # noqa: E402
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine  # noqa: E402
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh  # noqa: E402
from tools_torch.common import CACHE, device_of, stamp, sync  # noqa: E402


def rmat_graph(scale: int):
    """(graph, labels) of the 4-rank R-MAT stream, scrambled from s17 (the
    scramble's hash needs it), as the JAX tools build it."""
    src, dst = rmat_all_ranks(scale=scale, n_ranks=4, scramble=scale >= 17)
    g = from_edges(src, dst, num_vertices=1 << scale)
    return g, degree_labels(g)


def mesh_of(n: int, dev: torch.device, shards: bool):
    """n shards of ``dev`` (always on the CPU), or one shard on each of n
    cards; None where fewer cards are visible."""
    if shards or dev.type == "cpu":
        return build_mesh(shards=n, device=dev)
    if n > torch.cuda.device_count():
        return None
    return build_mesh(n)


def mesh_clock(mesh) -> float:
    for d in set(mesh.devices):
        sync(d)
    return time.perf_counter()


def scaling(g, labels, ns, iters: int, dev: torch.device, shards: bool) -> list[dict]:
    pattern, _ = bench_torch.load_corpus()
    rows, base = [], None
    for n in ns:
        mesh = mesh_of(n, dev, shards)
        if mesh is None:
            print(f"n={n}: skipped (not enough devices)", flush=True)
            continue
        eng = ShardedLccEngine(g, labels, pattern, mesh=mesh)
        st, _, _ = eng.lcc_call(eng.init_state(), True)  # warm-up
        t0 = mesh_clock(mesh)
        for _ in range(iters):
            _, steps, _ = eng.lcc_call(st, False)
        dt = (mesh_clock(mesh) - t0) / iters / max(len(steps), 1)
        base = dt if base is None else base
        row = {"n": n, "ms_per_superstep": dt * 1e3, "supersteps_per_call": len(steps),
               "speedup": base / dt, "efficiency": base / (dt * n),
               "per_device_elems": int(eng.per_device_elems())}
        rows.append(row)
        print(f"n={n}: {row['ms_per_superstep']:.2f} ms/superstep  "
              f"speedup={row['speedup']:.2f}x  efficiency={100 * row['efficiency']:.0f}%",
              flush=True)
        del eng
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-s", "--scale", type=int, default=14)
    ap.add_argument("-d", "--devices", default="1,2,4,8")
    ap.add_argument("-i", "--iters", type=int, default=3)
    ap.add_argument("--shards", action="store_true",
                    help="the sizes are shards of the one card, not cards")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    g, labels = rmat_graph(args.scale)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 0
    print(f"graph: V={g.num_vertices} E={g.num_edges} devices available: {visible}", flush=True)
    rows = scaling(g, labels, [int(x) for x in args.devices.split(",")], args.iters, dev,
                   args.shards)
    out = args.out or os.path.join(CACHE, f"scaling_torch_s{args.scale}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"scale": args.scale, "shards_of_one_device": args.shards or dev.type == "cpu",
                   "rows": rows, **stamp(dev)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
