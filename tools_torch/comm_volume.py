#!/usr/bin/env python3
"""Communication volume of the port's mesh LCC superstep across mesh
sizes: the counterpart of ``tools/comm_volume.py``.

The three exchanges of a superstep move index lists built at the engine's
construction, so their volume is exact on any device:
``ShardedLccEngine.comm_stats`` records, per shard, the useful entries of
each exchange (split intra-/cross-shard), the wire sizes and the cut
edges. For each scale and mesh size this prints the JAX tool's row: the
busiest shard's useful cross and intra entries of each exchange, its wire
entries and bytes per entry, the cut edges and their share, the cross and
wire bytes per shard and superstep, and ``per_device_elems``.

    python3 tools_torch/comm_volume.py --scales 17 --devices 1,2,4 --shards
    python3 tools_torch/comm_volume.py --scales 11 --devices 1,2 --device cpu

``--devices`` lists the mesh sizes: n cards, one shard each (a size with
fewer cards visible is skipped), or, with ``--shards`` (and always on the
CPU), n shards of the one device. Writes the rows as JSON to ``--out``
(default ``.bench_cache/comm_volume_torch.json``), stamped with the card's
name and power limit, the commit, a hash of the sources and the time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine  # noqa: E402
from tools_torch.common import CACHE, device_of, log, stamp  # noqa: E402
from tools_torch.scaling_bench import mesh_of, rmat_graph  # noqa: E402

EXCHANGES = ("tv_halo", "alive_halo", "partial_or")


def volume_row(eng: ShardedLccEngine, scale: int) -> dict:
    """The JAX tool's row for one engine."""
    cs = eng.comm_stats
    row = {
        "scale": scale,
        "V": int(eng.num_vertices),
        "E": int(eng.graph.num_edges),
        "n": eng.n,
        "per_device_elems": int(eng.per_device_elems()),
    }
    cross_bytes = wire_bytes = 0
    for name in EXCHANGES:
        st = cs[name]
        d = st.get("directions", 1)
        cross = int(np.max(st["useful_cross"])) * d
        intra = int(np.max(st["useful_intra"])) * d
        wire = st["wire_entries_per_device"] * d
        row[name] = {
            "useful_cross_max_per_device": cross,
            "useful_intra_max_per_device": intra,
            "wire_entries_per_device": wire,
            "bytes_per_entry": st["entry_bytes"],
        }
        cross_bytes += cross * st["entry_bytes"]
        wire_bytes += wire * st["entry_bytes"]
    cut = int(cs["cut_edges"].sum())
    row["cut_edges_total"] = cut
    row["cut_fraction"] = cut / max(row["E"], 1)
    row["cross_bytes_max_per_device_per_superstep"] = cross_bytes
    row["wire_bytes_per_device_per_superstep"] = wire_bytes
    return row


def volumes(scales, ns, dev, shards: bool) -> list[dict]:
    pattern, _ = bench_torch.load_corpus()
    rows = []
    for scale in scales:
        g, labels = rmat_graph(scale)
        for n in ns:
            mesh = mesh_of(n, dev, shards)
            if mesh is None:
                log(f"s{scale} n={n}: skipped (not enough devices)")
                continue
            row = volume_row(ShardedLccEngine(g, labels, pattern, mesh=mesh), scale)
            rows.append(row)
            log(f"s{scale} n={n}: cut={row['cut_fraction']:.3f} "
                f"cross={row['cross_bytes_max_per_device_per_superstep'] / 1e6:.2f}MB/dev/step "
                f"wire={row['wire_bytes_per_device_per_superstep'] / 1e6:.2f}MB "
                f"elems/dev={row['per_device_elems']}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scales", default="14,15,16,17")
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--shards", action="store_true",
                    help="the sizes are shards of the one card, not cards")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(CACHE, "comm_volume_torch.json"))
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    rows = volumes([int(s) for s in args.scales.split(",")],
                   [int(x) for x in args.devices.split(",")], dev, args.shards)
    out = {
        "metric": "per-shard communication volume of the mesh LCC superstep (useful "
                  "entries of the three exchanges, from the engine's exchange lists)",
        "rows": rows,
        **stamp(dev),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if rows:
        print(json.dumps(rows[-1], indent=1), flush=True)
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
