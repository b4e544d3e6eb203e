"""Attach per-edge metadata to an existing graph DB — the
src/build_edge_metadata_partitions.cpp equivalent (the port's own copy of
``fuzzypatternmatching_tpu/cli/build_edge_metadata.py``; the same DB).

Reads 3-column edge files (``src dst data``), matches entries against the
stored CSR (duplicates collapse, last write wins), and rewrites the shard
files with an ``edge_data`` array (reference: edge_data_db.hpp).

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.build_edge_metadata \\
      -i <graph_db> [-u] file1 file2 ...
"""

from __future__ import annotations

import argparse

import numpy as np

from ..generators.edge_list import read_edge_lists
from ..graph import storage


def main(argv=None):
    ap = argparse.ArgumentParser(description="attach edge metadata to a graph DB")
    ap.add_argument("-i", "--input", required=True, help="graph DB directory")
    ap.add_argument("-u", "--undirected", action="store_true",
                    help="apply each entry to both directions")
    ap.add_argument("files", nargs="+")
    args = ap.parse_args(argv)

    g, labels, _ = storage.load(args.input)
    src, dst, data = read_edge_lists(args.files, undirected=args.undirected)
    if data is None:
        raise SystemExit("edge files must have a third (data) column")

    keys = g.edge_row.astype(np.uint64) * np.uint64(g.num_vertices) + g.cols.astype(
        np.uint64
    )
    want = src.astype(np.uint64) * np.uint64(g.num_vertices) + dst.astype(np.uint64)
    pos = np.searchsorted(keys, want)
    pos_c = np.minimum(pos, len(keys) - 1)
    ok = keys[pos_c] == want
    edge_data = np.zeros(g.num_edges, dtype=np.int64)
    edge_data[pos_c[ok]] = data[ok]
    matched = int(ok.sum())
    print(f"matched {matched}/{len(want)} metadata entries to edge slots")

    import json
    import os

    with open(os.path.join(args.input, "meta.json")) as f:
        shards = json.load(f)["num_shards"]
    storage.save(g, args.input, num_shards=shards, labels=labels,
                 edge_data=edge_data)
    print(f"rewrote {args.input} with edge metadata")


if __name__ == "__main__":
    main()
