"""Copy a graph DB between storage locations — src/transfer_graph.cpp (the
port's own copy of ``fuzzypatternmatching_tpu/cli/transfer_graph.py``).

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.transfer_graph <src_db> <dst_db>
"""

from __future__ import annotations

import argparse

from ..graph import storage


def main(argv=None):
    ap = argparse.ArgumentParser(description="graph DB transfer")
    ap.add_argument("src")
    ap.add_argument("dst")
    args = ap.parse_args(argv)
    storage.transfer(args.src, args.dst)
    print(f"transferred {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
