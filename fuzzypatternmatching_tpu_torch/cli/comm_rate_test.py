"""Collective rate test over the mesh — the mailbox rate test analog.

The port of ``fuzzypatternmatching_tpu/cli/comm_rate_test.py`` (the
reference's src/mailbox_rate_test.cpp): the time of one all-gather of
per-shard state plus a sum over the mesh (the termination counters'
collective), and the bytes each shard receives per second. The mesh is
``utils/dist.build_mesh``: one shard per visible CUDA device, or
``--shards N`` on one device. Shards that share a device exchange through
that device's memory.

Usage:
  python -m fuzzypatternmatching_tpu_torch.cli.comm_rate_test [-n bytes] [-i iters]
      [--shards N] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..utils.dist import build_mesh


def _sync(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description="collective rate test (torch)")
    ap.add_argument("-n", "--bytes", type=int, default=1 << 22,
                    help="payload bytes per device")
    ap.add_argument("-i", "--iters", type=int, default=20)
    ap.add_argument("--shards", type=int, default=None,
                    help="this many shards on the one --device (default: one "
                         "shard per visible CUDA device)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    mesh = build_mesh(shards=args.shards, device=args.device)
    n = mesh.n
    per_dev = args.bytes // 4
    x = [torch.zeros(per_dev, dtype=torch.float32, device=d) for d in mesh.devices]

    def gather_and_sum():
        full = mesh.all_gather(x)
        return mesh.psum([f.sum().view(1) for f in full])

    gather_and_sum()  # warm up
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = gather_and_sum()
    _sync(mesh)
    dt = (time.perf_counter() - t0) / args.iters
    del out
    moved = args.bytes * (n - 1)  # bytes received per device per all_gather
    print(
        f"devices={n} payload={args.bytes/2**20:.1f}MiB/dev "
        f"all_gather+psum latency={dt*1e3:.2f}ms "
        f"bw={moved/dt/2**30:.2f}GiB/s/dev"
    )


if __name__ == "__main__":
    main()
