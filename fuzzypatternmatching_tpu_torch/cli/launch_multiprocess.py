"""Multi-process launcher: run one command in N local processes joined by
``torch.distributed`` (the port of ``scripts/launch_multiprocess.py``, the
counterpart of the reference's cluster scripts, which srun the MPI
binaries).

Every process runs the command with the distributed flags appended
(``--distributed --coordinator 127.0.0.1:<free port> --num-processes N
--process-id i``, the flags of ``utils/dist.add_distributed_args``).
Every process runs on this host, so each gets ``LOCAL_RANK`` (its id) and
``LOCAL_WORLD_SIZE`` (N), from which ``utils/dist.placement`` picks its
card and backend: one process per card over NCCL while N is no more than
the visible cards, else processes sharing cards over gloo.
``--devices-per-proc M`` sets ``FPM_VIRTUAL_CPU_DEVICES=M`` in each
process: its mesh then holds M CPU shards (``utils/dist.build_mesh``), and
the processes join over gloo. When a process exits with an error, the
launcher stops the others (which would wait in a collective) and exits
with that process's code.

Examples:

  # 2 processes x 4 CPU shards = one 8-shard mesh
  python -m fuzzypatternmatching_tpu_torch.cli.launch_multiprocess -n 2 \\
      --devices-per-proc 4 -- \\
      python -m fuzzypatternmatching_tpu_torch.cli.sharded_lcc_demo

  # the graph build, 2 processes exchanging through the output directory
  python -m fuzzypatternmatching_tpu_torch.cli.launch_multiprocess -n 2 -- \\
      python -m fuzzypatternmatching_tpu_torch.cli.generate_rmat \\
      -s 12 -p 4 -o /tmp/db
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(cmd: list[str], num_processes: int, devices_per_proc: int | None = None,
        coordinator: str | None = None) -> int:
    """Run ``cmd`` in ``num_processes`` processes with the distributed
    flags appended; 0 when every process exits with 0, else the first
    failing process's code."""
    coord = coordinator or f"127.0.0.1:{free_port()}"
    procs = []
    for pid in range(num_processes):
        penv = dict(os.environ, LOCAL_RANK=str(pid), LOCAL_WORLD_SIZE=str(num_processes))
        if devices_per_proc:
            penv["FPM_VIRTUAL_CPU_DEVICES"] = str(devices_per_proc)
        full = cmd + [
            "--distributed", "--coordinator", coord,
            "--num-processes", str(num_processes),
            "--process-id", str(pid),
        ]
        procs.append(subprocess.Popen(full, env=penv))
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [(i, p.returncode) for i, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed:
                pid, rc = failed[0]
                print(f"process {pid} exited with {rc}; stopping the others",
                      file=sys.stderr, flush=True)
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    for pid, p in enumerate(procs):
        if p.returncode != 0 and rc == 0:
            print(f"process {pid} exited with {p.returncode}", file=sys.stderr)
            rc = p.returncode
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="spawn an N-process torch.distributed run"
    )
    ap.add_argument("-n", "--num-processes", type=int, required=True)
    ap.add_argument(
        "--devices-per-proc", type=int, default=None,
        help="this many CPU shards per process (FPM_VIRTUAL_CPU_DEVICES; "
             "omit on cards)",
    )
    ap.add_argument(
        "--coordinator", default=None,
        help="host:port (default: 127.0.0.1:<free port> for local runs)",
    )
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to run in every process (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (append it after --)")
    if args.num_processes < 1:
        ap.error("--num-processes must be at least 1")
    return run(cmd, args.num_processes, args.devices_per_proc, args.coordinator)


if __name__ == "__main__":
    sys.exit(main())
