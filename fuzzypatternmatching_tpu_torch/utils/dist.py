"""Multi-process command-line flags and the device mesh — the
environment.hpp plumbing.

The port of ``fuzzypatternmatching_tpu/utils/dist.py``:

* ``add_distributed_args``: the same four flags. The graph build CLIs
  (``generate_rmat``, ``ingest_edge_list``) read ``--num-processes`` and
  ``--process-id`` and exchange through the shared output directory with
  file barriers (``graph/build.py``); they start no process group.
* ``init_distributed``: joins a multi-process run (``--distributed``, which
  ``cli/launch_multiprocess.py`` appends with the other three flags):
  ``torch.distributed.init_process_group`` over the coordinator's address,
  with the process count and id given. ``placement`` derives the backend
  and the process's card from where the shards live: gloo for CPU shards
  and for processes that share a card (more processes on the host than
  cards), NCCL for one process per card.
* ``build_mesh``: the 1-D mesh of the multi-device plane
  (``parallel/mesh.py``). In one process: one shard per visible CUDA
  device, or ``shards`` shards on one device. Once a process group is up,
  the mesh spans its processes, host-major: each process adds its CPU
  shards (``shards``, or ``FPM_VIRTUAL_CPU_DEVICES``, the variable the
  launcher's ``--devices-per-proc`` sets), ``shards`` shards of its card,
  or one shard on its own card. ``two_d=True`` labels the same shards as
  the JAX package's ("host", "chip") grid.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from ..parallel.mesh import Mesh


def print_line(text: str) -> None:
    """Write ``text`` and its newline to stdout in one ``write``. Processes
    that share one pipe (the launcher's) then never split each other's
    lines; ``print`` with unbuffered stdout writes each piece apart."""
    sys.stdout.write(text + "\n")
    sys.stdout.flush()


def add_distributed_args(ap) -> None:
    g = ap.add_argument_group("distributed (multi-host)")
    g.add_argument(
        "--distributed", action="store_true",
        help="multi-process / multi-host run (cli/launch_multiprocess.py "
             "appends it)",
    )
    g.add_argument(
        "--coordinator", default=None,
        help="coordinator address host:port",
    )
    g.add_argument(
        "--num-processes", type=int, default=None,
        help="total process count (default: 1)",
    )
    g.add_argument(
        "--process-id", type=int, default=None,
        help="this process's id (default: 0)",
    )


def cpu_shards_from_env() -> int | None:
    """The shard count ``FPM_VIRTUAL_CPU_DEVICES`` asks of this process
    (the launcher's ``--devices-per-proc``), or None."""
    n = os.environ.get("FPM_VIRTUAL_CPU_DEVICES")
    return int(n) if n else None


def local_processes(args) -> tuple[int, int]:
    """This process's index among the run's processes on its host, and
    their count: ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` where the launcher
    sets them (``cli/launch_multiprocess.py`` does, as torchrun does), else
    every process of the run on this host."""
    size = os.environ.get("LOCAL_WORLD_SIZE")
    if size is not None:
        return int(os.environ["LOCAL_RANK"]), int(size)
    return args.process_id, args.num_processes


def placement(device: torch.device | str, local_rank: int, local_size: int,
              cards: int) -> tuple[str, int | None]:
    """The process group's backend and this process's card, from where the
    shards live. CPU shards: gloo, no card. With no more processes on the
    host than ``cards``, one process per card: NCCL, process i on card i.
    With more, processes share cards, consecutive processes on one card:
    gloo (NCCL refuses two processes on one card)."""
    if torch.device(device).type == "cpu":
        return "gloo", None
    if cards < 1:
        raise RuntimeError(f"device {device}: no CUDA device is available")
    if local_size <= cards:
        return "nccl", local_rank
    return "gloo", local_rank * cards // local_size


def init_distributed(args, device: torch.device | str = "cuda") -> str | None:
    """havoqgt_init analog: with ``--distributed``, join the process group
    of ``--num-processes`` processes at ``--coordinator`` as process
    ``--process-id``, for shards on ``device`` ("cuda" or "cpu"): the
    backend and, on cards, the current card are ``placement``'s. Returns
    the backend; single-process runs skip it and return None."""
    if not getattr(args, "distributed", False):
        return None
    if args.coordinator is None or args.num_processes is None or args.process_id is None:
        raise ValueError("--distributed needs --coordinator, --num-processes and --process-id")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device}: not cpu or cuda")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, card = placement(dev, *local_processes(args), cards)
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(
        backend, init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes, rank=args.process_id,
    )
    return backend


def build_mesh(
    num_devices: int | None = None, two_d: bool = False, *,
    shards: int | None = None, device: torch.device | str = "cuda",
) -> Mesh:
    """The graph-partition mesh. By default one shard per visible CUDA
    device (the first ``num_devices`` of them); with ``shards``, that many
    shards on the one ``device``. The positional parameters are the JAX
    ``build_mesh``'s; ``shards`` and ``device`` are keyword-only. ``device="cpu"`` puts every shard on the
    CPU (``shards``, ``num_devices``, ``FPM_VIRTUAL_CPU_DEVICES`` or one).
    Once ``init_distributed`` has joined a group of several processes, the
    shards built here are this process's part of a mesh across all of
    them: ``shards`` (or ``FPM_VIRTUAL_CPU_DEVICES``) CPU shards or shards
    of the card ``init_distributed`` made current, else one shard on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available")
    if shards is not None and shards < 1:
        raise ValueError(f"shards={shards}: need at least one")
    if dev.type == "cpu" and shards is None:
        shards = num_devices or cpu_shards_from_env() or 1
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh([dev] * (shards or 1), group=dist.group.WORLD, two_d=two_d)
    if shards is not None:
        return Mesh([dev] * shards, two_d=two_d)
    count = torch.cuda.device_count()
    n = count if num_devices is None else num_devices
    if not 1 <= n <= count:
        raise ValueError(f"num_devices={num_devices}: {count} CUDA devices are visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], two_d=two_d)
