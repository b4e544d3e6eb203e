"""Multi-process command-line flags and the device mesh — the
environment.hpp plumbing.

The port of ``fuzzypatternmatching_tpu/utils/dist.py``:

* ``add_distributed_args``: the same four flags. The graph build CLIs
  (``generate_rmat``, ``ingest_edge_list``) read ``--num-processes`` and
  ``--process-id`` and exchange through the shared output directory with
  file barriers (``graph/build.py``); they start no process group.
* ``init_distributed``: a multi-process search (``--distributed``, one
  process per card joined by ``torch.distributed``) is not ported; it
  raises.
* ``build_mesh``: the 1-D mesh of the multi-device plane
  (``parallel/mesh.py``), in this one process: one shard per visible CUDA
  device, or ``shards`` shards on one device. The JAX package's 2-D
  ("host", "chip") mesh has no caller in the port.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Mesh


def add_distributed_args(ap) -> None:
    g = ap.add_argument_group("distributed (multi-host)")
    g.add_argument(
        "--distributed", action="store_true",
        help="multi-process / multi-host run (scripts/"
             "launch_multiprocess.py appends it)",
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


def init_distributed(args) -> None:
    """Join a multi-process run. Single-process runs skip it; a
    multi-process search is not ported."""
    if getattr(args, "distributed", False):
        raise NotImplementedError(
            "--distributed: multi-process runs are not ported (the mesh "
            "runs its shards in one process)"
        )


def build_mesh(
    num_devices: int | None = None, shards: int | None = None,
    device: torch.device | str = "cuda",
) -> Mesh:
    """The graph-partition mesh. By default one shard per visible CUDA
    device (the first ``num_devices`` of them); with ``shards``, that many
    shards on the one ``device``. ``device="cpu"`` puts every shard on the
    CPU (one shard unless ``shards`` says more)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available")
    if shards is not None:
        if shards < 1:
            raise ValueError(f"shards={shards}: need at least one")
        return Mesh([dev] * shards)
    if dev.type != "cuda":
        return Mesh([dev] * (num_devices or 1))
    count = torch.cuda.device_count()
    n = count if num_devices is None else num_devices
    if not 1 <= n <= count:
        raise ValueError(f"num_devices={num_devices}: {count} CUDA devices are visible")
    return Mesh([torch.device("cuda", i) for i in range(n)])
