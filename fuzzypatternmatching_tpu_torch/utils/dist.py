"""Multi-process command-line flags — the environment.hpp plumbing.

The port's own copy of ``add_distributed_args`` from
``fuzzypatternmatching_tpu/utils/dist.py``: the same four flags. The graph
build CLIs (``generate_rmat``, ``ingest_edge_list``) read
``--num-processes`` and ``--process-id`` and exchange through the shared
output directory with file barriers (``graph/build.py``); they start no
process group. Starting one, and the device mesh, belong to the
multi-device plane, which the port does not have yet.
"""

from __future__ import annotations


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
