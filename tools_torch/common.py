"""What the port's measurement scripts share: the device check, the stamp
every record carries (the card's name and power limit, the commit and a
hash of the sources, the time), a device-synchronising clock and the bytes
bound of one superstep.

Imports only the port and the standard library: the card's machine has no
JAX.
"""

from __future__ import annotations

import datetime
import glob
import hashlib
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# graphs and default outputs of the scripts (gitignored)
CACHE = os.path.join(REPO, ".bench_cache")
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_of(name: str) -> torch.device:
    """The device a script measures on. ``cuda`` needs a card: there is no
    fallback to the CPU, which is used only when asked for."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name}: not cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name}: no CUDA device is available (pass --device cpu "
                           "to run on the CPU)")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clock(dev: torch.device) -> float:
    """Host seconds after the device has finished its queued work."""
    sync(dev)
    return time.perf_counter()


def card(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


def commit() -> str:
    try:
        return subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"  # a copy of the tree without its history


def source_hash() -> str:
    """The first 12 hex digits of a sha256 over the port's sources and
    scripts: names the code where a copy of the tree has no git history."""
    files = [os.path.join(REPO, "bench_torch.py"), os.path.join(REPO, "chip_smoke.py")]
    for top in ("fuzzypatternmatching_tpu_torch", "tools_torch"):
        for ext in ("py", "cu"):
            files += glob.glob(os.path.join(REPO, top, "**", f"*.{ext}"), recursive=True)
    h = hashlib.sha256()
    for path in sorted(files):
        h.update(os.path.relpath(path, REPO).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def stamp(dev: torch.device) -> dict:
    """What every record carries: where, on what, when, which code."""
    return {
        "device": str(dev),
        "card": card(dev),
        "commit": commit(),
        "source_hash": source_hash(),
        "measured_at": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
    }


def superstep_bytes(lcc, init: bool = False) -> int:
    """Bytes one superstep of a bucketed or flat LCC engine must move: each
    input it reads once (the state, the engine's planes and tables), each
    output written once (tv, alive, the cleared tp_flag). The init
    superstep reads the label tv and each slot's label code in place of
    the state, ``rev`` and the neighbour ids (bucketed engine only)."""
    v = lcc.num_vertices
    if hasattr(lcc, "buckets"):  # bucketed
        n_flags = lcc.num_slots + 1
        planes = [] if init else [lcc._rev_flat]
        tables = [lcc._code_tv] if init else []
        for d in lcc._dev:
            planes += [d.code if init else d.adj, d.seg_id, d.seg_rows]
            planes += [x for x in (d.meta, d.cls) if x is not None]
            if lcc.num_ranks > 1:
                planes += [d.own_rows, d.own_seg]
    else:
        if init:
            raise ValueError("the init superstep's bound is the bucketed engine's")
        n_flags = lcc.num_edges + 1
        planes = [lcc.col, lcc.erow, lcc.rev]
        planes += [x for x in (lcc.col_class, lcc.meta_code) if x is not None]
        if lcc.num_ranks > 1:
            planes += [lcc.owner, lcc.eowner]
        tables = []
    tables += list(lcc.meta_allow or [])
    state = 4 * v if init else 4 * v + 2 * n_flags
    read = state + sum(t.numel() * t.element_size() for t in planes + tables)
    return read + 4 * v + 2 * n_flags
