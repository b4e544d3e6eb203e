#!/usr/bin/env python3
"""Where the time of the port's init superstep goes: the counterpart of
``tools/init_decompose.py``.

The benchmark search's only superstep over the whole graph is the
bucketed engine's global init superstep (``engine/lcc_bucketed.py``
``_superstep(init=True)``), on the card one launch of the fused kernel K1
(``ops/lcc_fused.py`` ``init_superstep``). Its plain twin
(``init_superstep_reference``, the per-bucket torch the engine ran before
the kernel) is what is split: one warm call on the workload of
``bench_torch.py`` (``BENCH_SCALE``, default 21) runs under
``torch.profiler``, each torch call in a profiler range named after the
part of the superstep whose source line (or helper) made it; each
operator's own device time (its own CPU time on the CPU) goes to its
range's part:

  entry gather    tv[seg_rows], the row tv of each segment
  label replay    the neighbours' candidates from their label codes
  acceptance      the row masks (or_over_bits) and the accept test
  row OR          row_or along each ELL row
  segment_or      the split hubs' partial ORs combined per vertex
  keep mask       the keep mask and the new tv of each segment
  exit writes     the new tv and alive written, the live rows spread
  counters        send counts, alive edges, live vertices, died flag
  other           the rest (allocations of the outputs)

The parts sum to the profiled total. Beside them: the engine's superstep
(the kernel on the card) and the twin, each timed alone (device
synchronised, each of ``--reps`` calls and the best), the bytes
bound (``tools_torch.common.superstep_bytes(init=True)`` over the card's
3.35 TB/s), and the post-init read timed apart (``alive_pairs``: a device
nonzero over the alive slots and a sort of their keys, then the download).

    python3 tools_torch/init_decompose.py                 # on the card
    BENCH_SCALE=12 python3 tools_torch/init_decompose.py --device cpu

Writes JSON to ``--out`` (default ``.bench_cache/init_decompose_s<scale>.json``),
stamped with the card's name and power limit, the commit, a hash of the
sources and the time.
"""

from __future__ import annotations

import argparse
import json
import linecache
import os
import re
import sys

import torch
from torch.autograd import DeviceType
from torch.overrides import TorchFunctionMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from fuzzypatternmatching_tpu_torch.engine import lcc_bucketed  # noqa: E402
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine  # noqa: E402
from fuzzypatternmatching_tpu_torch.ops import lcc_fused, lcc_superstep  # noqa: E402
from tools_torch.common import (  # noqa: E402
    CACHE,
    HBM_BYTES_PER_MS,
    clock,
    device_of,
    log,
    stamp,
    superstep_bytes,
)

PARTS = ("entry gather", "label replay", "acceptance", "row OR", "segment_or",
         "keep mask", "exit writes", "counters", "other")
# the helper a frame runs in, where the helper is the part
BY_FUNCTION = {
    "or_over_bits": "acceptance",
    "row_or": "row OR",
    "segment_or": "segment_or",
    "keep_mask_per_i": "keep mask",
}
# a line of _superstep itself, by what it computes
BY_LINE = (
    ("entry gather", re.compile(r"tv\[d\.seg_rows\]")),
    ("label replay", re.compile(r"code_tv\[")),
    ("counters", re.compile(r"send_?ok|ae_rows|died = |av \+=|ae \+=|msg \+=|index_add_|stats = ")),
    ("acceptance", re.compile(r"accept = |torch\.where\(accept|adj_mask_rows = ")),
    ("keep mask", re.compile(r"new_tv_seg = |in_map = |died_b = ")),
    ("exit writes", re.compile(r"new_alive|new_tv\[|row_live|live_seg = ")),
)
SOURCES = {os.path.abspath(m.__file__) for m in (lcc_bucketed, lcc_fused, lcc_superstep)}
LABEL = "init part: "


def part_of_caller() -> str:
    """The part of the superstep that the running torch call belongs to,
    from the innermost frame of the stack in the engine's sources."""
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if os.path.abspath(code.co_filename) in SOURCES:
            if code.co_name in BY_FUNCTION:
                return BY_FUNCTION[code.co_name]
            if code.co_name == "_superstep_reference":
                text = linecache.getline(code.co_filename, frame.f_lineno)
                for part, pattern in BY_LINE:
                    if pattern.search(text):
                        return part
                return "other"
        frame = frame.f_back
    return "other"


class _LabelParts(TorchFunctionMode):
    """Wraps each torch call in a profiler range named after its part."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        with torch.profiler.record_function(LABEL + part_of_caller()):
            return func(*args, **(kwargs or {}))


def plain_init(lcc: BucketedLccEngine):
    """The plain twin of the engine's init superstep."""
    return lcc_fused.init_superstep_reference(lcc._planes, lcc.label_tv, lcc._tmpl)


def profile_split(lcc: BucketedLccEngine) -> tuple[dict, float]:
    """({part: ms}, window wall ms) of one warm plain init superstep: each
    operator's own device time (CPU time on the CPU) under its part's
    range."""
    dev = lcc.device
    step = lambda: plain_init(lcc)  # noqa: E731
    step()
    clock(dev)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = clock(dev)
        with _LabelParts():
            step()
        wall_ms = (clock(dev) - t0) * 1e3
    ms = dict.fromkeys(PARTS, 0.0)
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or evt.name.startswith(LABEL):
            # a kernel's own event (its time is its operator's too), or the
            # range itself, whose operators carry the time
            continue
        us = evt.self_device_time_total if dev.type == "cuda" else evt.self_cpu_time_total
        if us <= 0:
            continue
        parent = evt.cpu_parent
        while parent is not None and not parent.name.startswith(LABEL):
            parent = parent.cpu_parent
        ms["other" if parent is None else parent.name[len(LABEL):]] += us / 1e3
    if sum(ms.values()) == ms["other"]:
        raise RuntimeError("no operator of the superstep was attributed to a part")
    return ms, wall_ms


def time_init(lcc: BucketedLccEngine, reps: int, plain: bool = False) -> list[float]:
    """Milliseconds of each of ``reps`` init supersteps, each synchronised:
    the engine's (``plain``: the twin's)."""
    dev = lcc.device
    state = lcc.init_state()
    out = []
    for _ in range(reps + 1):
        t0 = clock(dev)
        if plain:
            plain_init(lcc)
        else:
            lcc._superstep(lcc.label_tv, state.alive, state.tp_flag, init=True)
        out.append((clock(dev) - t0) * 1e3)
    return out[1:]  # the first is a warm-up


def time_alive_pairs(lcc: BucketedLccEngine, reps: int) -> tuple[list[float], int]:
    """(ms of each ``alive_pairs`` of the post-init state, alive pairs)."""
    dev = lcc.device
    state, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    out = []
    for _ in range(reps + 1):
        state.pairs_cache = None
        t0 = clock(dev)
        rows, _ = lcc.alive_pairs(state)
        out.append((clock(dev) - t0) * 1e3)
    return out[1:], len(rows)


def decompose(lcc: BucketedLccEngine, reps: int = 5) -> dict:
    ms, wall_ms = profile_split(lcc)
    total = sum(ms.values())
    times = time_init(lcc, reps)
    plain = time_init(lcc, reps, plain=True)
    nbytes = superstep_bytes(lcc, init=True)
    pairs_ms, n_pairs = time_alive_pairs(lcc, reps)
    return {
        "parts_ms": ms,
        "profiled_total_ms": total,
        "profiled_wall_ms": wall_ms,
        "superstep_ms": times,
        "superstep_best_ms": min(times),
        "plain_ms": plain,
        "plain_best_ms": min(plain),
        "bound_bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_MS,
        "alive_pairs_ms": pairs_ms,
        "alive_pairs_best_ms": min(pairs_ms),
        "alive_pairs": n_pairs,
        "slots": lcc.num_slots,
        "buckets": len(lcc.buckets),
        "time_kind": "device" if lcc.device.type == "cuda" else "cpu",
    }


def print_decomposition(rec: dict) -> None:
    total = rec["profiled_total_ms"]
    for part, ms in rec["parts_ms"].items():
        share = 100 * ms / total if total else 0.0
        print(f"  {part:<13} {ms:10.4f} ms  {share:5.1f} %", flush=True)
    print(f"  {'total':<13} {total:10.4f} ms ({rec['time_kind']} time; the profiled "
          f"window {rec['profiled_wall_ms']:.4f} ms on the host clock)", flush=True)
    print(f"init superstep alone: best {rec['superstep_best_ms']:.4f} ms of "
          f"{[round(x, 4) for x in rec['superstep_ms']]} (the plain twin: best "
          f"{rec['plain_best_ms']:.4f} ms of {[round(x, 4) for x in rec['plain_ms']]}); bytes "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_bytes']} B over "
          f"{HBM_BYTES_PER_MS:.3g} B/ms)", flush=True)
    print(f"post-init read (alive_pairs, {rec['alive_pairs']} pairs): best "
          f"{rec['alive_pairs_best_ms']:.4f} ms of "
          f"{[round(x, 4) for x in rec['alive_pairs_ms']]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    scale = int(os.environ.get("BENCH_SCALE", "21"))
    g, labels = bench_torch.build_or_load_graph(scale)
    pattern, _ = bench_torch.load_corpus()
    log(f"building the bucketed engine (s{scale}, {dev})...")
    lcc = BucketedLccEngine(g, labels, pattern, device=dev)
    rec = {"scale": scale, **decompose(lcc, args.reps), **stamp(dev)}
    print(f"bucketed init superstep (its plain twin by part), R-MAT s{scale}, {rec['card']}:",
          flush=True)
    print_decomposition(rec)
    out = args.out or os.path.join(CACHE, f"init_decompose_s{scale}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
