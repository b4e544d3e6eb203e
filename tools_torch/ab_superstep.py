#!/usr/bin/env python3
"""A/B of the bucketed engine's default-mode superstep on one NVIDIA GPU:
this checkout against another, each side in its own processes, in turns
(other, this, this, other).

  python3 tools_torch/ab_superstep.py --other DIR [--scale 21] [--out FILE]

DIR holds another checkout of the repository, for example a parent commit
unpacked with ``git archive <commit> | tar -x -C DIR``. The graph (R-MAT
at ``--scale``, the 4-rank stream of ``bench_torch.py``) is made once here
and handed to each side as .npy files. Each side imports its own
checkout's package and, with degree labels and the tree corpus:

1. runs the tree search with the compact path and with ``compact=False``:
   one warm search, three timed (the best is kept), and one under
   ``torch.profiler`` for the device busy share (the device time of its
   kernels, memsets and copies over the search's wall time) and the
   number of device items;
2. times the bucketed engine's init superstep and, at the post-init
   state, one continuation superstep (``_superstep``): eagerly (host
   dispatch included, synchronised, the best of 5) and by CUDA-graph
   replay (device work alone), with the device items each makes under
   ``torch.profiler``.

Each side's searches must give the anchors of ``bench_torch.ANCHORS``
(where the scale has them) and both sides the same. Prints the card's
name and power limit and one JSON object per side run; ``--out`` writes
them all to FILE. Exits non-zero without a CUDA device, when a side fails
or when the results differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_FILES = ("row_ptr", "cols", "rev_edge", "raw_degree", "edge_row")
SIDE_TIMEOUT = 600  # seconds a side process may take


def device_time(fn):
    """(device ms, device items, wall ms) of ``fn()`` under torch.profiler:
    every CUDA event's own time (kernels, memsets, copies), their count,
    and the host time of the call (synchronised) inside the profiled
    window, which leaves the profiler's start-up out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    return sum(dev_us(e) for e in items) / 1e3, sum(e.count for e in items), wall_ms


def replay_ms(fn, reps=5):
    """Device ms a call of ``fn`` by CUDA-graph replay (captured once)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps=5):
    """Best host ms of ``reps`` synchronised calls of ``fn``."""
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return min(out[1:])


def side(root: str, graph_dir: str) -> dict:
    """One side's measurements, with ``root``'s package."""
    sys.path.insert(0, root)
    import fuzzypatternmatching_tpu_torch as pkg
    from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
    from fuzzypatternmatching_tpu_torch.graph.csr import Graph, degree_labels
    from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the package of {root}")
    arr = {k: np.load(os.path.join(graph_dir, f"{k}.npy")) for k in GRAPH_FILES}
    g = Graph(len(arr["row_ptr"]) - 1, *(arr[k] for k in GRAPH_FILES))
    labels = degree_labels(g)
    with tempfile.TemporaryDirectory() as tmp:
        pattern, constraints = load_tree_pattern(tmp)
    dev = torch.device("cuda")
    rec = {"root": root}
    for compact in (True, False):
        key = "compact" if compact else "full"
        engine = MatchEngine(g, labels, pattern, constraints, compact=compact, device=dev)
        engine.run()  # warm
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = engine.run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        device_time(engine.run)  # the profiler's first use starts its tracing
        dev_ms, items, wall_ms = device_time(engine.run)
        rec[key] = {
            "seconds_all": secs,
            "seconds_best": min(secs),
            "anchors": {
                "active_vertices": len(r.active_vertices),
                "active_edges": len(r.active_edges),
                "subgraphs": sum(len(v) for v in r.subgraphs.values()),
                "traversed_edges": r.traversed_edges,
            },
            "supersteps": sum(1 for x in r.rows if x.phase == "LP"),
            "profiled_wall_ms": wall_ms,
            "device_ms": dev_ms,
            "device_busy": dev_ms / wall_ms,
            "device_items": items,
        }
    lcc = engine.lcc  # the compact=False engine's bucketed LCC
    st0 = lcc.init_state()
    st, _, _ = lcc.lcc_call(st0, True, n_steps=1)
    steps = {
        "init": lambda: lcc._superstep(lcc.label_tv, st0.alive, st0.tp_flag, init=True),
        "continuation": lambda: lcc._superstep(st.tv, st.alive, st.tp_flag, init=False),
    }
    for name, fn in steps.items():
        fn()
        dev_ms, items, _ = device_time(fn)
        rec[f"{name}_superstep"] = {
            "eager_ms": eager_ms(fn),
            "replay_ms": replay_ms(fn),
            "profiled_device_ms": dev_ms,
            "device_items": items,
        }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--out", default=None)
    ap.add_argument("--side", default=None, help=argparse.SUPPRESS)  # a side process
    ap.add_argument("--graph", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        print(json.dumps(side(args.side, args.graph)), flush=True)
        return 0
    if not torch.cuda.is_available() or not args.other:
        print("ab_superstep: needs a CUDA device and --other DIR", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import bench_torch
    from tools_torch.common import card

    print(card(torch.device("cuda")), flush=True)
    g, _ = bench_torch.build_or_load_graph(args.scale)
    want = bench_torch.ANCHORS.get(args.scale)
    results = []
    with tempfile.TemporaryDirectory() as d:
        for k in GRAPH_FILES:
            np.save(os.path.join(d, k), getattr(g, k))
        del g
        other = os.path.abspath(args.other)
        for label, root in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side", root, "--graph", d],
                capture_output=True, text=True, timeout=SIDE_TIMEOUT, cwd=root,
            )
            if p.returncode != 0:
                print(p.stdout + p.stderr, file=sys.stderr)
                return 1
            rec = {"side": label, **json.loads(p.stdout.strip().splitlines()[-1])}
            print(json.dumps(rec), flush=True)
            results.append(rec)
    got = [r[k]["anchors"] for r in results for k in ("compact", "full")]
    if any(a != got[0] for a in got) or (want is not None and got[0] != want):
        print(f"ab_superstep: anchors differ: {got} (pinned {want})", file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card(torch.device("cuda")), "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
