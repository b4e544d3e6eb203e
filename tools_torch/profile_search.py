#!/usr/bin/env python3
"""Phase split of the port's benchmark search, and a cProfile of a warm
run: the counterpart of ``tools/profile_search.py``.

On the workload of ``bench_torch.py`` at ``BENCH_SCALE`` (default 21),
with the tree corpus or (``--corpus cycle``) the cycle corpus, whose
search spends most of its time in the compact path's host work: the
warm-up search (its result held to the sweep's pinned anchors), then per
measured run its seconds split into LP (the LCC calls), TP (the NLCC
constraints) and other (the driver's host work between them), with each
TP row and each iteration's step-0 row; then the host time by function of
one warm run (cProfile, the top 35 by cumulative time). Each run ends in
a device synchronise.

    python3 tools_torch/profile_search.py [--corpus cycle]   # on the card
    BENCH_SCALE=13 python3 tools_torch/profile_search.py --device cpu

Writes the phase split as JSON to ``--out`` (default
``.bench_cache/profile_search_s<scale>.json``), stamped with the card's
name and power limit, the commit, a hash of the sources and the time.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from tools_torch.common import CACHE, clock, device_of, stamp  # noqa: E402
from tools_torch.sweep import PINNED_ANCHORS  # noqa: E402


def phase_split(engine, runs: int = 2) -> list[dict]:
    """Per measured run: total, LP, TP and other seconds, and the TP and
    step-0 rows (iteration, phase, step, seconds)."""
    out = []
    for _ in range(runs):
        t0 = clock(engine.device)
        r = engine.run()
        total = clock(engine.device) - t0
        lp = sum(x.seconds for x in r.rows if x.phase == "LP")
        tp = sum(x.seconds for x in r.rows if x.phase == "TP")
        out.append({
            "total": total, "lp": lp, "tp": tp, "other": total - lp - tp,
            "rows": [(x.itr, x.phase, x.step, x.seconds)
                     for x in r.rows if x.phase == "TP" or x.step == 0],
        })
    return out


def print_split(runs: list[dict]) -> None:
    for run in runs:
        print(f"measured {run['total']:.4f}s | LP {run['lp']:.4f}s | TP {run['tp']:.4f}s | "
              f"other {run['other']:.4f}s", flush=True)
        for itr, phase, step, sec in run["rows"]:
            print(f"  itr{itr} {phase} {step}: t={sec:.4f}", flush=True)


def host_profile(engine, top: int = 35) -> None:
    """cProfile of one warm run, the ``top`` functions by cumulative time."""
    prof = cProfile.Profile()
    prof.enable()
    engine.run()
    clock(engine.device)
    prof.disable()
    pstats.Stats(prof, stream=sys.stdout).sort_stats("cumulative").print_stats(top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--corpus", default="tree", help="tree (default) or cycle")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    scale = int(os.environ.get("BENCH_SCALE", "21"))
    g, labels = bench_torch.build_or_load_graph(scale)
    engine = bench_torch.build_engine(g, labels, dev, args.corpus)
    t0 = clock(dev)
    r = engine.run()
    print(f"warmup {clock(dev) - t0:.1f}s", flush=True)
    bench_torch.check_anchors(PINNED_ANCHORS.get((scale, args.corpus)), r,
                              f"s{scale} {args.corpus} warm-up")
    runs = phase_split(engine, args.runs)
    print_split(runs)
    host_profile(engine)
    out = args.out or os.path.join(CACHE, f"profile_search_s{scale}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"scale": scale, "corpus": args.corpus, "runs": runs, **stamp(dev)}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
