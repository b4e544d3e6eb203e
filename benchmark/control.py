"""The readings that the limits of ``compare.LIMITS`` are set from, for one
cell over many seeds in one process:

* the program: a short window of its searches at the cell's own size,
  judged as a run judges them (the lower reading);
* the control: the reference with the guarantee that the configuration's
  ``control`` names broken (every LCC call one superstep short of the
  template's diameter), judged against the reference (the upper reading).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--device cuda]

One JSON line per seed, then a summary line; exit 1 when a program reading
is over its limit or a control reading is not.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from benchmark import compare, run  # noqa: E402
from benchmark.reference import template as ref_template  # noqa: E402


def one_seed(workload: str, seed: int, seconds: float, device: torch.device) -> dict:
    _, cfg, traffic = run.load_cell(workload)
    r = run.Run(workload, cfg, traffic, device)
    engine, g, first = run.setup(r, seed)
    run.window(r, engine, seconds, 0)
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = run.reference(r, g)
    ref_s = r.reference_s
    prog, failed = run.judge(run.plains(first + r.results), ref)
    k = ref_template.load(run.template_dir(r.config)).diameter - 1
    ctl, _ = run.judge([run.reference(r, g, supersteps=k)], ref)
    lp = [x[2:] for x in ref["rows"]]
    return {
        "seed": seed,
        "searches": len(first) + len(r.results),
        "failed": failed,
        "program": prog,
        "control": ctl,
        "reference_s": ref_s,
        "setup_parts": r.setup_parts,
        "traversed_edges": ref["traversed_edges"],
        "rows_digest": hashlib.sha256(repr(lp).encode()).hexdigest()[:16],
        "iterations": ref["iterations"],
        "vertices": len(ref["vertices"]),
        "edges": len(ref["edges"]),
        "subgraphs": sum(len(s) for s in ref["subgraphs"].values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    lines = []
    for s in args.seeds.split(","):
        line = one_seed(args.workload, int(s), args.seconds, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    ok = all(
        ln["failed"] == 0
        and all(ln["program"][k] <= lim for k, lim in compare.LIMITS.items())
        and any(ln["control"][k] > lim for k, lim in compare.LIMITS.items())
        for ln in lines
    )
    summary = {
        "workload": args.workload,
        "lower": compare.worst([ln["program"] for ln in lines]),
        "upper": {k: min(ln["control"][k] for ln in lines) for k in compare.LIMITS},
        "limits": compare.LIMITS,
        "same_work_every_seed": len({(ln["traversed_edges"], ln["rows_digest"]) for ln in lines}) == 1,
        "ok": ok,
    }
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
