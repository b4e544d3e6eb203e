#!/usr/bin/env python3
"""A/B of the mesh superstep's payload gather on one NVIDIA GPU: this
checkout's design against another checkout's, on the same inputs.

  python3 ab_mesh_gather.py --other DIR [--out FILE]

DIR holds another checkout of the repository, for example a parent commit
unpacked with ``git archive <commit> | tar -x -C DIR``, whose
``ops/lcc_superstep.gather_accept_or`` still takes ``payload=True`` (the
design of one launch per ELL bucket that reads every slot's payload word,
which ``gather_accept_or_payload`` replaced).

1. The kernels, in this process: the s21 R-MAT graph and the tree corpus of
   ``chip_smoke.py`` phase 22, the mesh engine on 4 shards of the card,
   the post-init state, and each shard's gather inputs of one non-init
   superstep. On those inputs, and on copies whose payload words are all
   alive or send at fixed shares (1 % to 100 %), CUDA-graph replay times,
   in turns (other, this, this, other), this checkout's pair (one
   ``pack_sends`` and one gather per shard) and the other checkout's
   payload gather (one launch per bucket and shard). Both must equal the
   twin. Where the other design is faster at some share, the crossover is
   interpolated between the shares measured.
2. The eager superstep: the same graph, written once as .npy files, in one
   process per checkout in turns (other, this, this, other). Each builds
   the same engine, times one non-init superstep at the post-init state
   eagerly (host dispatch included), runs three under ``torch.profiler``
   for their device time, and times ``lcc_call`` from the init state.

Prints the card's name and power limit, then one JSON object per result;
``--out`` also writes them all to FILE as one JSON object. Exits non-zero
without a CUDA device or where the designs disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SHARES = (0.01, 0.1, 0.25, 0.5, 0.75, 1.0)  # payload words that send
SIDE_TIMEOUT = 420  # seconds a side process may take
GRAPH_FILES = ("row_ptr", "cols", "rev_edge", "raw_degree", "edge_row")
MESH_SHARDS = 4


def emit(rec):
    print(json.dumps(rec), flush=True)
    return rec


def load_other_ops(root):
    """The other checkout's ``ops/lcc_superstep`` module, imported under
    the package name ``other_fpm`` so that both checkouts' modules (and
    kernel libraries, each built from its own ``csrc``) live in one
    process."""
    import importlib
    import importlib.util

    pkg_dir = os.path.join(root, "fuzzypatternmatching_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_fpm", os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir]
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_fpm"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("other_fpm.ops.lcc_superstep")


def with_share(calls, share, gen):
    """The calls with payload words that send at ``share`` (alive with bit
    0 set) and are dead elsewhere; the appended zero word stays zero."""
    import torch

    from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops

    out = []
    for r, m, t, b in calls:
        pick = torch.rand(t.numel(), generator=gen, device=t.device) < share
        w = torch.where(pick, t | (ops.INT32_MIN | 1), t & 0x7FFFFFFF)
        w[-1] = 0
        out.append((r, m, w, b))
    return out


def per_bucket(calls):
    """(index plane [rows, w], row masks, payload) of every bucket of every
    call: the other design's launches."""
    out = []
    for r, m, t, b in calls:
        slot = row = 0
        for w, nb in b:
            out.append((r[slot : slot + nb * w].view(nb, w), m[row : row + nb], t))
            slot += nb * w
            row += nb
    return out


def kernels_ab(g, labels, pattern, constraints, other_ops):
    """Part 1: the pair against the other design on one superstep's calls."""
    import torch

    import chip_smoke as cs
    from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
    from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops
    from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

    dev = torch.device("cuda")
    engine = MatchEngine(g, labels, pattern, constraints, lcc_engine="sharded",
                         mesh=build_mesh(shards=MESH_SHARDS, device=dev))
    lcc = engine.lcc
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    errs = {k: 0 for k in cs.KERNELS}
    with cs.PayloadCheck(errs, keep=True) as chk:
        lcc._superstep(st.tv, st.alive, st.tp_flag, init=False)
        torch.cuda.synchronize()
    cs.check_errs(errs, "in the A/B's superstep")
    base = chk.calls
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    cases = [("post-init", base),
             ("every word alive", [(r, m, t | ops.INT32_MIN, b) for r, m, t, b in base])]
    cases += [(f"{100 * s:g} % sending", with_share(base, s, gen)) for s in SHARES]
    rows = []
    for name, calls in cases:
        words, sending, _, reads = cs.sends_share(calls)
        parts = per_bucket(calls)

        def this(calls=calls):
            return [ops.gather_accept_or_payload(r, m, t, b) for r, m, t, b in calls]

        def other(parts=parts):
            return [other_ops.gather_accept_or(a, None, mk, t, payload=True)
                    for a, mk, t in parts]

        got, old = this(), other()
        want = [ops.gather_accept_or_payload_reference(r, m, t, b) for r, m, t, b in calls]
        err = 0
        for (tn, acc, cnt), ref in zip(got, want):
            err = max(err, *(cs.max_err(x, y) for x, y in zip((tn, acc, cnt), ref)))
        i = 0
        for (tn, acc, cnt), (_, _, _, b) in zip(want, calls):
            olds = old[i : i + len(b)]
            i += len(b)
            for x, y in zip((tn, acc, cnt), (torch.cat([o[0] for o in olds]),
                                            torch.cat([o[1].reshape(-1) for o in olds]),
                                            torch.cat([o[2] for o in olds]))):
                err = max(err, cs.max_err(y, x))
        if err:
            raise AssertionError(f"{name}: the designs differ from the twin by {err}")
        o1 = cs.time_cuda(other)
        t1 = cs.time_cuda(this)
        t2 = cs.time_cuda(this)
        o2 = cs.time_cuda(other)
        rows.append(emit({
            "case": name, "words": words, "sending_words": sending,
            "sending_share": sending / words, "slots_reading_a_sending_word": reads,
            "pair_ms": [t1, t2], "other_ms": [o1, o2],
            "launches_pair": 2 * len(calls), "launches_other": len(parts),
            "max_abs_err": err,
        }))
    return rows


def crossover(rows):
    """Sending shares at which the other design's mean time meets the
    pair's, interpolated between adjacent measured shares (by share)."""
    pts = sorted((r["sending_share"], sum(r["pair_ms"]) / 2 - sum(r["other_ms"]) / 2)
                 for r in rows)
    out = []
    for (s0, d0), (s1, d1) in zip(pts, pts[1:]):
        if d0 <= 0 < d1 or d1 <= 0 < d0:
            out.append(s0 + (s1 - s0) * (-d0) / (d1 - d0))
    return out


def side(root, graph_dir) -> int:
    """Part 2 in a process of the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import fuzzypatternmatching_tpu_torch as pkg
    from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
    from fuzzypatternmatching_tpu_torch.graph.csr import Graph
    from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern
    from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout at {root}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    arr = {k: np.load(os.path.join(graph_dir, f"{k}.npy")) for k in GRAPH_FILES + ("labels",)}
    g = Graph(len(arr["row_ptr"]) - 1, *(arr[k] for k in GRAPH_FILES))
    with tempfile.TemporaryDirectory() as tmp:
        pattern, constraints = load_tree_pattern(tmp)
    t0 = time.perf_counter()
    engine = MatchEngine(g, arr["labels"], pattern, constraints, lcc_engine="sharded",
                         mesh=build_mesh(shards=MESH_SHARDS, device="cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    lcc = engine.lcc
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)

    def step():
        lcc._superstep(st.tv, st.alive, st.tp_flag, init=False)

    for _ in range(2):
        step()
    step_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append(round(1000 * (time.perf_counter() - t0), 3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    gathers = [e for e in items if "gather" in e.key or "pack_sends" in e.key]
    call_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rows, _ = lcc.lcc_call(lcc.init_state(), True)
        torch.cuda.synchronize()
        if i:
            call_ms.append(round(1000 * (time.perf_counter() - t0) / len(rows), 3))
    print(json.dumps({
        "engine_build_s": round(build_s, 3), "step_ms": step_ms,
        "profiled_device_ms": round(sum(dev_us(e) for e in items) / 3e3, 4),
        "profiled_gather_ms": round(sum(dev_us(e) for e in gathers) / 3e3, 4),
        "device_items": sum(e.count for e in items) // 3,
        "lcc_call_ms_per_step": call_ms,
    }), flush=True)
    return 0


def superstep_ab(g, labels, other):
    """Part 2: the eager superstep in one process per checkout, in turns."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    out = []
    with tempfile.TemporaryDirectory() as d:
        for k in GRAPH_FILES:
            np.save(os.path.join(d, k), getattr(g, k))
        np.save(os.path.join(d, "labels"), labels)
        for name, root in (("other", other), ("this", here), ("this", here), ("other", other)):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--side", root, "--graph", d],
                capture_output=True, text=True, timeout=SIDE_TIMEOUT, cwd=root,
            )
            if p.returncode != 0:
                raise RuntimeError(f"the {name} side exited with {p.returncode}:\n"
                                   f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            rec.update(side=name, process_s=round(time.perf_counter() - t0, 1))
            out.append(emit(rec))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="directory of the other checkout")
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--graph", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        return side(args.side, args.graph)
    if not args.other:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_mesh_gather: no CUDA device", file=sys.stderr)
        return 1
    from fuzzypatternmatching_tpu_torch.generators.rmat import rmat_all_ranks
    from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges
    from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    other_ops = load_other_ops(os.path.abspath(args.other))
    src, dst = rmat_all_ranks(21, 4)
    g = from_edges(src, dst, num_vertices=1 << 21)
    labels = degree_labels(g)
    del src, dst
    with tempfile.TemporaryDirectory() as tmp:
        pattern, constraints = load_tree_pattern(tmp)
    result = {"card": smi, "config": "R-MAT s21 (4-rank stream), degree labels, tree corpus, "
              f"{MESH_SHARDS} shards of one card, default mode, post-init state"}
    result["kernels"] = kernels_ab(g, labels, pattern, constraints, other_ops)
    result["crossover_sending_share"] = emit({"crossover_sending_share": crossover(
        result["kernels"])})["crossover_sending_share"]
    torch.cuda.empty_cache()
    result["superstep"] = superstep_ab(g, labels, os.path.abspath(args.other))
    result["seconds"] = round(time.perf_counter() - t0, 1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    emit({"seconds": result["seconds"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
