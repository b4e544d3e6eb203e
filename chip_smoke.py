#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fuzzypatternmatching_tpu_torch) on one
NVIDIA GPU:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain torch twin, exactly, at widths
     8..8192, row counts 0/1/1000, pad sentinels, all-zero/all-one masks;
  4. run the golden configurations tree_s13 and cycle_s13 (4 output ranks)
     through the torch MatchEngine and assert the committed anchors;
  5. run the benchmark search — R-MAT s21 (4-rank scrambled stream), degree
     labels, the tree corpus, compact continuation — once warm and three
     times timed; assert the anchors 147/262/74 and 13,207,467 traversed
     edges on each run, and that both kernels were launched by the search;
  6. the same search with compact=False (every superstep over all slots);
  7. hold each kernel against its twin at the s21 shapes of a full-graph
     superstep, and time both with CUDA events.

Any failure ends the run with a non-zero exit code. The last two lines are
one JSON object per kernel (launches during the main-path search, largest
difference from the twin, times) and the result line
``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py   (from the repository root; one CUDA card)
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
S21_ANCHORS = {
    "active_vertices": 147,
    "active_edges": 262,
    "subgraphs": 74,
    "traversed_edges": 13207467,
}
KERNELS = {
    "rev_alive_lookup": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:71",
    "gather_accept_or": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:105",
}
KERNEL_SOURCE = "fuzzypatternmatching_tpu_torch/csrc/lcc_superstep.cu"


def log(msg):
    print(msg, flush=True)


def summary(r):
    return {
        "active_vertices": len(r.active_vertices),
        "active_edges": len(r.active_edges),
        "subgraphs": sum(len(v) for v in r.subgraphs.values()),
        "traversed_edges": r.traversed_edges,
    }


def check_anchors(r, want, what):
    got = summary(r)
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise AssertionError(f"{what}: anchors differ (got, expected): {bad}")


def max_err(got, want):
    """Largest absolute difference between two integer/bool tensors."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape} {got.dtype} != {want.shape} {want.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def compare_kernels_small(ops, dev, errs):
    """Phase 3: each kernel against its twin on seeded inputs."""
    for w in (8, 128, 1024, 8192):
        for n in (0, 1, 1000):
            rng = np.random.RandomState(n * 7 + w)
            S, V = 70000, 50000
            alive = rng.rand(S + 1) < 0.5
            alive[S] = False
            rev = rng.randint(0, S + 1, size=(n, w)).astype(np.int32)
            rev[:, -1] = S  # pad sentinel reads the dead pad bit
            bits = ops.pack_alive(torch.from_numpy(alive).to(dev))
            rev_d = torch.from_numpy(rev).to(dev)
            got = ops.rev_alive_lookup(rev_d, bits)
            torch.cuda.synchronize()
            e = max_err(got, ops.rev_alive_lookup_reference(rev_d, bits))
            errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)

            tv = rng.randint(0, 1 << 16, size=V + 1).astype(np.int32)
            tv[rng.rand(V + 1) < 0.5] = 0
            tv[V] = 0
            adj = rng.randint(0, V + 1, size=(n, w)).astype(np.int32)
            adj[:, -1] = V  # pad sentinel reads the zero table entry
            alive_rev = rng.rand(n, w) < 0.6
            mask = rng.randint(0, 1 << 16, size=n).astype(np.int32)
            for m in (mask, np.zeros_like(mask), np.full_like(mask, 0xFFFF)):
                args = [
                    torch.from_numpy(a).to(dev) for a in (adj, alive_rev, m, tv)
                ]
                got = ops.gather_accept_or(*args)
                torch.cuda.synchronize()
                want = ops.gather_accept_or_reference(*args)
                for g, r in zip(got, want):
                    errs["gather_accept_or"] = max(
                        errs["gather_accept_or"], max_err(g, r)
                    )
    for k, e in errs.items():
        if e != 0:
            raise AssertionError(f"{k}: kernel differs from its twin by {e}")
    log(f"[3] kernels equal their twins (widths 8..8192, n 0/1/1000): {errs}")


def timed_search(engine, anchors, what):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_anchors(r, anchors, what)
    lp = sum(x.seconds for x in r.rows if x.phase == "LP")
    tp = sum(x.seconds for x in r.rows if x.phase == "TP")
    return r, dt, lp, tp


def run_s21(ops, MatchEngine, g, labels, pattern, constraints, dev, compact):
    tag = "[5]" if compact else "[6]"
    t0 = time.perf_counter()
    engine = MatchEngine(g, labels, pattern, constraints, compact=compact, device=dev)
    torch.cuda.synchronize()
    log(f"{tag} engine build (host ELL layout + upload): "
        f"{time.perf_counter() - t0:.3f} s, {engine.lcc.num_slots} slots")
    ops.reset_launches()
    r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 compact={compact} warm")
    launches = dict(ops.launches)
    log(f"{tag} warm search: {dt:.4f} s, iterations={r.iterations}, "
        f"{summary(r)}, kernel launches {launches}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k}: no launch during the s21 search")
    times = []
    for i in range(3):
        r, dt, lp, tp = timed_search(engine, S21_ANCHORS, f"s21 compact={compact} run {i}")
        times.append(dt)
        log(f"{tag} timed search {i}: {dt:.4f} s (LP {lp:.4f} s, TP {tp:.4f} s, "
            f"other {dt - lp - tp:.4f} s), "
            f"{r.traversed_edges / dt / 1e6:.2f} M traversed edges/s, "
            f"host loadavg {os.getloadavg()}")
    log(f"{tag} anchors OK on every run {S21_ANCHORS}; best {min(times):.4f} s = "
        f"{r.traversed_edges / min(times) / 1e6:.2f} M traversed edges/s")
    return engine, launches


def time_cuda(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernels_at_s21(ops, lcc, errs):
    """Phase 7: both kernels against their twins on the inputs of the
    first non-init superstep over the full s21 graph; times per superstep
    (all buckets), kernel and twin in turns."""
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv_table = torch.cat([st.tv, st.tv.new_zeros(1)])
    bits = ops.pack_alive(st.alive)
    planes = []
    for d in lcc._dev:
        mask = lcc._or_over_bits(st.tv[d.seg_rows])[d.seg_id]
        alive_rev = ops.rev_alive_lookup(d.rev, bits)
        e = max_err(alive_rev, ops.rev_alive_lookup_reference(d.rev, bits))
        errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)
        got = ops.gather_accept_or(d.adj, alive_rev, mask, tv_table)
        want = ops.gather_accept_or_reference(d.adj, alive_rev, mask, tv_table)
        for g, r in zip(got, want):
            errs["gather_accept_or"] = max(errs["gather_accept_or"], max_err(g, r))
        planes.append((d, mask, alive_rev))
    torch.cuda.synchronize()
    for k, e in errs.items():
        if e != 0:
            raise AssertionError(f"{k}: kernel differs from its twin at s21 by {e}")

    fns = {
        "rev_alive_lookup": (
            lambda: [ops.rev_alive_lookup(d.rev, bits) for d, _, _ in planes],
            lambda: [ops.rev_alive_lookup_reference(d.rev, bits) for d, _, _ in planes],
        ),
        "gather_accept_or": (
            lambda: [ops.gather_accept_or(d.adj, a, m, tv_table) for d, m, a in planes],
            lambda: [
                ops.gather_accept_or_reference(d.adj, a, m, tv_table)
                for d, m, a in planes
            ],
        ),
    }
    times = {}
    for k, (kernel, plain) in fns.items():
        p1 = time_cuda(plain)
        k1 = time_cuda(kernel)
        k2 = time_cuda(kernel)
        p2 = time_cuda(plain)
        times[k] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"[7] {k} over {lcc.num_slots} slots ({len(planes)} buckets): "
            f"kernel {k1:.4f}/{k2:.4f} ms, twin {p1:.4f}/{p2:.4f} ms")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from fuzzypatternmatching_tpu.generators.rmat import rmat_all_ranks
    from fuzzypatternmatching_tpu.graph.csr import degree_labels, from_edges
    from fuzzypatternmatching_tpu.pattern.builtin import load_tree_pattern
    from fuzzypatternmatching_tpu import native
    from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
    from fuzzypatternmatching_tpu_torch.ops import _build
    from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_golden import build_config

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log("[1] card (nvidia-smi name, power.limit):")
    print(smi, flush=True)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.library("lcc_superstep")
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds.get('lcc_superstep', 0.0):.2f} s)")

    errs = {k: 0 for k in KERNELS}
    compare_kernels_small(ops, dev, errs)

    with open(os.path.join(REPO, "examples", "results_golden", "golden_meta.json")) as f:
        golden = json.load(f)
    for name in ("tree_s13", "cycle_s13"):
        cfg = golden["configs"][name]
        g, labels, pattern, constraints = build_config(
            cfg["scale"], os.path.join(REPO, cfg["corpus"])
        )
        t0 = time.perf_counter()
        r = MatchEngine(
            g, labels, pattern, constraints, num_ranks=golden["num_ranks"],
            device=dev,
        ).run()
        want = {k: cfg[k] for k in ("active_vertices", "active_edges", "subgraphs")}
        check_anchors(r, want, name)
        if r.iterations != cfg["iterations"]:
            raise AssertionError(f"{name}: {r.iterations} iterations, want {cfg['iterations']}")
        log(f"[4] {name}: anchors OK {want}, iterations {r.iterations}, "
            f"{time.perf_counter() - t0:.3f} s")

    log(f"[5] native library available: {native.available()}")
    t0 = time.perf_counter()
    src, dst = rmat_all_ranks(21, 4)
    t1 = time.perf_counter()
    g = from_edges(src, dst, num_vertices=1 << 21)
    labels = degree_labels(g)
    del src, dst
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pattern, constraints = load_tree_pattern(tmp)
    log(f"[5] R-MAT s21: V={g.num_vertices} E={g.num_edges}; generate "
        f"{t1 - t0:.2f} s, CSR + labels {t2 - t1:.2f} s")
    _, launches = run_s21(ops, MatchEngine, g, labels, pattern, constraints, dev, True)
    full, launches_full = run_s21(
        ops, MatchEngine, g, labels, pattern, constraints, dev, False
    )
    times = kernels_at_s21(ops, full.lcc, errs)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"launches with compact=False: {launches_full}")
    print(json.dumps({"kernels": [
        {
            "name": k,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNELS[k],
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": times[k][0],
            "plain_ms": times[k][1],
        }
        for k in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
