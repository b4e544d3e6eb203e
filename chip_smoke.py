#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fuzzypatternmatching_tpu_torch) on one
NVIDIA GPU:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a);
  3. hold each kernel against its plain torch twin, exactly: the alive
     table (words and group summary) at several sizes and summary budgets,
     the lookup at widths 8..8192, and gather_accept_or at widths 8..8192
     (every lane mapping) with n = 0/1/33/1000, all at alive densities 0.5 %, 60 % and 100 %,
     with pad sentinels and all-zero/all-one masks;
  4. run the golden configurations tree_s13 and cycle_s13 (4 output ranks)
     through the torch MatchEngine and assert the committed anchors;
  5. run the benchmark search — R-MAT s21 (4-rank scrambled stream), degree
     labels, the tree corpus, compact continuation — once warm and three
     times timed; assert the anchors 147/262/74 and 13,207,467 traversed
     edges on each run, and that every kernel was launched by the search;
  6. the same search with compact=False (every superstep over all slots);
  7. hold each kernel against its twin at the s21 shapes of a full-graph
     superstep, on the state after the init superstep and on an all-alive
     state, and time kernel and twin with CUDA events; time the lookup
     again with rev sorted (the random-L2-sector check);
  8. one search of each mode under torch.profiler: device time against
     wall time, and the largest device items.

Any failure ends the run with a non-zero exit code, and so does a run
without a CUDA device or without the rest of the repository. The last two
lines are one JSON object with a record per kernel (launches during the
main-path search, largest difference from the twin, times and the least
time the card could take) and the result line ``{"ok": true, ...}``.

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

from fuzzypatternmatching_tpu_torch import native
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.generators.rmat import rmat_all_ranks
from fuzzypatternmatching_tpu_torch.golden import GOLDEN_BASE, REPO, build_config
from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges
from fuzzypatternmatching_tpu_torch.ops import _build
from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops
from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern

S21_ANCHORS = {
    "active_vertices": 147,
    "active_edges": 262,
    "subgraphs": 74,
    "traversed_edges": 13207467,
}
KERNELS = {
    "pack_alive": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:187",
    "rev_alive_lookup": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:71",
    "gather_accept_or": "fuzzypatternmatching_tpu/ops/lcc_superstep.py:105",
}
KERNEL_SOURCE = "fuzzypatternmatching_tpu_torch/csrc/lcc_superstep.cu"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s
DENSITIES = (0.005, 0.6, 1.0)


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


def table_err(got, want):
    if got.group_log2 != want.group_log2:
        raise AssertionError(f"group_log2 {got.group_log2} != {want.group_log2}")
    return max(max_err(got.words, want.words), max_err(got.summary, want.summary))


def check_errs(errs, where):
    for k, e in errs.items():
        if e != 0:
            raise AssertionError(f"{k}: kernel differs from its twin {where} by {e}")


def compare_kernels_small(dev, errs):
    """Phase 3: each kernel against its twin on seeded inputs."""
    for density in DENSITIES:
        for n, budget in ((1, 16), (1025, 16), (40000, 64), (300001, 256),
                          (1000003, 64), (1000003, ops.SUMMARY_BUDGET_BYTES)):
            rng = np.random.RandomState(n + budget)
            alive = torch.from_numpy(rng.rand(n) < density).to(dev)
            alive[-1] = False  # the pad slot
            got = ops.alive_table(alive, budget)
            torch.cuda.synchronize()
            errs["pack_alive"] = max(
                errs["pack_alive"], table_err(got, ops.alive_table_reference(alive, budget))
            )
            rev = torch.from_numpy(rng.randint(0, n, size=9999).astype(np.int32)).to(dev)
            e = max_err(ops.rev_alive_lookup(rev, got), ops.rev_alive_lookup_reference(rev, got))
            errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)

        for w in (8, 128, 1024, 8192):
            for n in (0, 1, 1000):
                rng = np.random.RandomState(n * 7 + w)
                S = 70000
                alive = rng.rand(S + 1) < density
                alive[S] = False
                rev = rng.randint(0, S + 1, size=(n, w)).astype(np.int32)
                rev[:, -1] = S  # pad sentinel reads the dead pad bit
                table = ops.alive_table(torch.from_numpy(alive).to(dev))
                rev_d = torch.from_numpy(rev).to(dev)
                got = ops.rev_alive_lookup(rev_d, table)
                torch.cuda.synchronize()
                e = max_err(got, ops.rev_alive_lookup_reference(rev_d, table))
                errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)

        for w in (8, 16, 64, 128, 512, 1024, 8192):
            for n in (0, 1, 33, 1000):
                rng = np.random.RandomState(n * 7 + w)
                V = 50000
                tv = rng.randint(0, 1 << 16, size=V + 1).astype(np.int32)
                tv[rng.rand(V + 1) < 0.5] = 0
                tv[V] = 0
                adj = rng.randint(0, V + 1, size=(n, w)).astype(np.int32)
                adj[:, -1] = V  # pad sentinel reads the zero table entry
                alive_rev = rng.rand(n, w) < density
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
    check_errs(errs, "at small shapes")
    log(f"[3] kernels equal their twins (tables n 1..1e6 at G 32..2048; widths "
        f"8..8192, n 0/1/33/1000; densities {DENSITIES}): {errs}")


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


def run_s21(g, labels, pattern, constraints, dev, compact):
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


def time_cuda(fn, reps=20, graph=True):
    """Milliseconds per call of ``fn`` by CUDA events. ``graph=True`` times
    the device work alone: the calls are captured once in a CUDA graph and
    the graph is replayed. ``graph=False`` times eager calls, host dispatch
    included (the device waits for the host between small launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain):
    """(kernel ms, plain ms) of device time, each the mean of two timings
    in turns (plain, kernel, kernel, plain), and the raw values."""
    p1 = time_cuda(plain)
    k1 = time_cuda(kernel)
    k2 = time_cuda(kernel)
    p2 = time_cuda(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def bucket_planes(lcc, alive_rev, masks):
    """(device bucket, row masks, its alive_rev view [n, w]) per bucket."""
    out = []
    for d, b, m in zip(lcc._dev, lcc.buckets, masks):
        n, w = d.adj.shape
        out.append((d, m, alive_rev[b.slot_base : b.slot_base + n * w].view(n, w)))
    return out


def bound_ms(lcc, table, planes):
    """Least time of each kernel on these inputs: the bytes it must move
    (each input read once, each output written once; the gathers only
    where this state's data needs them) over the HBM rate."""
    s = lcc.num_slots
    n_flags = s + 1
    g = table.group_log2
    # words of the groups with an alive bit are all the lookup may read
    group_bits = ((table.summary.view(-1, 1) >> torch.arange(32, device=table.summary.device)) & 1)
    alive_groups = int(group_bits.sum())
    word_bytes = 4 * min(alive_groups << (g - 5), table.words.numel())
    pack = n_flags + 4 * table.words.numel() + 4 * table.summary.numel()
    lookup = 5 * s + 4 * table.summary.numel() + word_bytes
    gather = 0
    for d, _, a in planes:
        n, w = d.adj.shape
        n_alive = int(a.sum())
        distinct_tv = int(torch.unique(d.adj[a]).numel())
        gather += 2 * n * w + 12 * n + 4 * n_alive + 4 * distinct_tv
    return {
        "pack_alive": pack / HBM_BYTES_PER_MS,
        "rev_alive_lookup": lookup / HBM_BYTES_PER_MS,
        "gather_accept_or": gather / HBM_BYTES_PER_MS,
    }, {"alive_groups_share": alive_groups / max(1, -(-n_flags >> g))}


def kernels_at_s21(lcc, errs):
    """Phase 7: every kernel against its twin on the inputs of a non-init
    superstep over the full s21 graph, on the state after the init
    superstep and on an all-alive state; times per superstep (all
    buckets), kernel and twin in turns: device time from CUDA-graph replay,
    and the kernel's eager time per superstep beside it."""
    st, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv_table = torch.cat([st.tv, st.tv.new_zeros(1)])
    masks = [lcc._or_over_bits(st.tv[d.seg_rows])[d.seg_id] for d in lcc._dev]
    dense = torch.ones_like(st.alive)
    dense[-1] = False  # the pad slot stays dead
    rev = lcc._rev_flat
    results = {}
    for name, alive in (("post-init", st.alive), ("all-alive", dense)):
        table = ops.alive_table(alive)
        table_ref = ops.alive_table_reference(alive)
        errs["pack_alive"] = max(errs["pack_alive"], table_err(table, table_ref))
        alive_rev = ops.rev_alive_lookup(rev, table)
        e = max_err(alive_rev, ops.rev_alive_lookup_reference(rev, table_ref))
        errs["rev_alive_lookup"] = max(errs["rev_alive_lookup"], e)
        planes = bucket_planes(lcc, alive_rev, masks)
        for d, m, a in planes:
            got = ops.gather_accept_or(d.adj, a, m, tv_table)
            want = ops.gather_accept_or_reference(d.adj, a, m, tv_table)
            for g, r in zip(got, want):
                errs["gather_accept_or"] = max(errs["gather_accept_or"], max_err(g, r))
        torch.cuda.synchronize()
        check_errs(errs, f"at s21 ({name})")

        fns = {
            "pack_alive": (
                lambda: ops.alive_table(alive),
                lambda: ops.alive_table_reference(alive),
            ),
            "rev_alive_lookup": (
                lambda: ops.rev_alive_lookup(rev, table),
                lambda: ops.rev_alive_lookup_reference(rev, table),
            ),
            "gather_accept_or": (
                lambda: [ops.gather_accept_or(d.adj, a, m, tv_table) for d, m, a in planes],
                lambda: [
                    ops.gather_accept_or_reference(d.adj, a, m, tv_table)
                    for d, m, a in planes
                ],
            ),
        }
        bounds, info = bound_ms(lcc, table, planes)
        n_alive = int(alive[:-1].sum())
        log(f"[7] {name}: {n_alive} alive slots of {lcc.num_slots}, "
            f"G = {1 << table.group_log2}, summary {4 * table.summary.numel()} B, "
            f"alive groups {info['alive_groups_share']:.4f}, "
            f"alive_rev set {int(alive_rev.sum())}")
        times = {}
        for k, (kernel, plain) in fns.items():
            k_ms, p_ms, raw = time_pair(kernel, plain)
            times[k] = (k_ms, p_ms, bounds[k])
            log(f"[7] {name} {k} ({len(planes)} buckets): kernel "
                f"{raw[0]:.4f}/{raw[1]:.4f} ms, twin {raw[2]:.4f}/{raw[3]:.4f} ms, "
                f"bound {bounds[k]:.4f} ms (bytes), "
                f"{100 * bounds[k] / k_ms:.1f} % of bound; eager kernel calls "
                f"{time_cuda(kernel, graph=False):.4f} ms")
        per_bucket = [
            (tuple(d.adj.shape), int(a.sum()),
             round(time_cuda(lambda: ops.gather_accept_or(d.adj, a, m, tv_table)), 4))
            for d, m, a in planes
        ]
        log(f"[7] {name} gather_accept_or per bucket ((n, w), alive_rev set, ms): "
            f"{per_bucket}")
        rev_sorted = torch.sort(rev).values
        t_sorted = time_cuda(lambda: ops.rev_alive_lookup(rev_sorted, table))
        t_random = time_cuda(lambda: ops.rev_alive_lookup(rev, table))
        log(f"[7] {name} rev_alive_lookup with rev sorted: {t_sorted:.4f} ms "
            f"(as laid out: {t_random:.4f} ms)")
        results[name] = times
        del table_ref
    return results


def profile_search(engine, tag):
    """Phase 8: one search under torch.profiler; device busy share and the
    largest device items (kernel self time summed by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check_anchors(r, S21_ANCHORS, f"{tag} profiled search")

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in items) / 1e3
    if device_ms == 0:
        log(f"[8] {tag}: the profiler recorded no device time (not measured)")
        return
    ours = [e for e in items if any(k in e.key for k in (
        "pack_alive_kernel", "rev_alive_kernel", "gather_narrow4_kernel",
        "gather_wide_kernel", "gather_rowwise_kernel"))]
    top = sorted(items, key=dev_us, reverse=True)[:8]
    log(f"[8] {tag} profiled search: wall {wall * 1e3:.1f} ms, device "
        f"{device_ms:.2f} ms (busy {100 * device_ms / (wall * 1e3):.1f} %), "
        f"{sum(e.count for e in items)} device items; the port's kernels "
        f"{sum(dev_us(e) for e in ours) / 1e3:.3f} ms in "
        f"{sum(e.count for e in ours)} launches; largest (name, ms, count): "
        f"{[(e.key[:100], round(dev_us(e) / 1e3, 3), e.count) for e in top]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
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
    compare_kernels_small(dev, errs)

    with open(os.path.join(GOLDEN_BASE, "golden_meta.json")) as f:
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
    compact, launches = run_s21(g, labels, pattern, constraints, dev, True)
    full, launches_full = run_s21(g, labels, pattern, constraints, dev, False)
    times = kernels_at_s21(full.lcc, errs)["post-init"]
    profile_search(compact, "s21 compact")
    profile_search(full, "s21 compact=False")

    bad = sorted(
        k for k in sys.modules
        if k in ("jax", "fuzzypatternmatching_tpu")
        or k.startswith(("jax.", "fuzzypatternmatching_tpu."))
    )
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad}")
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
            "bound_ms": times[k][2],
            "bound_by": "bytes",
            "library_ms": None,
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
