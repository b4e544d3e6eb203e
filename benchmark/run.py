"""The benchmark of ``fuzzypatternmatching_tpu_torch``: back-to-back template
searches on one graph, as an analyst who reruns a saved search issues them.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run: set-up (the cell's graph drawn on the card from the seed, the
program's kernels loaded, one ``MatchEngine`` built, one warm-up search),
then searches one after another for ``--seconds`` (each ``engine.run()``
ended by ``torch.cuda.synchronize()``), then every search's result checked
against the plain reference under ``reference/``. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, read from a profile of the first searches of the window),
``device`` and, last, ``checks``: each number compared with its limit.

Everything about a cell is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<name>.json``) and traffic
(``traffic/<name>.json``); the metrics a cell reports are the entries of
``BENCHMARK.json`` that list it (or list no cells), each read by
``metrics/<metric>.py``. The harness imports no JAX and nothing of the JAX
package, and refuses to print a result when either is loaded.

A traffic file holds the parameters of the one generator, ``window``, and
nothing else (other keys are refused):

* ``arrivals``: ``"closed"``, each search issued when the last has ended;
  or ``"open"``, searches arriving every ``1 / rate_per_s`` seconds, each
  served when it has arrived and the last has ended;
* ``rate_per_s``: the open loop's offered rate (open loops only);
* ``warmup_searches``: searches run in set-up, before the window;
* ``traced_searches``: the window's first searches, profiled with
  ``--trace 1``.

A search is issued while its arrival lies before the window's end, and every
search issued is served; its latency runs from its arrival (in a closed
loop, its start) to its end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, graphgen  # noqa: E402
from benchmark import trace as tracing  # noqa: E402
from benchmark.reference import search as ref_search  # noqa: E402
from benchmark.reference import template as ref_template  # noqa: E402

# top-level module names that may not be loaded, compared whole
FORBIDDEN = {"jax", "jaxlib", "flax", "fuzzypatternmatching_tpu"}


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


TRAFFIC_KEYS = {"arrivals", "rate_per_s", "warmup_searches", "traced_searches"}


def check_traffic(traffic: dict) -> dict:
    """``traffic`` as the generator reads it; a key it does not read, or a
    value it cannot use, raises."""
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic keys the generator does not read: {sorted(unknown)}")
    kind = traffic["arrivals"]
    if kind == "open":
        if not float(traffic["rate_per_s"]) > 0:
            raise ValueError("an open loop needs rate_per_s > 0")
    elif kind != "closed" or "rate_per_s" in traffic:
        raise ValueError(f"arrivals {kind!r}: 'closed' (no rate_per_s) or 'open'")
    if int(traffic["warmup_searches"]) < 1 or int(traffic["traced_searches"]) < 1:
        raise ValueError("warmup_searches and traced_searches must be at least 1")
    return traffic


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic) of a cell, found by name."""
    w = load_json("workloads", f"{name}.json")
    traffic = check_traffic(load_json("traffic", f"{w['traffic']}.json"))
    return w, load_json("configs", f"{w['config']}.json"), traffic


def metric_specs(workload: str, per_layer: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` has this cell report."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    specs = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in specs if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(HERE, "metrics", f"{name}.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    workload: str
    config: dict
    traffic: dict
    device: torch.device
    num_vertices: int = 0
    num_edges: int = 0
    setup_parts: dict = field(default_factory=dict)  # seconds of each step
    times: list = field(default_factory=list)  # each search's latency, seconds
    results: list = field(default_factory=list)  # MatchResult, None if raised
    window_s: float = 0.0  # first search's start to the last one's end
    traced: int = 0  # the window's first searches run under the profiler
    trace: tracing.Trace | None = None
    reference: dict | None = None
    reference_s: float = 0.0
    template_vertices: int = 0

    def peak(self, key: str) -> float | None:
        """The card's published peak ``key`` from ``peaks.json``; None for
        a card the table lacks."""
        if self.device.type != "cuda":
            return None
        with open(os.path.join(HERE, "peaks.json")) as f:
            row = json.load(f).get(torch.cuda.get_device_name(self.device))
        return None if row is None else row.get(key)

    @property
    def setup_s(self) -> float:
        return sum(self.setup_parts.values())

    def untraced(self) -> list:
        """The results of the searches the profiler did not slow down (all,
        where every search was traced)."""
        rest = self.results[self.traced:]
        return [r for r in (rest or self.results) if r is not None]


def template_dir(cfg: dict) -> str:
    return os.path.join(HERE, "templates", cfg["template"])


def setup(run: Run, seed: int):
    """Everything before the window; returns (engine, graph arrays, warm-up
    result). Each step's seconds go into ``run.setup_parts``."""
    from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
    from fuzzypatternmatching_tpu_torch.graph.csr import Graph
    from fuzzypatternmatching_tpu_torch.ops import _build
    from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
        load_nonlocal_constraints,
    )
    from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph

    dev, parts = run.device, run.setup_parts
    torch.zeros(1, device=dev).sum().item()
    sync(dev)
    t = time.perf_counter()
    parts["start"] = t - T_START
    if dev.type == "cuda":
        _build.build_all()
    t, parts["kernel_load"] = time.perf_counter(), time.perf_counter() - t
    g = graphgen.build_graph(run.config["graph"], seed, dev)
    graph = Graph(
        num_vertices=g["num_vertices"], row_ptr=g["row_ptr"], cols=g["cols"],
        rev_edge=g["rev_edge"], raw_degree=g["raw_degree"], edge_row=g["edge_row"],
    )
    run.num_vertices, run.num_edges = graph.num_vertices, graph.num_edges
    prefix = os.path.join(template_dir(run.config), "pattern")
    pattern = load_pattern_graph(prefix)
    constraints = load_nonlocal_constraints(prefix)
    sync(dev)
    t, parts["graph"] = time.perf_counter(), time.perf_counter() - t
    if dev.type == "cuda":
        # the graph build's buffers are freed: the peak from here on is the
        # engine's planes and the searches' working set
        torch.cuda.reset_peak_memory_stats(dev)
    engine = MatchEngine(
        graph, g["labels"], pattern, constraints, device=dev, **run.config["engine"]
    )
    sync(dev)
    t, parts["engine_build"] = time.perf_counter(), time.perf_counter() - t
    first = [engine.run() for _ in range(int(run.traffic["warmup_searches"]))]
    sync(dev)
    parts["warmup"] = time.perf_counter() - t
    return engine, g, first


def window(run: Run, engine, seconds: float, traced: int) -> None:
    """The traffic's searches for ``seconds``, arriving as ``run.traffic``
    says: the first ``traced`` under the profiler, each in a
    ``bench.search`` span."""
    dev = run.device
    interval = (
        1.0 / float(run.traffic["rate_per_s"]) if run.traffic["arrivals"] == "open" else None
    )
    prof = tracing.profiler(dev) if traced else None
    run.traced = traced
    if prof is not None:
        prof.start()
    t_window = t1 = time.perf_counter()
    deadline = t_window + seconds
    while True:
        if interval is not None:
            arrival = t_window + len(run.times) * interval
            if arrival >= deadline and len(run.times) >= traced:
                break
            wait = arrival - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        span = (
            torch.profiler.record_function(tracing.SEARCH_SPAN)
            if len(run.times) < traced else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        if interval is None:
            arrival = t0
        try:
            with span:
                r = engine.run()
                sync(dev)
        except Exception:  # a search that raises is counted as failed
            traceback.print_exc()
            r = None
        t1 = time.perf_counter()
        run.times.append(t1 - arrival)
        run.results.append(r)
        if prof is not None and len(run.times) == traced:
            prof.stop()
        if interval is None and t1 >= deadline and len(run.times) >= traced:
            break
    run.window_s = t1 - t_window
    if prof is not None:
        run.trace = tracing.read(prof)


def reference(run: Run, g: dict, supersteps: int | None = None) -> dict:
    t = time.perf_counter()
    tmpl = ref_template.load(template_dir(run.config))
    run.template_vertices = tmpl.k
    ref = ref_search.ReferenceSearch(
        g, g["labels"], tmpl, bool(run.config["engine"].get("counting", False)),
        run.device, supersteps=supersteps,
    ).run()
    sync(run.device)
    run.reference_s = time.perf_counter() - t
    return ref


def judge(results: list, ref: dict) -> tuple[dict, int]:
    """(worst count of each compared number, searches that failed) of
    results in the reference's form (None: the search raised)."""
    diffs, failed = [], 0
    for r in results:
        if r is None:
            failed += 1
            continue
        d = compare.differences(r, ref)
        diffs.append(d)
        failed += any(d[k] > lim for k, lim in compare.LIMITS.items())
    return compare.worst(diffs), failed


def plains(results: list) -> list:
    return [None if r is None else compare.plain(r) for r in results]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def execute(workload: str, seed: int, seconds: float, traced: bool,
            device: torch.device, config: dict | None = None,
            traffic: dict | None = None) -> dict | None:
    """One run on ``device``: the result line, or None when set-up loaded a
    forbidden module. ``config`` and ``traffic`` replace the cell's (the
    tests run smaller ones on the CPU)."""
    w, cfg, cell_traffic = load_cell(workload)
    traffic = check_traffic(traffic) if traffic is not None else cell_traffic
    run = Run(workload, config or cfg, traffic, device)
    engine, g, first = setup(run, seed)
    bad = forbidden_loaded()
    if bad:
        print(f"set-up loaded forbidden modules: {bad}", file=sys.stderr)
        return None
    n_traced = int(traffic["traced_searches"]) if traced else 0
    window(run, engine, seconds, n_traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.reference = reference(run, g)
    worst, failed = judge(plains(run.results), run.reference)
    warm_worst, warm_failed = judge(plains(first), run.reference)
    checks = {k: max(worst[k], warm_worst[k]) for k in compare.LIMITS}
    correct = (
        failed == 0 and warm_failed == 0 and len(run.results) > 0
        and all(checks[k] <= lim for k, lim in compare.LIMITS.items())
    )
    metrics = {}
    for spec in metric_specs(workload, traced):
        v = reader(spec["name"])(run)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev_line = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": kind,
        "count": int(w["chips"]),
        "memory_peak_bytes": int(peak),
    }
    line = {
        "correct": bool(correct),
        "attempted": len(run.results),
        "failed": int(failed),
        "metrics": metrics,
        "device": dev_line,
    }
    if run.trace is not None and run.trace.searches:
        busy = sum(e - s for s, e in run.trace.busy())
        a, b = run.trace.span
        dev_line["busy_s"] = busy
        dev_line["window_s"] = b - a
        line["breakdown"] = breakdown(run.trace)
    ref = run.reference
    n = len(run.results)
    print("search_times", json.dumps(run.times), flush=True)
    print(
        f"searches {n} in {run.window_s} s; graph {run.num_vertices} vertices "
        f"{run.num_edges} edges; setup {run.setup_parts}; "
        f"reference {run.reference_s} s; traversed_edges {ref['traversed_edges']}; "
        f"traversed_edges_per_s {ref['traversed_edges'] * n / run.window_s}; "
        f"card {power_limit() if device.type == 'cuda' else 'cpu'}",
        flush=True,
    )
    line["setup_parts"] = run.setup_parts
    line["checks"] = {k: {"value": checks[k], "limit": lim} for k, lim in compare.LIMITS.items()}
    return line


def breakdown(tr: tracing.Trace) -> dict:
    ops: dict[str, float] = {}
    for name, s, e in tr.device_in_span():
        k = tracing.base_name(name)
        ops[k] = ops.get(k, 0.0) + (e - s)
    gaps: dict[str, float] = {}
    for s, e, lab in tr.gaps():
        gaps[lab] = gaps.get(lab, 0.0) + (e - s)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    w, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(
            f"{args.workload} needs {w['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 3
    line = execute(
        args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0)
    )
    bad = forbidden_loaded()
    if line is None or bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
