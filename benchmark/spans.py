"""The program's own spans and counters of the traced searches
(``MatchResult.spans`` and ``counters``, which the program keeps while a
torch profiler records: ``fuzzypatternmatching_tpu_torch/utils/trace.py``),
placed on the profiler's clock, for the metric readers.

Placing: search i's spans are shifted by one offset, the start of its
``bench.search`` range in the trace less the start of its ``fpm.search``
span (the harness opens the first microseconds before ``MatchEngine.run``
opens the second). Idle time is what ``Trace.busy()`` leaves out, as
``device_idle_pct`` has it; inside each ``fpm.search`` it is put down to
the innermost span open there, and to a layer by the innermost
``fpm.lcc`` or ``fpm.nlcc`` around that (an LCC phase that a constraint
causes counts as LCC), or to the driver where neither is open.

    python3 benchmark/spans.py --workload tree.default --seed 0 --seconds 51

runs one traced window as ``run.py --trace 1`` does (without the
reference) and prints the split by layer and by innermost span, each
counter and the device time of each kernel or copy per search, and the
traced and untraced searches' mean times.
"""

from __future__ import annotations

import bisect

SEARCH = "fpm.search"
LAYERS = {"fpm.lcc": "lcc", "fpm.nlcc": "nlcc"}


def _traced(run) -> list:
    """The traced searches' results (None where a search raised)."""
    return list(run.results[: run.traced])


def placed(run) -> list | None:
    """Each traced search's spans as (name, parent, start, end), seconds on
    the profiler's clock; None off the card, without a trace, or where no
    search kept spans (a program without them)."""
    tr = run.trace
    if run.device.type != "cuda" or tr is None or not tr.searches:
        return None
    out = []
    for (a, _), r in zip(tr.searches, _traced(run)):
        spans = getattr(r, "spans", None)
        if not spans or spans[0].name != SEARCH:
            continue
        off = a - spans[0].start_ns * 1e-9
        out.append(
            [(s.name, s.parent, s.start_ns * 1e-9 + off, s.end_ns * 1e-9 + off) for s in spans]
        )
    return out or None


def _idle_pieces(busy: list, a: float, b: float) -> list:
    """[a, b] less the busy intervals (sorted, disjoint)."""
    out, t = [], a
    for s, e in busy:
        if e <= t:
            continue
        if s >= b:
            break
        if s > t:
            out.append((t, s))
        t = e
    if t < b:
        out.append((t, b))
    return out


def _innermost(spans: list, t: float) -> int:
    """Index of the innermost span open at ``t``: spans are listed in the
    order they opened and nest, so it is the last one that holds ``t``."""
    for i in range(len(spans) - 1, -1, -1):
        if spans[i][2] <= t <= spans[i][3]:
            return i
    return 0


def _layer(spans: list, i: int) -> str:
    while i >= 0:
        layer = LAYERS.get(spans[i][0])
        if layer is not None:
            return layer
        i = spans[i][1]
    return "driver"


def idle_split(run) -> tuple[dict, dict] | None:
    """Device-idle seconds inside ``fpm.search`` per traced search: by layer
    (``lcc``, ``nlcc``, ``driver``) and by the innermost span's name."""
    searches = placed(run)
    if searches is None:
        return None
    busy = run.trace.busy()
    by_layer = {"lcc": 0.0, "nlcc": 0.0, "driver": 0.0}
    by_span: dict[str, float] = {}
    for spans in searches:
        _, _, a, b = spans[0]
        idle = _idle_pieces(busy, a, b)
        cuts = {a, b}
        cuts.update(t for s, e in idle for t in (s, e))
        cuts.update(t for _, _, s, e in spans for t in (s, e) if a < t < b)
        cuts = sorted(cuts)
        starts = [s for s, _ in idle]
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            k = bisect.bisect_right(starts, mid) - 1
            if k < 0 or mid > idle[k][1]:
                continue  # the device was busy
            i = _innermost(spans, mid)
            by_layer[_layer(spans, i)] += hi - lo
            by_span[spans[i][0]] = by_span.get(spans[i][0], 0.0) + (hi - lo)
    n = len(searches)
    return (
        {k: v / n for k, v in by_layer.items()},
        {k: v / n for k, v in by_span.items()},
    )


def counter(run, *keys: str) -> float | None:
    """The sum of the counters ``keys`` per traced search; None off the
    card, without a trace, or where no search kept counters."""
    if run.device.type != "cuda" or run.trace is None:
        return None
    kept = [getattr(r, "counters", None) for r in _traced(run)]
    kept = [c for c in kept if c]
    if not kept:
        return None
    return sum(c.get(k, 0) for c in kept for k in keys) / len(kept)


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch

    from benchmark import run as harness
    from benchmark.trace import base_name

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    _, cfg, traffic = harness.load_cell(args.workload)
    r = harness.Run(args.workload, cfg, traffic, dev)
    engine, _, _ = harness.setup(r, args.seed)
    harness.window(r, engine, args.seconds, int(traffic["traced_searches"]))
    split = idle_split(r)
    busy = sum(e - s for s, e in r.trace.busy())
    searches = placed(r) or []
    inside = sum(sp[0][3] - sp[0][2] for sp in searches) / max(len(searches), 1)
    n, times = r.traced, r.times
    ops: dict[str, float] = {}
    for name, s, e in r.trace.device_in_span():
        k = base_name(name)
        ops[k] = ops.get(k, 0.0) + (e - s) / len(r.trace.searches)
    line = {
        "idle_by_layer_s": split and split[0],
        "idle_by_span_s": split and dict(sorted(split[1].items(), key=lambda x: -x[1])),
        "fpm_search_s": inside,
        "trace_busy_s": busy / max(len(r.trace.searches), 1),
        "device_s_per_search": dict(sorted(ops.items(), key=lambda x: -x[1])[:12]),
        "counters_per_search": {
            k: counter(r, k) for k in ("h2d_bytes", "d2h_bytes", "compact_builds")
        },
        "traced_search_s": sum(times[:n]) / max(len(times[:n]), 1),
        "untraced_search_s": sum(times[n:]) / max(len(times[n:]), 1),
        "searches": len(r.times),
        "card": harness.power_limit(),
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
