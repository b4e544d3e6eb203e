"""The reduction from a ``torch.profiler`` trace to intervals: the device's
kernels, copies and fills, the host's torch ops, and the harness's own span
around each search (``bench.search``). The metric readers under
``metrics/`` do their arithmetic on what this returns."""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

SEARCH_SPAN = "bench.search"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_OP = "host, no torch op"


def profiler(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def base_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters: ``void (anonymous
    namespace)::superstep_kernel<true, true>(Planes, ...)`` ->
    ``superstep_kernel``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in "<(":
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip()


@dataclass
class Trace:
    """Times in seconds on the profiler's clock."""

    searches: list[tuple[float, float]]  # (start, end) of each traced search
    device: list[tuple[str, float, float]]  # (name, start, end)
    host_ops: list[tuple[str, float, float]]  # torch ops on the host

    @property
    def span(self) -> tuple[float, float]:
        return self.searches[0][0], self.searches[-1][1]

    def device_in_span(self) -> list[tuple[str, float, float]]:
        a, b = self.span
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device if s < b and e > a]

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's intervals inside the span, in order."""
        out: list[list[float]] = []
        for _, s, e in sorted(self.device_in_span(), key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def gaps(self) -> list[tuple[float, float, str]]:
        """The device's idle intervals inside the span, each labelled with
        the innermost torch op that the host was in at the interval's middle,
        or ``NO_OP`` where it was in none (Python, numpy)."""
        a, b = self.span
        edges = [a]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(b)
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        if not gaps:
            return []
        mids = np.array([(s + e) / 2 for s, e in gaps])
        best = np.full(len(gaps), np.inf)
        label = [NO_OP] * len(gaps)
        for name, s, e in self.host_ops:
            lo, hi = np.searchsorted(mids, [s, e])
            if hi <= lo:
                continue
            inner = np.nonzero(best[lo:hi] > e - s)[0] + lo
            best[inner] = e - s
            for i in inner:
                label[i] = name
        return [(s, e, lab) for (s, e), lab in zip(gaps, label)]


def read(prof: torch.profiler.profile) -> Trace:
    """The trace of a finished profiler, through its Chrome trace export
    (written to a temporary file and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    searches, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev.get("dur", 0)) * 1e-6
        if cat in DEVICE_CATS:
            device.append((name, s, e))
        elif cat == "cpu_op":
            host.append((name, s, e))
        elif cat == "user_annotation" and name == SEARCH_SPAN:
            searches.append((s, e))
    searches.sort()
    return Trace(searches, device, host)
