"""Construction-phase tracing — the LogStep analog (the port's own copy of
``fuzzypatternmatching_tpu/utils/log_step.py``; the same lines).

The reference brackets every graph-construction phase with an RAII logger
that records rank-0 wall time plus per-node dirty pages and cumulative IO
(impl/log_step.hpp:58-110, reading /proc via cache_utilities.hpp:141-228).
This is the host-side equivalent: a context manager that prints, per phase,

  * wall seconds,
  * peak & current RSS of this process (``/proc/self/status``),
  * MB read / written by this process during the phase (``/proc/self/io``),
  * system dirty pages (``/proc/meminfo`` ``Dirty:``) at entry/exit,

so the chunked construction pipeline's memory/IO behavior can be analyzed
phase by phase, as the reference's build logs allow. Everything degrades to
"-" when a /proc file is unavailable (non-Linux).
"""

from __future__ import annotations

import os
import time


def _read_kv_kb(path: str, key: str) -> int | None:
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def _self_io() -> tuple[int | None, int | None]:
    """(read_bytes, write_bytes) charged to this process."""
    r = w = None
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("read_bytes:"):
                    r = int(line.split()[1])
                elif line.startswith("write_bytes:"):
                    w = int(line.split()[1])
    except OSError:
        pass
    return r, w


def dirty_pages_kb() -> int | None:
    """System-wide dirty page bytes (kB) — cache_utilities.hpp:141-170."""
    return _read_kv_kb("/proc/meminfo", "Dirty:")


def rss_kb() -> tuple[int | None, int | None]:
    """(current VmRSS, peak VmHWM) in kB."""
    return (
        _read_kv_kb("/proc/self/status", "VmRSS:"),
        _read_kv_kb("/proc/self/status", "VmHWM:"),
    )


def _fmt_mb(kb: int | None) -> str:
    return "-" if kb is None else f"{kb / 1024:.0f}MB"


class LogStep:
    """``with LogStep("partition low-degree edges"): ...`` — prints the
    phase banner at entry and wall/RSS/IO/dirty-page deltas at exit.
    Disable globally with FPM_LOG_STEPS=0 (enabled by default in the build
    CLIs, which pass ``enabled``)."""

    def __init__(self, step: str, enabled: bool = True, out=None):
        self.step = step
        self.enabled = enabled and os.environ.get("FPM_LOG_STEPS", "1") != "0"
        import sys

        self.out = out or sys.stdout

    def __enter__(self):
        if not self.enabled:
            return self
        self.t0 = time.perf_counter()
        self.io0 = _self_io()
        d = dirty_pages_kb()
        print(
            f"Starting:  {self.step} (dirty pages: {_fmt_mb(d)})",
            file=self.out, flush=True,
        )
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        dt = time.perf_counter() - self.t0
        r1, w1 = _self_io()
        r0, w0 = self.io0
        cur, peak = rss_kb()
        rd = "-" if None in (r0, r1) else f"{(r1 - r0) >> 20}MB"
        wr = "-" if None in (w0, w1) else f"{(w1 - w0) >> 20}MB"
        print(
            f"Finished: {self.step} in {dt:.2f} seconds.\n"
            f"\tRSS: {_fmt_mb(cur)} (peak {_fmt_mb(peak)})  "
            f"Read: {rd}  Written: {wr}  "
            f"Dirty Pages: {_fmt_mb(dirty_pages_kb())}",
            file=self.out, flush=True,
        )
        return False
