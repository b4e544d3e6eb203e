"""Spans and counters of a search while a torch profiler records, and of
an engine's set-up on the host clock.

``MatchEngine.run`` opens its root span, ``fpm.search``, with
``search(result, engine)``; the driver opens a span at each layer boundary
below it with ``span(name)`` and counts with ``count(key)``; the engines'
explicit host<->device copies go through ``to_device`` and ``to_host``,
which count their bytes. The search's ``MatchResult`` is what its spans
share: they are kept on it, in memory, as ``spans`` (``Span``: the name,
the parent's index, start and end on ``time.perf_counter_ns()``) and
``counters`` (``COUNTERS``).

While no profiler records, outside the two records below, ``search`` and
``span`` return one shared no-op context manager, a counter or copy site
costs one test, nothing is kept and ``torch.profiler.record_function`` is
never called. While one records,
each span also opens a ``record_function`` range of its name, so the
profiler's trace shows it beside the kernels on the profiler's own clock.
A reader places a search's spans on that clock by one offset: the start of
a range the caller opened around ``run()`` less the start of
``fpm.search``.

Two places keep spans with no profiler, on the host clock alone (no
``record_function`` range), each as a ``Record`` in ``LOG``, the newest
``LOG_SIZE``: ``build(engine)``, the root ``fpm.build`` of a
``MatchEngine``'s constructor, and an engine's first search, which
``search(result, engine)`` records when no profiler does (its spans go
into the record and not onto the result, which keeps none). The sites
are the same ``span``, ``count``, ``to_device`` and ``to_host``, so a
record's counters are the search's. ``setup_records()`` returns the
newest engine's build record and its first-search record. A span's
seconds in a record are host time: device work that outlasts a span is
paid by the span that next waits for it.
"""

from __future__ import annotations

import time
from collections import deque
from contextvars import ContextVar
from dataclasses import dataclass

import numpy as np
import torch

# the search's counters: bytes of the explicit copies each way (counted
# whatever the device, so a CPU run counts what a card's would copy),
# compact-closure builds (misses of MatchEngine._sub_cache), the LCC
# phases that cache served with the closure of another alive set, one
# that contains theirs (``compact_subset_hits``), the LCC phases that
# started from the previous phase's sub-engine state on the device, with
# no closure lookup (``compact_state_carries``), the first LCC phases that
# read the init superstep's alive plane into the cached closure on the
# device (``compact_device_maps``: no download, no lookup), dense V + 1 row
# pointers of the NLCC's AliveCsr built (engine/nlcc.py), and the lanes
# (token, alive neighbour) that DeviceNlcc's expand_frontier calls took in
# (engine/nlcc_device.py). The lanes are the walks' messages plus the
# lanes no message is counted for: in a nem hop after the first the lane
# back to the token's parent, in a TDS hop after the first the lanes
# that its sender-side rules drop. Under the counting LCC
# (engine/lcc_bucketed.py): its supersteps (``lcc_count_supersteps``, one
# ``fpm.lcc.count`` span each), the per-bucket (i, j) class-count
# reductions dispatched from Python (``lcc_count_passes``: the plain twin's
# and the edge-metadata route's ``count_mask``, ops/lcc_fused.py) and the
# supersteps run as one fused launch on the card (``lcc_count_fused``).
# The bucketed engine's supersteps each add the slots of the engine that
# ran them (``lcc_slots``: the full engine's every slot, a compact
# sub-engine's its closure's), what the program launches over
COUNTERS = (
    "h2d_bytes", "d2h_bytes", "compact_builds", "compact_subset_hits",
    "compact_state_carries", "compact_device_maps", "nlcc_dense_ptr_builds",
    "nlcc_device_lanes", "lcc_count_supersteps", "lcc_count_passes", "lcc_count_fused",
    "lcc_slots",
)


@dataclass
class Span:
    name: str
    parent: int  # index of the enclosing span in the search's list; -1: none
    start_ns: int  # time.perf_counter_ns()
    end_ns: int = 0


@dataclass
class Record:
    """The spans and counters of one engine's build (``root``
    ``fpm.build``) or first search (``fpm.search``), on the host clock;
    ``engine`` is the ``id()`` of the ``MatchEngine`` that opened it."""

    root: str
    engine: int
    spans: list
    counters: dict


# the newest records, oldest first: a record goes in when its root closes
# without an exception
LOG_SIZE = 8
LOG: deque[Record] = deque(maxlen=LOG_SIZE)


def profiling() -> bool:
    """True while a torch profiler records (a flag read)."""
    return torch._C._autograd._profiler_enabled()


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """Where one search's or record's spans and counters go, and its open
    spans; ``host``: a host-clock record's, whose spans open no range."""

    __slots__ = ("spans", "counters", "open", "host")

    def __init__(self, spans: list, counters: dict, host: bool = False):
        self.spans = spans
        self.counters = counters
        self.open: list[int] = []  # indices of the open spans, innermost last
        self.host = host


# the recorder of the search or record that this context runs, None while
# neither a profiled search nor a host-clock record is open
_current: ContextVar[_Recorder | None] = ContextVar("fpm_trace", default=None)


class _Span:
    """One span. Its clock is read after the range's entry and after its
    exit, where the profiler's own stamps of the range fall nearest; a
    host-clock record's span opens no range."""

    __slots__ = ("rec", "name", "index", "range")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.range = None
        if not rec.host:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = len(rec.spans)
        parent = rec.open[-1] if rec.open else -1
        rec.spans.append(Span(self.name, parent, time.perf_counter_ns()))
        rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        rec.spans[self.index].end_ns = time.perf_counter_ns()
        return False


class _Root:
    """The root span: sets this context's recorder while it is open, and
    puts a host-clock ``record`` into ``LOG`` when it closes."""

    __slots__ = ("rec", "root", "token", "record")

    def __init__(self, rec: _Recorder, name: str, record: Record | None = None):
        self.rec, self.record = rec, record
        self.root = _Span(rec, name)

    def __enter__(self):
        self.token = _current.set(self.rec)
        self.root.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self.root.__exit__(*exc)
        finally:
            _current.reset(self.token)
        if self.record is not None and exc[0] is None:
            LOG.append(self.record)
        return False


def _record(root: str, engine: int) -> _Root:
    rec = Record(root, engine, [], dict.fromkeys(COUNTERS, 0))
    return _Root(_Recorder(rec.spans, rec.counters, host=True), root, rec)


def build(engine: int) -> _Root:
    """The root span ``fpm.build`` of the constructor of the engine whose
    ``id()`` is ``engine``, recorded on the host clock into ``LOG``."""
    return _record("fpm.build", engine)


def search(result, engine: int | None = None):
    """The root span of one search: kept on ``result`` (a ``MatchResult``)
    while a profiler records; else, where ``engine`` is given (the
    ``id()`` of an engine whose first search this is), recorded on the
    host clock into ``LOG``."""
    if profiling():
        result.counters.update(dict.fromkeys(COUNTERS, 0))
        return _Root(_Recorder(result.spans, result.counters), "fpm.search")
    if engine is None:
        return _OFF
    return _record("fpm.search", engine)


def setup_records() -> tuple[Record | None, Record | None]:
    """(build, first search): the newest ``fpm.build`` record in ``LOG``
    and the first-search record of the same engine after it; None for
    either that the log lacks."""
    log = list(LOG)
    for i in range(len(log) - 1, -1, -1):
        if log[i].root == "fpm.build":
            engine = log[i].engine
            first = next(
                (r for r in log[i + 1:] if r.root == "fpm.search" and r.engine == engine), None
            )
            return log[i], first
    return None, None


def span(name: str):
    """A span of ``name`` inside the open ones."""
    rec = _current.get()
    if rec is None or not (rec.host or profiling()):
        return _OFF
    return _Span(rec, name)


def count(key: str, n: int = 1) -> None:
    """``n`` more of the counter ``key``."""
    rec = _current.get()
    if rec is not None:
        rec.counters[key] += n


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """``torch.from_numpy(array).to(device)``, its bytes counted."""
    rec = _current.get()
    if rec is not None:
        rec.counters["h2d_bytes"] += array.nbytes
    return torch.from_numpy(array).to(device)


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor.cpu().numpy()``, its bytes counted."""
    rec = _current.get()
    if rec is not None:
        rec.counters["d2h_bytes"] += tensor.numel() * tensor.element_size()
    return tensor.cpu().numpy()
