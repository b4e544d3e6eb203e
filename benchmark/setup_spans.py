"""The program's host-clock records of set-up, for the metric readers:
the build record (root ``fpm.build``) of the newest ``MatchEngine`` and the
record of its first search, the warm-up's first
(``fuzzypatternmatching_tpu_torch/utils/trace.py``: ``setup_records``).
The program keeps them with no profiler, on ``time.perf_counter_ns()``,
the clock of the run's ``setup_parts``.

The readers run after the window, in the run's process; the plain
reference builds no ``MatchEngine``, so the newest engine is the run's.
Off the card they read nothing: there the planes land in host memory,
and no upload is timed.
"""

from __future__ import annotations


def records(run) -> tuple:
    """(build, first search) records of the run's engine; (None, None) off
    the card and from a program that keeps no records."""
    if run.device.type != "cuda":
        return None, None
    try:
        from fuzzypatternmatching_tpu_torch.utils.trace import setup_records
    except ImportError:
        return None, None
    return setup_records()


def seconds(record, names) -> float | None:
    """The seconds of the record's spans named in ``names``, summed; None
    where the record is missing or holds none of them."""
    if record is None:
        return None
    got = [s.end_ns - s.start_ns for s in record.spans if s.name in names]
    return sum(got) * 1e-9 if got else None
