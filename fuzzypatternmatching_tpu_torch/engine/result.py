"""Result containers of the match driver (the port's own copy of
``fuzzypatternmatching_tpu/engine/result.py``), and ``stats_rows``, the LCC
engines' per-superstep stats turned into their rows."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PhaseRow:
    """One convergence-trace row — mirrors the reference's per-superstep
    output (run_pattern_matching_beta.cpp:1086-1125)."""

    itr: int
    phase: str  # "LP" or "TP"
    step: int  # superstep (LP) or constraint index pl (TP)
    active_vertices: int
    active_edges: int
    messages: int
    seconds: float = 0.0
    # optional per-output-rank attribution (cyclic owner = v % num_ranks,
    # matching the reference's non-delegate owner rule, impl ipp:366):
    # arrays of length num_ranks for "av", "ae", "msg"
    per_rank: dict | None = None


@dataclass
class MatchResult:
    rows: list[PhaseRow] = field(default_factory=list)
    iterations: int = 0
    pattern_found: list[bool] = field(default_factory=list)
    subgraphs: dict[int, list[tuple]] = field(default_factory=dict)
    active_vertices: dict[int, int] = field(default_factory=dict)  # v -> tv bits
    active_edges: set = field(default_factory=set)  # (v, nbr) pairs
    total_seconds: float = 0.0
    traversed_edges: int = 0  # total messages/token hops across all phases
    # True iff the driver stopped at max_iterations before the fixpoint
    # (the reference loops unconditionally, beta.cpp:1351) — the active
    # sets are then an over-approximation, and a RuntimeWarning was issued
    truncated: bool = False
    # kept only while a torch profiler records (utils/trace.py): the
    # search's spans (utils.trace.Span, the root fpm.search first) and
    # counters (utils.trace.COUNTERS)
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    def lp_trace(self) -> list[tuple[int, int, int]]:
        return [
            (r.itr, r.step, r.active_vertices) for r in self.rows if r.phase == "LP"
        ]

    def trace(self) -> list[tuple]:
        return [
            (r.itr, r.phase, r.step, r.active_vertices, r.active_edges)
            for r in self.rows
        ]


def stats_rows(st_np, num_ranks: int) -> tuple[list, bool]:
    """The LCC engines' per-superstep stats, host int64 [steps, 3R + 1]
    (av, ae and msg per output rank, then the died flag), as one
    (av, ae, msgs, per_rank) row a superstep, and whether any superstep
    raised the died flag."""
    rr = num_ranks
    rows = []
    for row in st_np:
        per = {
            "av": row[0:rr].copy(),
            "ae": row[rr : 2 * rr].copy(),
            "msg": row[2 * rr : 3 * rr].copy(),
        }
        rows.append(
            (int(per["av"].sum()), int(per["ae"].sum()), int(per["msg"].sum()), per)
        )
    return rows, bool((st_np[:, -1] != 0).any())
