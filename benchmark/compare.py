"""The comparison that decides ``correct``: every layer of a search's result
against the reference's, as counts of what differs. The comparison is
exact, so every limit is 0."""

from __future__ import annotations

from collections import Counter

# the numbers compared, each with its limit
LIMITS = {
    "lp_rows": 0,  # LP trace rows (itr, superstep, vertices, edges, messages)
    "tp_rows": 0,  # TP rows (itr, constraint, vertices, edges, messages)
    "found": 0,  # per-constraint found flags, and the iteration count
    "vertices": 0,  # pruned vertices with their template bits
    "edges": 0,  # active edges
    "subgraphs": 0,  # enumerated subgraphs (a multiset per constraint)
    "traversed": 0,  # |traversed edges - the reference's|
}


def plain(result) -> dict:
    """A program's ``MatchResult`` in the reference's form."""
    return {
        "rows": [
            (r.itr, r.phase, r.step, r.active_vertices, r.active_edges, r.messages)
            for r in result.rows
        ],
        "found": list(result.pattern_found),
        "iterations": result.iterations,
        "vertices": dict(result.active_vertices),
        "edges": set(result.active_edges),
        "subgraphs": {pl: list(s) for pl, s in result.subgraphs.items()},
        "traversed_edges": result.traversed_edges,
    }


def _rows_off(a: list, b: list) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def _multiset(subgraphs: dict) -> Counter:
    return Counter((pl, tuple(s)) for pl, ss in subgraphs.items() for s in ss)


def differences(got: dict, ref: dict) -> dict[str, int]:
    """How far ``got`` lies from ``ref``, one count per number in LIMITS."""
    lp = [r for r in got["rows"] if r[1] == "LP"], [r for r in ref["rows"] if r[1] == "LP"]
    tp = [r for r in got["rows"] if r[1] == "TP"], [r for r in ref["rows"] if r[1] == "TP"]
    gs, rs = _multiset(got["subgraphs"]), _multiset(ref["subgraphs"])
    return {
        "lp_rows": _rows_off(*lp),
        "tp_rows": _rows_off(*tp),
        "found": _rows_off(got["found"], ref["found"])
        + abs(got["iterations"] - ref["iterations"]),
        "vertices": len(set(got["vertices"].items()) ^ set(ref["vertices"].items())),
        "edges": len(got["edges"] ^ ref["edges"]),
        "subgraphs": sum(((gs - rs) + (rs - gs)).values()),
        "traversed": abs(got["traversed_edges"] - ref["traversed_edges"]),
    }


def worst(diffs: list[dict[str, int]]) -> dict[str, int]:
    """The largest count of each number over several results."""
    return {k: max((d[k] for d in diffs), default=0) for k in LIMITS}
