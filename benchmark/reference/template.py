"""The reference's own reading of a template directory (the upstream's
pattern files: ``pattern_edge``, ``pattern_vertex_data``, ``pattern_stat``,
``pattern_nlc``, ``pattern_non_local_constraint`` and, where present,
``pattern_vertex_local_constraints``; formats as in the upstream's
graph.hpp:195-260, pattern_graph.hpp:588-623 and pattern_util.hpp:172-278).

Plain Python and numpy; it shares no code with the program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class Constraint:
    labels: list[int]  # label expected at each walk position
    indices: list[int]  # template vertex at each walk position
    cycle_length: int  # the walk takes cycle_length + 1 hops
    valid_cycle: bool  # True: the walk returns to its source
    interleave_lcc: bool  # rerun LCC after this constraint deletes sources
    selected_vertices: bool
    enumeration: list[int]  # k == h: a new vertex; k < h: the vertex at k
    is_tds: bool  # the walk keeps its history (some position revisits one)


@dataclass
class Template:
    k: int  # template vertices
    vertex_labels: list[int]
    diameter: int
    mandatory: list[int]  # bitset of mandatory neighbours per vertex
    optional: list[int]  # bitset of optional neighbours per vertex
    min_optional: list[int]  # -1: no local constraint
    neighbours: list[list[int]]
    constraints: list[Constraint]

    @property
    def adjacent(self) -> list[int]:
        return [m | o for m, o in zip(self.mandatory, self.optional)]

    def label_counts(self) -> tuple[list[int], np.ndarray]:
        """Counting mode: the label classes, and for each template vertex how
        many template neighbours it has of each class."""
        classes = sorted(set(self.vertex_labels))
        req = np.zeros((self.k, len(classes)), dtype=np.int64)
        for i in range(self.k):
            for u in self.neighbours[i]:
                req[i, classes.index(self.vertex_labels[u])] += 1
        return classes, req


def _rows(path: str, sep: str | None = None) -> list[list[str]]:
    with open(path) as f:
        return [line.split(sep) for line in f if line.strip()]


def load(directory: str) -> Template:
    p = os.path.join(directory, "pattern")
    edges = [[int(t) for t in r] for r in _rows(p + "_edge")]
    k = 1 + max(max(r[0], r[1]) for r in edges)
    mand, opt = [0] * k, [0] * k
    nbrs: list[list[int]] = [[] for _ in range(k)]
    for r in edges:
        s, d = r[0], r[1]
        if len(r) < 3 or r[2]:
            mand[s] |= 1 << d
        else:
            opt[s] |= 1 << d
        nbrs[s].append(d)
    vlab = [0] * k
    for r in _rows(p + "_vertex_data"):
        vlab[int(r[0])] = int(r[1])
    diameter = 0
    for r in _rows(p + "_stat", ":"):
        if r[0].strip().lower() == "diameter":
            diameter = int(r[1])
    min_opt = [-1] * k
    if os.path.exists(p + "_vertex_local_constraints"):
        for r in _rows(p + "_vertex_local_constraints", ":"):
            min_opt[int(r[0])] = int(r[1])
    enums = [
        [int(t) for t in r[1].split()] for r in _rows(p + "_non_local_constraint", ":")
    ]
    cons = []
    for i, r in enumerate(_rows(p + "_nlc", ":")):
        indices = [int(t) for t in r[1].split()]
        enum = enums[i] if i < len(enums) else list(range(len(indices)))
        cons.append(Constraint(
            labels=[int(t) for t in r[0].split()],
            indices=indices,
            cycle_length=int(r[2]),
            valid_cycle=bool(int(r[3])),
            interleave_lcc=bool(int(r[4])),
            selected_vertices=bool(int(r[5])),
            enumeration=enum,
            is_tds=any(e < h for h, e in enumerate(enum)),
        ))
    return Template(k, vlab, diameter, mand, opt, min_opt, nbrs, cons)
