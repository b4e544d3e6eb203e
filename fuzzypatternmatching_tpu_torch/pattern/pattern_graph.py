"""Pattern template graph — parses the reference's pattern directory format.
The port's own copy of ``fuzzypatternmatching_tpu/pattern/pattern_graph.py``
(the counting and edge-metadata tables are left out with those modes).

File formats (reference: include/havoqgt/graph.hpp:195-260 and
include/havoqgt/approximate_pattern_matching/pattern_graph.hpp:129-161,
588-623):

* ``pattern_edge``: one directed entry per line ``src dst [is_mandatory]``;
  both directions of each undirected template edge are listed. The optional
  third column is the APM fuzzy extension: 0 = optional edge, 1 = mandatory
  (pattern_graph.hpp[apm]:588-601; note the reference variable name
  ``edge_is_optional`` actually stores "is mandatory" — see
  generate_vertex_edges_bitset, :604-623).
* ``pattern_vertex_data``: ``vertex label`` per line.
* ``pattern_stat``: a ``diameter : D`` line.
* ``pattern_vertex_local_constraints`` (APM only): ``vertex : min_count``
  per line, -1 when the vertex has no optional edges
  (pattern_graph.hpp[apm]:282-315).

The template is capped at 16 vertices — all candidate sets are uint16
bitsets (run_pattern_matching_beta.cpp:270-271).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

MAX_TEMPLATE_VERTICES = 16


@dataclass
class PatternGraph:
    """CSR of the pattern template plus per-vertex constraint bitsets."""

    vertex_count: int
    edge_count: int
    row_ptr: np.ndarray  # int64 [vertex_count + 1]
    cols: np.ndarray  # int64 [edge_count] neighbor template-vertex indices
    vertex_data: np.ndarray  # uint64 [vertex_count] labels
    diameter: int
    # uint16 bitsets per template vertex (APM fuzzy support;
    # pattern_graph.hpp[apm]:604-623). For legacy patterns every edge is
    # mandatory: edges_bitset == edges_bitset_all, optional == 0.
    edges_bitset: np.ndarray = field(default=None)  # mandatory-neighbor bits
    edges_bitset_optional: np.ndarray = field(default=None)
    edges_bitset_all: np.ndarray = field(default=None)
    min_optional_edge_count: np.ndarray = field(default=None)  # int64, -1 = none
    # per directed pattern edge (aligned with ``cols``): the metadata value a
    # data edge must carry to map onto this pattern edge. Parsed from
    # ``pattern_edge_data`` (graph.hpp:209-222 reads ``src dst edge_id w``
    # rows); None when the file is absent. Only the edge-metadata matching
    # mode enforces it, and the port does not run that mode yet.
    edge_data: np.ndarray = field(default=None)  # int64 [edge_count] | None

    def __post_init__(self):
        k = self.vertex_count
        if self.edges_bitset is None:
            bits = np.zeros(k, dtype=np.uint16)
            for v in range(k):
                for e in range(self.row_ptr[v], self.row_ptr[v + 1]):
                    bits[v] |= np.uint16(1 << int(self.cols[e]))
            self.edges_bitset = bits
        if self.edges_bitset_optional is None:
            self.edges_bitset_optional = np.zeros(k, dtype=np.uint16)
        if self.edges_bitset_all is None:
            self.edges_bitset_all = self.edges_bitset | self.edges_bitset_optional
        if self.min_optional_edge_count is None:
            self.min_optional_edge_count = np.full(k, -1, dtype=np.int64)

    def label_match_bitset(self, labels: np.ndarray) -> np.ndarray:
        """uint16 candidate bitset per graph vertex: bit i set iff
        labels[v] == vertex_data[i] (lppm init step,
        label_propagation_pattern_matching_nonunique_ee.hpp:521-536)."""
        tv = np.zeros(labels.shape, dtype=np.uint16)
        for i in range(self.vertex_count):
            tv |= np.where(labels == self.vertex_data[i], np.uint16(1 << i), np.uint16(0))
        return tv


def _read_tokens(path: str) -> list[list[str]]:
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if toks:
                rows.append(toks)
    return rows


def load_pattern_graph(pattern_prefix: str) -> PatternGraph:
    """Load ``<prefix>_edge``, ``<prefix>_vertex_data``, ``<prefix>_stat``
    and, if present, ``<prefix>_vertex_local_constraints``.

    ``pattern_prefix`` is e.g. ``<dir>/0/pattern`` — matching the driver's
    naming (run_pattern_matching_beta.cpp:433-441).

    ``<prefix>_vertex`` is deliberately NOT read: every shipped reference
    driver passes ``_edge`` first, selecting the pattern_graph_csr /
    ::graph constructors whose ``read_vertex_list`` call is commented out
    (pattern_graph.hpp:62, 96; graph.hpp:62) — the vertex list is always
    regenerated from the edge list (``generate_vertex_list``). The
    explicit-vertex-list reader (graph.hpp:165-178) is reachable only
    through the vertex-file-first constructor no driver invokes, and the
    corpus ships an empty ``pattern_vertex``. Deriving vertices from
    edges here is therefore behaviorally exact, not an approximation.
    """
    edge_rows = _read_tokens(pattern_prefix + "_edge")
    srcs = np.array([int(r[0]) for r in edge_rows], dtype=np.int64)
    dsts = np.array([int(r[1]) for r in edge_rows], dtype=np.int64)
    # APM optional-edge column: third field is "is mandatory" (0 = optional)
    has_flags = any(len(r) >= 3 for r in edge_rows)
    mand = np.array(
        [int(r[2]) if len(r) >= 3 else 1 for r in edge_rows], dtype=np.int64
    )

    vertex_count = int(max(srcs.max(), dsts.max())) + 1 if len(srcs) else 0
    if vertex_count > MAX_TEMPLATE_VERTICES:
        raise ValueError(f"template has {vertex_count} vertices; max is 16")

    # edge metadata file: ``src dst edge_id w`` rows aligned with the
    # pattern_edge listing (graph.hpp:209-222)
    edata = None
    ed_path = pattern_prefix + "_edge_data"
    if os.path.exists(ed_path):
        ed_rows = _read_tokens(ed_path)
        if len(ed_rows) == len(edge_rows):
            edata = np.array([int(r[3]) for r in ed_rows], dtype=np.int64)

    # CSR in file order (the reference reads edges as-listed, sorted by src;
    # graph.hpp:224-260 generates the vertex list assuming that order)
    order = np.argsort(srcs, kind="stable")
    srcs, dsts, mand = srcs[order], dsts[order], mand[order]
    if edata is not None:
        edata = edata[order]
    row_ptr = np.zeros(vertex_count + 1, dtype=np.int64)
    np.add.at(row_ptr, srcs + 1, 1)
    row_ptr = np.cumsum(row_ptr)

    vdata = np.zeros(vertex_count, dtype=np.uint64)
    for r in _read_tokens(pattern_prefix + "_vertex_data"):
        vdata[int(r[0])] = np.uint64(r[1])

    diameter = 0
    with open(pattern_prefix + "_stat") as f:
        for line in f:
            parts = [t.strip() for t in line.split(":")]
            if len(parts) >= 2 and parts[0].lower() == "diameter":
                diameter = int(parts[1])

    eb = np.zeros(vertex_count, dtype=np.uint16)
    ebo = np.zeros(vertex_count, dtype=np.uint16)
    for s, d, m in zip(srcs, dsts, mand):
        if m:
            eb[s] |= np.uint16(1 << d)
        else:
            ebo[s] |= np.uint16(1 << d)

    min_opt = np.full(vertex_count, -1, dtype=np.int64)
    lc_path = pattern_prefix + "_vertex_local_constraints"
    if os.path.exists(lc_path):
        with open(lc_path) as f:
            rows = []
            for line in f:
                parts = [t.strip() for t in line.split(":")]
                if len(parts) >= 2:
                    rows.append((int(parts[0]), int(parts[1])))
            for v, c in rows:
                min_opt[v] = c

    return PatternGraph(
        vertex_count=vertex_count,
        edge_count=len(srcs),
        row_ptr=row_ptr,
        cols=dsts,
        vertex_data=vdata,
        diameter=diameter,
        edges_bitset=eb,
        edges_bitset_optional=ebo,
        edges_bitset_all=eb | ebo,
        min_optional_edge_count=min_opt,
        edge_data=edata,
    )
