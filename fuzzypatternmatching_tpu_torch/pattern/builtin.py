"""Built-in pattern corpora.

``rmat_log2_tree``: the reference's conformance corpus
(examples/rmat_log2_tree_pattern/0/ — a 7-vertex tree over degree-class
labels, diameter 8, four nem-style path constraints plus one full-template
TDS enumeration walk). Materialized on demand so drivers and benches don't
depend on the reference checkout.
"""

from __future__ import annotations

import os

RMAT_LOG2_TREE = {
    "pattern_edge": (
        "0 1\n1 0\n1 2\n1 3\n2 1\n3 1\n3 5\n4 5\n5 3\n5 4\n5 6\n6 5\n"
    ),
    "pattern_vertex_data": "0 3\n1 4\n2 7\n3 2\n4 3\n5 5\n6 7\n",
    "pattern_stat": "diameter : 8\n",
    "pattern_nlc": (
        "3 5 2 4 3 : 4 5 3 1 0 : 3 : 0 : 1 : 0\n"
        "3 4 2 5 3 : 0 1 3 5 4 : 3 : 0 : 1 : 0\n"
        "7 4 2 5 7 : 2 1 3 5 6 : 3 : 0 : 1 : 0\n"
        "7 5 2 4 7 : 6 5 3 1 2 : 3 : 0 : 1 : 0\n"
        "3 4 7 4 2 5 3 5 7 : 0 1 2 1 3 5 4 5 6 : 7 : 0 : 1 : 0\n"
    ),
    "pattern_non_local_constraint": (
        "4 5 3 1 0 : 0 1 2 3 4 : 0 0 0 0 0\n"
        "0 1 3 5 4 : 0 1 2 3 4 : 0 0 0 0 0\n"
        "2 1 3 5 6 : 0 1 2 3 4 : 0 0 0 0 0\n"
        "6 5 3 1 2 : 0 1 2 3 4 : 0 0 0 0 0\n"
        "0 1 2 1 3 5 4 5 6 : 0 1 2 1 4 5 6 5 8 : 0 1 1 1 1 1 1 1 1\n"
    ),
    # src dst edge-id value (graph.hpp:209-222); the reference corpus
    # carries a single value (55) on every pattern edge — with it, a graph
    # whose edges all carry 55 searches identically to no-metadata mode
    "pattern_edge_data": (
        "0 1 0 55\n1 0 0 55\n1 2 1 55\n1 3 2 55\n2 1 1 55\n3 1 2 55\n"
        "3 5 3 55\n4 5 4 55\n5 3 3 55\n5 4 4 55\n5 6 5 55\n6 5 5 55\n"
    ),
}


def materialize_tree_pattern(directory: str) -> str:
    """Write the rmat_log2_tree corpus into ``<directory>/0/`` and return the
    pattern prefix (``<directory>/0/pattern``)."""
    sub = os.path.join(directory, "0")
    os.makedirs(sub, exist_ok=True)
    for name, content in RMAT_LOG2_TREE.items():
        with open(os.path.join(sub, name), "w") as f:
            f.write(content)
    return os.path.join(sub, "pattern")


def load_tree_pattern(tmp_dir: str):
    """Materialize and parse the tree corpus: returns (PatternGraph,
    constraints)."""
    from .nonlocal_constraint import load_nonlocal_constraints
    from .pattern_graph import load_pattern_graph

    prefix = materialize_tree_pattern(tmp_dir)
    p = load_pattern_graph(prefix)
    return p, load_nonlocal_constraints(prefix, p.vertex_data)
