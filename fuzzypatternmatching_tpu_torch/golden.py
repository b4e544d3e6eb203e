"""The golden configurations: the graphs and patterns behind the committed
result trees in ``examples/results_golden/`` (``golden_meta.json`` names
each configuration's scale and corpus).

The port's counterpart of ``tools/make_golden.py::build_config``: a 4-rank
unscrambled R-MAT stream at the given scale, degree labels, and a pattern
corpus from ``examples/``, built from the port's own modules.
"""

from __future__ import annotations

import os

import numpy as np

from .generators.rmat import RmatParams, generate_edges
from .graph.csr import degree_labels, from_edges
from .pattern.nonlocal_constraint import load_nonlocal_constraints
from .pattern.pattern_graph import load_pattern_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_BASE = os.path.join(REPO, "examples", "results_golden")


def build_config(scale: int, pattern_prefix: str):
    """(graph, labels, pattern, constraints) of the golden workload at the
    given scale; ``pattern_prefix`` is e.g. ``<dir>/0/pattern``."""
    parts = [
        generate_edges(
            RmatParams(
                seed=5489 + 3 * r,
                vertex_scale=scale,
                edge_count=(16 << scale) // 4,
                scramble=False,
            )
        )
        for r in range(4)
    ]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    g = from_edges(src, dst, num_vertices=1 << scale)
    labels = degree_labels(g)
    pattern = load_pattern_graph(pattern_prefix)
    constraints = load_nonlocal_constraints(pattern_prefix)
    return g, labels, pattern, constraints
