"""Non-local constraint (NLC) lists — token-passing walk specifications.

Two on-disk formats are supported:

* Legacy pair of files (reference: include/havoqgt/pattern_util.hpp:172-278,
  used by run_pattern_matching_beta.cpp:474-479):
    - ``pattern_nlc`` — per line
      ``labels : walk template-vertex indices : cycle_length : valid_cycle :
        interleave_LP : selected_vertices``
    - ``pattern_non_local_constraint`` — per line
      ``walk indices : enumeration indices : aggregation steps``
* APM single file ``pattern_non_local_constraints`` (reference:
  approximate_pattern_matching/pattern_non_local_constraint.hpp:200-250):
  per line ``walk vertices : enumeration indices : aggregation steps :
  is_cyclic : is_TDS : invoke_interleaved_LCC`` with labels derived from the
  pattern graph.

Semantics of one constraint (see
token_passing_pattern_matching_nonunique_nem_1.hpp and ..._tds_batch_1.hpp):
tokens start at ``indices[0]`` and take ``cycle_length + 1`` hops; a token at
hop ``h`` sits on a graph vertex matching ``labels[h]``/``indices[h]``.
``valid_cycle=True``: the walk must return to its source (cycle check);
``False``: it must end anywhere else (path check — distinct same-label
instance). Enumeration indices encode the TDS walk-history rules: entry
``k == h`` means "position h must be a new vertex", ``k < h`` means
"position h must equal the vertex at position k".
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class NonLocalConstraint:
    labels: np.ndarray  # uint64 [walk_len] expected vertex labels
    indices: np.ndarray  # int64 [walk_len] template-vertex index per hop
    cycle_length: int  # max_itr_count; walk_len == cycle_length + 2
    valid_cycle: bool  # True: cycle check; False: path check
    interleave_lcc: bool  # rerun LCC if this constraint deleted sources
    selected_vertices: bool  # "work aggregation" source filtering mode
    enumeration: np.ndarray = field(default=None)  # int64 [walk_len]
    aggregation: np.ndarray = field(default=None)  # uint8 [walk_len]
    is_tds: bool = False  # carry full walk history (enumeration/TDS engine)

    @property
    def walk_len(self) -> int:
        return len(self.labels)

    def __post_init__(self):
        if self.enumeration is None:
            self.enumeration = np.arange(self.walk_len, dtype=np.int64)
        if self.aggregation is None:
            self.aggregation = np.zeros(self.walk_len, dtype=np.uint8)


def _split_fields(line: str) -> list[str]:
    return [t.strip() for t in line.split(":")]


def load_nonlocal_constraints(
    pattern_prefix: str, pattern_vertex_data: np.ndarray | None = None
) -> list[NonLocalConstraint]:
    """Load the NLC list for a pattern directory prefix (``<dir>/0/pattern``).

    Prefers the legacy pair (``_nlc`` + ``_non_local_constraint``); falls back
    to the APM single-file format (``_non_local_constraints``), which needs
    ``pattern_vertex_data`` to derive per-hop labels
    (pattern_non_local_constraint.hpp:222-247).
    """
    nlc_path = pattern_prefix + "_nlc"
    enum_path = pattern_prefix + "_non_local_constraint"
    apm_path = pattern_prefix + "_non_local_constraints"

    out: list[NonLocalConstraint] = []
    if os.path.exists(nlc_path):
        with open(nlc_path) as f:
            nlc_lines = [l for l in f if l.strip()]
        enum_rows: list[tuple[np.ndarray, np.ndarray]] = []
        if os.path.exists(enum_path):
            with open(enum_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    fields = _split_fields(line)
                    enum_rows.append(
                        (
                            np.array([int(t) for t in fields[1].split()], dtype=np.int64),
                            np.array([int(t) for t in fields[2].split()], dtype=np.uint8)
                            if len(fields) > 2
                            else None,
                        )
                    )
        for i, line in enumerate(nlc_lines):
            fields = _split_fields(line)
            labels = np.array([int(t) for t in fields[0].split()], dtype=np.uint64)
            indices = np.array([int(t) for t in fields[1].split()], dtype=np.int64)
            enum_i = enum_rows[i][0] if i < len(enum_rows) else None
            agg_i = enum_rows[i][1] if i < len(enum_rows) else None
            # The reference driver picks the TDS engine per-constraint with a
            # corpus-specific hardcode (run_pattern_matching_beta.cpp:745-762:
            # ``if (pl >= 4) do_tds_tp = true`` for the RMAT tree corpus). We
            # generalize: a walk whose enumeration indices revisit an earlier
            # position needs the full walk history, i.e. the TDS engine.
            is_tds = bool(enum_i is not None and np.any(enum_i < np.arange(len(enum_i))))
            out.append(
                NonLocalConstraint(
                    labels=labels,
                    indices=indices,
                    cycle_length=int(fields[2]),
                    valid_cycle=bool(int(fields[3])),
                    interleave_lcc=bool(int(fields[4])),
                    selected_vertices=bool(int(fields[5])),
                    enumeration=enum_i,
                    aggregation=agg_i,
                    is_tds=is_tds,
                )
            )
        return out

    if os.path.exists(apm_path):
        if pattern_vertex_data is None:
            raise ValueError("APM NLC format requires pattern vertex labels")
        with open(apm_path) as f:
            for line in f:
                if not line.strip():
                    continue
                fields = _split_fields(line)
                indices = np.array([int(t) for t in fields[0].split()], dtype=np.int64)
                enum_i = np.array([int(t) for t in fields[1].split()], dtype=np.int64)
                agg_i = np.array([int(t) for t in fields[2].split()], dtype=np.uint8)
                is_cyclic = bool(int(fields[3]))
                is_tds = bool(int(fields[4]))
                interleave = bool(int(fields[5])) if len(fields) > 5 else True
                labels = pattern_vertex_data[indices].astype(np.uint64)
                out.append(
                    NonLocalConstraint(
                        labels=labels,
                        indices=indices,
                        cycle_length=len(indices) - 2,
                        valid_cycle=is_cyclic,
                        interleave_lcc=interleave,
                        selected_vertices=False,
                        enumeration=enum_i,
                        aggregation=agg_i,
                        is_tds=is_tds,
                    )
                )
        return out

    return out
