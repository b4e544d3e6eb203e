"""Result directory writer — reproduces the reference's output layout so the
reference's own merge scripts (examples/scripts/total_active_count.py) work
unchanged. The port's own copy of ``fuzzypatternmatching_tpu/io/results.py``
(``write_results``, ``write_vertex_data``); both write the same bytes.

Layout (run_pattern_matching_beta.cpp:504-535, 1086-1125, 1386-1425):

  <out>/result_pattern_set
  <out>/<ps>/result_iteration             "itr, seconds"
  <out>/<ps>/result_step                  "itr, LP, seconds"
  <out>/<ps>/result_superstep             "itr, LP, superstep, seconds" /
                                          "itr, TP, pl, seconds"
  <out>/<ps>/all_ranks_active_vertices_count/active_vertices_<r>
  <out>/<ps>/all_ranks_active_edges_count/active_edges_<r>
  <out>/<ps>/all_ranks_messages/messages_<r>
  <out>/<ps>/all_ranks_active_vertices/active_vertices_<r>
       "rank, vertex, 0, metadata, <16-bit bitset string>"
  <out>/<ps>/all_ranks_active_edges/active_edges_<r>   "rank, vertex, neighbor"
  <out>/<ps>/all_ranks_subgraphs/subgraphs_<pl>_<r>    "[rank], v0, ..., [final]"

Vertices are attributed to output ranks cyclically (owner = v % num_ranks),
matching the reference's non-delegate owner rule.
"""

from __future__ import annotations

import os

import numpy as np

from ..engine.result import MatchResult


def write_vertex_data(
    out_dir: str, labels: np.ndarray, degrees: np.ndarray, num_ranks: int
) -> None:
    """Optional vertex-metadata dump (beta.cpp:379-404:
    ``<out>/0/all_ranks_vertex_data/vertex_data_<r>`` with
    "rank, l, vertex, degree, label" rows; the l/c/d locality codes are
    collapsed to 'l' — there is no delegate distinction here)."""
    base = os.path.join(out_dir, "0", "all_ranks_vertex_data")
    os.makedirs(base, exist_ok=True)
    outs = [
        open(os.path.join(base, f"vertex_data_{r}"), "w")
        for r in range(num_ranks)
    ]
    for v in range(len(labels)):
        r = v % num_ranks
        outs[r].write(f"{r}, l, {v}, {int(degrees[v])}, {int(labels[v])}\n")
    for f in outs:
        f.close()


def write_results(
    out_dir: str,
    ps: int,
    result: MatchResult,
    labels: np.ndarray,
    num_ranks: int,
    pattern_edge_count: int,
    pattern_vertex_count: int,
    num_constraints: int,
) -> None:
    base = os.path.join(out_dir, str(ps))
    for sub in (
        "all_ranks_active_vertices_count",
        "all_ranks_active_edges_count",
        "all_ranks_messages",
        "all_ranks_active_vertices",
        "all_ranks_active_edges",
        "all_ranks_subgraphs",
    ):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    # ---- per-rank convergence-count files -------------------------------
    av_files = [
        open(os.path.join(base, "all_ranks_active_vertices_count", f"active_vertices_{r}"), "w")
        for r in range(num_ranks)
    ]
    ae_files = [
        open(os.path.join(base, "all_ranks_active_edges_count", f"active_edges_{r}"), "w")
        for r in range(num_ranks)
    ]
    msg_files = [
        open(os.path.join(base, "all_ranks_messages", f"messages_{r}"), "w")
        for r in range(num_ranks)
    ]
    with open(os.path.join(base, "result_superstep"), "w") as superstep_f, open(
        os.path.join(base, "result_step"), "w"
    ) as step_f, open(os.path.join(base, "result_iteration"), "w") as itr_f:
        itr_seconds: dict[int, float] = {}
        lp_call_seconds: dict[int, float] = {}
        for row in result.rows:
            superstep_f.write(
                f"{row.itr}, {row.phase}, {row.step}, {row.seconds}\n"
            )
            itr_seconds[row.itr] = itr_seconds.get(row.itr, 0.0) + row.seconds
            if row.phase == "LP":
                lp_call_seconds[row.itr] = (
                    lp_call_seconds.get(row.itr, 0.0) + row.seconds
                )
            per = row.per_rank or {}
            av = per.get("av")
            ae = per.get("ae")
            msg = per.get("msg")
            if num_ranks > 1 and (av is None or ae is None or msg is None):
                # refuse to fabricate attribution: every engine returns real
                # per-rank arrays; an all-on-rank-0 fallback would be
                # indistinguishable from a genuine all-on-rank-0 run
                raise ValueError(
                    f"row (itr={row.itr}, {row.phase}, step={row.step}) has "
                    f"no per-rank attribution but num_ranks={num_ranks}; "
                    "per-rank count files would be wrong per rank"
                )
            for r in range(num_ranks):
                av_r = int(av[r]) if av is not None else (row.active_vertices if r == 0 else 0)
                ae_r = int(ae[r]) if ae is not None else (row.active_edges if r == 0 else 0)
                m_r = int(msg[r]) if msg is not None else (row.messages if r == 0 else 0)
                av_files[r].write(f"{row.itr}, {row.phase}, {row.step}, {av_r}\n")
                ae_files[r].write(f"{row.itr}, {row.phase}, {row.step}, {ae_r}\n")
                msg_files[r].write(f"{row.itr}, {row.phase}, {row.step}, {m_r}\n")
        for itr in sorted(lp_call_seconds):
            step_f.write(f"{itr}, LP, {lp_call_seconds[itr]}\n")
        for itr in sorted(itr_seconds):
            itr_f.write(f"{itr}, {itr_seconds[itr]}\n")
    for f in av_files + ae_files + msg_files:
        f.close()

    # ---- final active sets ----------------------------------------------
    k_bits = 16  # std::bitset<16> printing (beta.cpp:270)
    av_out = [
        open(os.path.join(base, "all_ranks_active_vertices", f"active_vertices_{r}"), "w")
        for r in range(num_ranks)
    ]
    ae_out = [
        open(os.path.join(base, "all_ranks_active_edges", f"active_edges_{r}"), "w")
        for r in range(num_ranks)
    ]
    edges_by_v: dict[int, list[int]] = {}
    for v, u in sorted(result.active_edges):
        edges_by_v.setdefault(v, []).append(u)
    for v in sorted(result.active_vertices):
        r = v % num_ranks
        bits = format(result.active_vertices[v], f"0{k_bits}b")
        av_out[r].write(f"{r}, {v}, 0, {int(labels[v])}, {bits}\n")
        for u in edges_by_v.get(v, []):
            ae_out[r].write(f"{r}, {v}, {u}\n")
    for f in av_out + ae_out:
        f.close()

    # ---- enumerated subgraphs -------------------------------------------
    # canonical (sorted) tuple order: the reference's per-rank files are
    # unordered (parity there is set-equality, SURVEY §7); writing sorted
    # makes our trees byte-for-byte comparable across engines
    for pl, subs in result.subgraphs.items():
        outs = [
            open(os.path.join(base, "all_ranks_subgraphs", f"subgraphs_{pl}_{r}"), "w")
            for r in range(num_ranks)
        ]
        for t in sorted(subs):
            # attributed to the owner of the final vertex (where the
            # reference's accepting visitor runs)
            r = int(t[-1]) % num_ranks
            walk = ", ".join(str(int(x)) for x in t[:-1])
            outs[r].write(f"[{r}], {walk}, [{int(t[-1])}]\n")
        for f in outs:
            f.close()

    # ---- pattern-set summary --------------------------------------------
    with open(os.path.join(out_dir, "result_pattern_set"), "a") as f:
        f.write(
            f"{ps}, {num_ranks}, {result.iterations}, {result.total_seconds}, "
            f"{pattern_edge_count}, {pattern_vertex_count}, {num_constraints}\n"
        )
