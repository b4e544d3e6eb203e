"""Match driver on the torch LCC engine — the prune-to-fixpoint loop.

Counterpart of ``fuzzypatternmatching_tpu/engine/driver.py``: LCC call
(diameter supersteps), forced token passing on iteration 0, per-constraint
NLCC with source invalidation, interleaved LCC re-runs after source
deletions, global fixpoint. LCC runs on the bucketed engine
(``engine/lcc_bucketed.py``) on the given device, with the compact
continuation: after the global init superstep the remaining supersteps run
on an engine rebuilt over the pruned subgraph, on the same device. NLCC
runs on the host engine (``engine/nlcc.py``, the port's copy of the JAX
package's).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..graph.csr import Graph, from_edges
from ..pattern.nonlocal_constraint import NonLocalConstraint
from ..pattern.pattern_graph import PatternGraph
from .lcc_bucketed import BucketedLccEngine
from .nlcc import AliveCsr, ForwardedSets, invalidate_sources, run_nem, run_tds
from .result import MatchResult, PhaseRow


class MatchEngine:
    def __init__(
        self,
        graph: Graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        constraints: list[NonLocalConstraint],
        num_ranks: int = 1,
        lcc_engine: str = "bucketed",
        source_batch: int = 1 << 16,
        nlcc_mode: str = "host",
        counting: bool = False,
        edge_data: np.ndarray | None = None,
        compact: bool = True,
        *,
        device: torch.device | str,
    ):
        if lcc_engine != "bucketed":
            raise ValueError(
                f"lcc_engine={lcc_engine!r}: only 'bucketed' is ported"
            )
        if nlcc_mode != "host":
            raise ValueError(
                f"nlcc_mode={nlcc_mode!r}: only 'host' is ported (the device "
                "NLCC engine is not)"
            )
        if edge_data is not None:
            raise ValueError("edge-metadata matching is not ported")
        if not isinstance(graph, Graph):
            raise TypeError("MatchEngine needs a materialized Graph (storage.load)")
        self.device = torch.device(device)
        self.graph = graph
        self.labels = np.asarray(labels, dtype=np.uint64)
        self.pattern = pattern
        self.constraints = constraints
        self.num_ranks = num_ranks
        self.source_batch = source_batch
        self.lcc = BucketedLccEngine(
            graph, self.labels, pattern, device=self.device,
            num_ranks=num_ranks, counting=counting,
        )
        # compact continuation (run supersteps 1+ on the pruned subgraph) is
        # exact only when every template vertex requires hearing at least
        # one neighbour class; vertices with no alive edges then always die.
        # ``compact=False`` runs every superstep on the full graph.
        self._compact_ok = bool(
            np.all(
                (pattern.edges_bitset != 0)
                | (pattern.min_optional_edge_count > 0)
            )
        )
        self._compact_engine = compact
        # (fp, keys, union, u_rows_uniq, alive_sub_eids, sub): the compact
        # closure and its engine, keyed on the exact alive set
        self._sub_cache: tuple | None = None
        self._edge_keys: np.ndarray | None = None
        self._owner = np.arange(graph.num_vertices, dtype=np.int64) % num_ranks
        # per-constraint token-source label candidates (labels never change)
        self._cands = [
            np.nonzero(self.labels == c.labels[0])[0].astype(np.int64)
            for c in constraints
        ]

    def _edge_index(self, v: int, u: int) -> int:
        """Edge slot of (v, u): binary search within v's sorted CSR row."""
        lo, hi = int(self.graph.row_ptr[v]), int(self.graph.row_ptr[v + 1])
        row_cols = self.graph.cols[lo:hi]
        i = int(np.searchsorted(row_cols, u))
        if i < hi - lo and row_cols[i] == u:
            return lo + i
        return -1

    def _edge_keys_cached(self) -> np.ndarray:
        """Sorted (row*V + col) keys of the graph's edges."""
        if self._edge_keys is None:
            self._edge_keys = self.graph.edge_row.astype(np.uint64) * np.uint64(
                self.graph.num_vertices
            ) + self.graph.cols.astype(np.uint64)
        return self._edge_keys

    def _lcc_phase(
        self, state, global_init: bool, itr: int, result: MatchResult,
        tp_mark_eids=None,
    ):
        """One LCC call. ``tp_mark_eids`` (original CSR edge ids carrying
        token-passing success marks) are translated into the pruned
        subgraph's edge ids, so the compact continuation runs across them."""
        if not (self._compact_ok and self._compact_engine):
            t0 = time.perf_counter()
            state, rows, died = self.lcc.lcc_call(state, global_init)
            dt = (time.perf_counter() - t0) / max(len(rows), 1)
            self._emit_lp_rows(rows, dt, itr, result)
            return state, died

        # compact continuation: the init superstep runs on the full graph;
        # the surviving edge set is typically a tiny fraction of E, so the
        # remaining supersteps run on an engine rebuilt over the pruned
        # subgraph — identical dynamics (see _compact_ok).
        t0 = time.perf_counter()
        died_any = False
        rows_all = []
        steps_left = self.pattern.diameter
        if global_init:
            state, r1, d1 = self.lcc.lcc_call(state, True, n_steps=1)
            rows_all += r1
            died_any = died_any or d1
            steps_left -= 1
        if steps_left > 0:
            tv = self.lcc.tv_host(state)
            arow, acol = self.lcc.alive_pairs(state)
            if len(arow) == 0 or len(arow) > self.graph.num_edges // 4:
                state, r2, d2 = self.lcc.lcc_call(
                    state, False, n_steps=steps_left
                )
                rows_all += r2
                died_any = died_any or d2
            else:
                state, r2, d2 = self._compact_call(
                    tv, arow, acol, steps_left, tp_mark_eids
                )
                rows_all += r2
                died_any = died_any or d2
        dt = (time.perf_counter() - t0) / max(len(rows_all), 1)
        self._emit_lp_rows(rows_all, dt, itr, result)
        return state, died_any

    def _compact_call(self, tv, arow, acol, steps_left, tp_mark_eids):
        """``steps_left`` supersteps on the SYMMETRIC CLOSURE of the alive
        set: a live sender edge (u,v) delivers into receiver slot (v,u) even
        when that slot itself is dead (its message still feeds tn), so
        dead-but-reachable slots exist in the subgraph with alive=False."""
        vv = np.uint64(self.graph.num_vertices)
        keys = arow.astype(np.uint64) * vv + acol.astype(np.uint64)
        fp = (len(keys), int(keys[0]), int(keys[-1]))
        cache = self._sub_cache
        if cache is not None and cache[0] == fp and np.array_equal(keys, cache[1]):
            _, _, union, u_rows_uniq, alive_sub_eids, sub = cache
        else:
            rkeys = acol.astype(np.uint64) * vv + arow.astype(np.uint64)
            union = np.union1d(keys, rkeys)
            u_row = (union // vv).astype(np.int64)
            u_col = (union % vv).astype(np.int64)
            gsub = from_edges(u_row, u_col, num_vertices=self.graph.num_vertices)
            sub = BucketedLccEngine(
                gsub, self.labels, self.pattern, device=self.device,
                num_ranks=self.num_ranks,
            )
            # per-slot aliveness = membership in the original set
            pos = np.minimum(np.searchsorted(keys, union), len(keys) - 1)
            alive_sub_eids = np.nonzero(keys[pos] == union)[0]
            u_rows_uniq = np.unique(u_row)
            self._sub_cache = (fp, keys, union, u_rows_uniq, alive_sub_eids, sub)
        flag_ids = None
        if tp_mark_eids:
            # marks on dead slots are no-ops in the full engine (own_alive
            # gates the flag), so only union hits carry over
            mk = self._edge_keys_cached()[np.asarray(tp_mark_eids, dtype=np.int64)]
            mp = np.minimum(np.searchsorted(union, mk), len(union) - 1)
            flag_ids = mp[union[mp] == mk]
        sub_state = sub.state_from_edge_ids(tv, alive_sub_eids, flag_ids=flag_ids)
        sub_state, rows, died = sub.lcc_call(sub_state, False, n_steps=steps_left)
        # a live vertex with no alive incident edge is outside the closure:
        # the sub engine never sees it, but the full engine would kill it in
        # this call's first superstep and raise the died flag
        live_v = np.nonzero(tv)[0]
        if len(live_v) and not np.isin(live_v, u_rows_uniq).all():
            died = True
        tv2 = sub.tv_host(sub_state)
        a2r, a2c = sub.alive_pairs(sub_state)
        return self._state_from_pairs(tv2, a2r, a2c), rows, died

    def _emit_lp_rows(self, rows, dt, itr, result):
        for s, (av, ae, msgs, per_rank) in enumerate(rows):
            result.rows.append(PhaseRow(itr, "LP", s, av, ae, msgs, dt, per_rank))
            result.traversed_edges += msgs

    def _state_from_pairs(self, tv, arow, acol):
        """Full-engine state with the alive set given as (row, col) pairs —
        lazy (host data only) on the compact path."""
        edge_keys = self._edge_keys_cached()
        keys = arow.astype(np.uint64) * np.uint64(
            self.graph.num_vertices
        ) + acol.astype(np.uint64)
        pos = np.searchsorted(edge_keys, keys)
        eids = pos[edge_keys[np.minimum(pos, len(edge_keys) - 1)] == keys]
        return self.lcc.state_from_edge_ids(tv, eids, lazy=self._compact_engine)

    def _run_constraint(self, pl, c, acsr, tv, forwarded):
        """One NLCC constraint on the host engine."""
        g = self.graph
        # driver-level forwarded-set clearing runs before EVERY constraint
        forwarded.reset_for(c, self.labels, tv, g.num_vertices)
        if c.is_tds:
            return run_tds(
                acsr, self.labels, tv, c, g.num_vertices,
                source_batch=self.source_batch, num_ranks=self.num_ranks,
                forwarded=forwarded, candidates=self._cands[pl],
            )
        return run_nem(
            acsr, self.labels, tv, c, g.num_vertices,
            num_ranks=self.num_ranks, forwarded=forwarded,
            candidates=self._cands[pl],
        )

    def run(self, max_iterations: int = 100) -> MatchResult:
        t_start = time.perf_counter()
        result = MatchResult()
        result.pattern_found = [False] * len(self.constraints)
        g = self.graph
        state = self.lcc.init_state()
        forwarded = ForwardedSets.empty()  # persists across constraints
        global_init = True
        pending_marks: list = []  # TP success marks awaiting the next LCC call
        itr = 0
        while True:
            state, not_finished = self._lcc_phase(
                state, global_init, itr, result,
                tp_mark_eids=pending_marks or None,
            )
            pending_marks = []
            global_init = False
            if itr == 0:
                not_finished = True  # forced token passing on iteration 0
            if not_finished:
                not_finished = False
                # only the (small) alive edge set crosses to the host
                tv = self.lcc.tv_host(state).copy()
                arow, acol = self.lcc.alive_pairs(state)
                tp_marks: list = []
                # the pruned adjacency changes only via LCC; reuse it across
                # constraints (deactivated vertices are filtered by the
                # arrival checks)
                acsr = None
                for pl, c in enumerate(self.constraints):
                    t0 = time.perf_counter()
                    if acsr is None:
                        acsr = AliveCsr.from_pairs(
                            arow, acol, tv != 0, g.num_vertices
                        )
                    out = self._run_constraint(pl, c, acsr, tv, forwarded)
                    if c.is_tds:
                        subs = result.subgraphs.setdefault(pl, [])
                        if out.subgraphs is not None and len(out.subgraphs):
                            subs.extend(map(tuple, out.subgraphs.tolist()))
                    if bool(out.validated.any()):
                        result.pattern_found[pl] = True
                    for v, p in out.edge_marks:
                        e = self._edge_index(v, p)
                        if e >= 0:
                            tp_marks.append(e)
                    deleted = invalidate_sources(tv, c, out)
                    if deleted:
                        not_finished = True
                    live = tv != 0
                    live_rows = live[arow]
                    per_rank = {
                        "av": np.bincount(
                            self._owner[live], minlength=self.num_ranks
                        ),
                        "ae": np.bincount(
                            self._owner[arow[live_rows]],
                            minlength=self.num_ranks,
                        ),
                        "msg": out.msg_per_rank
                        if out.msg_per_rank is not None
                        else np.zeros(self.num_ranks, dtype=np.int64),
                    }
                    result.rows.append(
                        PhaseRow(
                            itr, "TP", pl, int(live.sum()),
                            int(live_rows.sum()), out.messages,
                            time.perf_counter() - t0, per_rank,
                        )
                    )
                    result.traversed_edges += out.messages
                    if deleted and c.interleave_lcc:
                        state = self.lcc.with_updates(state, tv, tp_marks)
                        # tp success marks are carried into the compact
                        # subgraph's edge ids (tp_mark_eids)
                        state, died = self._lcc_phase(
                            state, False, itr, result, tp_mark_eids=tp_marks
                        )
                        if died:
                            not_finished = True
                        tv = self.lcc.tv_host(state).copy()
                        arow, acol = self.lcc.alive_pairs(state)
                        tp_marks = []
                        acsr = None  # pruned adjacency changed
                state = self.lcc.with_updates(state, tv, tp_marks)
                pending_marks = list(tp_marks)
            itr += 1
            if not not_finished:
                break
            if itr >= max_iterations:
                # a truncated search is NOT a fixpoint: fail loudly
                result.truncated = True
                warnings.warn(
                    f"search truncated at max_iterations={max_iterations} "
                    "before reaching the LCC/NLCC fixpoint; the returned "
                    "active sets are an over-approximation "
                    "(MatchResult.truncated=True)",
                    RuntimeWarning,
                    stacklevel=2,
                )
                break

        result.iterations = itr
        tv = self.lcc.tv_host(state)
        arow, acol = self.lcc.alive_pairs(state)
        keep = (tv != 0)[arow]
        result.active_edges = {
            (int(r), int(c)) for r, c in zip(arow[keep], acol[keep])
        }
        result.active_vertices = {int(v): int(tv[v]) for v in np.nonzero(tv)[0]}
        result.total_seconds = time.perf_counter() - t_start
        return result
