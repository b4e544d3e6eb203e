"""Conformance oracle — a faithful, slow Python implementation of the
reference search loop, used as ground truth for the TPU engine's tests.
The port's own copy of ``fuzzypatternmatching_tpu/engine/oracle.py``: the
ground truth of the port's engines too (tests/test_torch_engine_vs_oracle.py,
cli/sharded_lcc_demo.py).

It mirrors, phase by phase, run_pattern_matching_beta.cpp:544-1351 with the
kernels:

* LCC: label_propagation_pattern_matching_nonunique_ee.hpp (bsp entry :1033)
  extended with the APM fuzzy acceptance rule
  (approximate_pattern_matching/local_constraint_checking.hpp:1062-1113);
  for all-mandatory templates the two coincide.
* NLCC: token_passing_pattern_matching_nonunique_nem_1.hpp (path/cycle
  checking with the per-(vertex,source) forwarded-token cache).
* TDS enumeration: token_passing_pattern_matching_nonunique_tds_batch_1.hpp
  (full walk history, enumeration index rules, subgraph emission).

Determinism note: the reference's async visitor engine forwards at most one
token per (vertex, source) per constraint run, the winner being whichever
message arrives first (nem_1.hpp:131-139, 270-286). Arrival order is
schedule-dependent in MPI. This oracle (and the TPU engine) fixes a
deterministic rule: breadth-synchronous supersteps, and among same-superstep
arrivals at (v, source) the token with the smallest parent id wins. LCC is
order-independent, so its trace matches any reference schedule exactly; the
NLCC *accept/reject decision per source* is order-independent in all
non-adversarial cases (acceptance only requires some walk to survive).
"""

from __future__ import annotations


import numpy as np

from ..graph.csr import Graph
from .result import MatchResult, PhaseRow
from ..pattern.nonlocal_constraint import NonLocalConstraint
from ..pattern.pattern_graph import PatternGraph


class MatchOracle:
    def __init__(
        self,
        graph: Graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        constraints: list[NonLocalConstraint],
        counting: bool = False,
        edge_data: np.ndarray | None = None,
        num_ranks: int = 1,
    ):
        # output-rank attribution: cyclic owner = v % num_ranks (ipp:366);
        # messages are attributed to the RECEIVER's owner, matching every
        # engine (beta.cpp:1112-1125 per-rank count files)
        self.num_ranks = num_ranks
        self.g = graph
        self.labels = np.asarray(labels, dtype=np.uint64)
        self.p = pattern
        self.constraints = constraints
        # edge-metadata-constrained matching (opt-in; the reference stores
        # edge metadata — edge_data_db.hpp — but its shipped drivers never
        # enforce it, beta.cpp:575): a data edge carrying metadata m can map
        # onto pattern edge (p, q) only when the pattern requires m there.
        # Active iff BOTH the graph metadata and a pattern _edge_data file
        # are present. Direction convention: the receiver-side slot (v, u)
        # is looked up; symmetrized streams carry the value both ways.
        if edge_data is not None and pattern.edge_data is not None:
            self._meta_vals, self._meta_allow = pattern.edge_meta_tables()
            ed = np.asarray(edge_data, dtype=np.int64)
            pos = np.searchsorted(self._meta_vals, ed)
            pos_c = np.minimum(pos, len(self._meta_vals) - 1)
            code = np.where(
                self._meta_vals[pos_c] == ed, pos_c, len(self._meta_vals)
            )
            self._meta_code = code.astype(np.int64)  # per graph edge id
        else:
            self._meta_allow = None
            self._meta_code = None
        # counting-LCC mode (label_propagation_pattern_matching_nonunique_
        # counting_ee.hpp): template vertex i additionally requires hearing
        # from >= required[i, j] distinct valid-parent neighbors of each
        # label class j (pattern.neighbor_label_counts docstring)
        self.counting = counting
        if counting:
            self._class_labels, self._required = pattern.neighbor_label_counts()
        v = graph.num_vertices
        self.active = np.ones(v, dtype=bool)
        self.tv = np.zeros(v, dtype=np.uint32)  # template_vertices bitsets
        # vertex_active_edges_map: v -> {nbr: flag}
        self.alive: list[dict[int, int]] = [dict() for _ in range(v)]
        # vertex_token_source_set: v -> sources whose tokens v forwarded;
        # persists across constraints for the selected-vertices work
        # aggregation (beta.cpp:791-852)
        self.token_source_sets: dict[int, set[int]] = {}
        # per-template-vertex "any valid parent" masks
        self._adj_all = pattern.edges_bitset_all.astype(np.uint32)
        self._label_tv = pattern.label_match_bitset(self.labels).astype(np.uint32)

    # ------------------------------------------------------------------ LCC

    def _accept_mask(self, cand: int) -> int:
        """OR of pattern adjacency bitsets over the set bits of cand — a
        message with parent bits P is a valid-parent message iff
        P & mask != 0 (nonunique_ee.hpp:1000-1027)."""
        m = 0
        i = 0
        c = cand
        while c:
            if c & 1:
                m |= int(self._adj_all[i])
            c >>= 1
            i += 1
        return m

    def _edge_meta_row(self, v: int, u: int) -> np.ndarray:
        """Per-template-vertex allowed-parent masks for the slot (v, u):
        ``row[i]`` = parents deliverable toward receiver bit i through this
        edge, given its metadata (all-zero row for values no pattern edge
        requires)."""
        lo, hi = int(self.g.row_ptr[v]), int(self.g.row_ptr[v + 1])
        i = lo + int(np.searchsorted(self.g.cols[lo:hi], u))
        return self._meta_allow[int(self._meta_code[i])]

    def _hop_meta_ok(self, v: int, parent: int, wcode: int) -> bool:
        """Token-passing hop check: the traversed data edge (parent -> v)
        must carry the metadata value (as a code into ``_meta_vals``)
        required by the pattern edge this hop maps onto. Graphs are
        symmetrized with symmetric metadata (like the reference's streams),
        so sender-side lookup equals the LCC's receiver-side convention."""
        lo, hi = int(self.g.row_ptr[parent]), int(self.g.row_ptr[parent + 1])
        i = lo + int(np.searchsorted(self.g.cols[lo:hi], v))
        return int(self._meta_code[i]) == wcode

    def _constraint_ok(self, i: int, tn: int) -> bool:
        """APM per-template-vertex acceptance
        (local_constraint_checking.hpp:1062-1113)."""
        mand = int(self.p.edges_bitset[i])
        ok_mand = mand == 0 or (mand & tn) == mand
        opt_min = int(self.p.min_optional_edge_count[i])
        if opt_min > 0:
            ob = int(self.p.edges_bitset_optional[i])
            t = ob & tn
            # the reference requires *all* optional-neighbor classes heard
            # AND the count threshold (local_constraint_checking.hpp:1092-1099)
            ok_opt = t == ob and bin(t).count("1") >= opt_min
        else:
            ok_opt = True
        return ok_mand and ok_opt

    def lcc_call(self, global_init_step: bool, itr: int, result: MatchResult) -> bool:
        """One label_propagation_pattern_matching_bsp call: ``diameter``
        supersteps. Returns True if any vertex was invalidated."""
        not_finished = False
        for s in range(self.p.diameter):
            init = s == 0 and global_init_step
            msgs = []
            if init:
                # first superstep of the first call: derive candidates from
                # labels, send along the original graph
                for v in range(self.g.num_vertices):
                    if not self.active[v]:
                        continue
                    cand = int(self._label_tv[v])
                    if cand == 0:
                        self.active[v] = False
                        self.tv[v] = 0
                    else:
                        self.tv[v] = cand
                for v in range(self.g.num_vertices):
                    if self.active[v] and self.tv[v]:
                        for nbr in self.g.neighbors(v):
                            msgs.append((int(nbr), v, int(self.tv[v])))
            else:
                for v in range(self.g.num_vertices):
                    if self.active[v] and self.tv[v]:
                        for nbr in list(self.alive[v].keys()):
                            msgs.append((nbr, v, int(self.tv[v])))

            # deliver: accumulate template_neighbors, mark active edges
            tn: dict[int, int] = {}
            # metadata mode: per-receiver-bit accumulation — tn_meta[v][i]
            # holds only parents deliverable toward bit i through an edge
            # whose metadata the pattern edge (parent-bit, i) requires
            tn_meta: dict[int, list[int]] = {}
            # counting mode: cnts[v][(i, j)] = distinct valid-parents-for-i
            # of label class j heard this superstep (counting_ee.hpp:784-790)
            cnts: dict[int, dict[tuple[int, int], int]] = {}
            for v, parent, bits in msgs:
                if not self.active[v] or self.tv[v] == 0:
                    continue
                if self._meta_allow is not None:
                    row = self._edge_meta_row(v, parent)
                    amask = 0
                    tvv = int(self.tv[v])
                    for i in range(self.p.vertex_count):
                        if tvv >> i & 1:
                            amask |= int(row[i])
                    if bits & amask == 0:
                        continue  # no valid parent through this edge
                    tm = tn_meta.setdefault(v, [0] * self.p.vertex_count)
                    for i in range(self.p.vertex_count):
                        tm[i] |= bits & int(row[i])
                else:
                    row = self._adj_all
                    if bits & self._accept_mask(int(self.tv[v])) == 0:
                        continue  # no valid parent among sender's bits
                    tn[v] = tn.get(v, 0) | bits
                if self.counting:
                    j = int(
                        np.searchsorted(self._class_labels, self.labels[parent])
                    )
                    if (
                        j < len(self._class_labels)
                        and self._class_labels[j] == self.labels[parent]
                    ):
                        cv = cnts.setdefault(v, {})
                        for i in range(self.p.vertex_count):
                            if bits & int(row[i]):
                                cv[(i, j)] = cv.get((i, j), 0) + 1
                if init:
                    self.alive[v][parent] = 1
                elif parent in self.alive[v]:
                    self.alive[v][parent] = 1
                # (s>0 accept for an erased edge entry still contributes to
                # tn but cannot resurrect the edge — nonunique_ee.hpp:790-814)

            # verify_and_update_vertex_state (nonunique_ee.hpp:829-1027)
            meta = self._meta_allow is not None
            for v in range(self.g.num_vertices):
                if not self.active[v] or self.tv[v] == 0:
                    continue
                if v not in (tn_meta if meta else tn):
                    if init:
                        # valid label but heard no valid parent: not in map
                        self.active[v] = False
                        self.tv[v] = 0
                        self.alive[v].clear()
                        continue
                    tn_v = 0
                    tm_v = [0] * self.p.vertex_count
                else:
                    tn_v = tn.get(v, 0)
                    tm_v = tn_meta.get(v, [0] * self.p.vertex_count)
                cand = int(self.tv[v])
                for i in range(self.p.vertex_count):
                    if cand >> i & 1 and not self._constraint_ok(
                        i, tm_v[i] if meta else tn_v
                    ):
                        cand &= ~(1 << i)
                    elif cand >> i & 1 and self.counting:
                        cv = cnts.get(v, {})
                        for j in range(len(self._class_labels)):
                            req = int(self._required[i, j])
                            if req > 0 and cv.get((i, j), 0) < req:
                                cand &= ~(1 << i)
                                break
                if cand == 0:
                    self.active[v] = False
                    self.tv[v] = 0
                    self.alive[v].clear()
                    not_finished = True
                else:
                    self.tv[v] = cand
                    for nbr in [n for n, f in self.alive[v].items() if not f]:
                        del self.alive[v][nbr]
                    for nbr in self.alive[v]:
                        self.alive[v][nbr] = 0

            av_r, ae_r = self._per_rank_counts()
            msg_r = np.zeros(self.num_ranks, dtype=np.int64)
            for rv, _p, _b in msgs:
                msg_r[rv % self.num_ranks] += 1
            result.rows.append(
                PhaseRow(
                    itr, "LP", s, *self._counts(), len(msgs),
                    per_rank={"av": av_r, "ae": ae_r, "msg": msg_r},
                )
            )
        return not_finished

    def _counts(self) -> tuple[int, int]:
        av = int(np.sum(self.tv != 0))
        ae = sum(len(self.alive[v]) for v in range(self.g.num_vertices) if self.tv[v])
        return av, ae

    def _per_rank_counts(self) -> tuple[np.ndarray, np.ndarray]:
        R = self.num_ranks
        av_r = np.zeros(R, dtype=np.int64)
        ae_r = np.zeros(R, dtype=np.int64)
        for v in range(self.g.num_vertices):
            if self.tv[v]:
                av_r[v % R] += 1
                ae_r[v % R] += len(self.alive[v])
        return av_r, ae_r

    # ----------------------------------------------------------------- NLCC

    def _token_sources(self, c: NonLocalConstraint) -> list[int]:
        out = []
        lbl0 = int(c.labels[0])
        bit0 = int(c.indices[0])
        bitl = int(c.indices[-1])
        for v in range(self.g.num_vertices):
            if not self.active[v] or int(self.labels[v]) != lbl0:
                continue
            tvv = int(self.tv[v])
            if tvv == 0 or not (tvv >> bit0 & 1):
                continue
            if not c.is_tds and not c.valid_cycle and not c.selected_vertices:
                # path checking: the source must also be a candidate for the
                # walk's other endpoint (nem_1.hpp:435-448)
                if not (tvv >> bitl & 1):
                    continue
            out.append(v)
        return out

    def _reset_token_source_sets(self, c: NonLocalConstraint):
        """Driver-level clearing between constraints (beta.cpp:791-852):
        non-selected constraints clear everything; selected constraints keep
        the sets of active final-label (destination) vertices."""
        if not c.selected_vertices:
            self.token_source_sets.clear()
            return
        lbl_last = int(c.labels[-1])
        for v in list(self.token_source_sets):
            if not (self.active[v] and int(self.labels[v]) == lbl_last):
                del self.token_source_sets[v]

    def nlcc_call(self, c: NonLocalConstraint, pl: int, result: MatchResult):
        """One token-passing run. Returns (token_source_map, messages)."""
        self._reset_token_source_sets(c)
        sources = self._token_sources(c)
        if c.selected_vertices and not c.is_tds:
            # the map holds destinations only: every active final-label
            # vertex (nem_1.hpp:414-432); validation marks destinations
            lbl_last = int(c.labels[-1])
            token_source_map = {
                v: False
                for v in range(self.g.num_vertices)
                if self.active[v] and int(self.labels[v]) == lbl_last
            }
        else:
            token_source_map = {s: False for s in sources}
        maxi = c.cycle_length
        labels, indices = c.labels, c.indices
        subgraphs: list[tuple] = []
        messages = 0
        msg_r = np.zeros(self.num_ranks, dtype=np.int64)
        # metadata mode: hop h (arrival at walk position h) traverses the
        # pattern edge (indices[h-1], indices[h]); the data edge must carry
        # that edge's required metadata value
        hopc = None
        if self._meta_allow is not None:
            hopc = np.searchsorted(
                self._meta_vals, self.p.hop_edge_values(indices)
            )

        # position-0 send along alive edges (nem_1.hpp:479-525; TDS
        # tds_batch_1.hpp:424-520)
        if c.is_tds:
            # token = (v, src, parent, visited, target). Normally target ==
            # src; in selected-vertices mode each source emits one token per
            # remembered original source with that as the expected target
            # (tds_batch_1.hpp:494-500)
            if c.selected_vertices:
                inflight = [
                    (int(nbr), src, src, (src,), t)
                    for src in sources
                    for t in sorted(self.token_source_sets.get(src, ()))
                    for nbr in self.alive[src]
                ]
            else:
                inflight = [
                    (int(nbr), src, src, (src,), src)
                    for src in sources
                    for nbr in self.alive[src]
                ]
        else:
            inflight = [(int(nbr), src, src) for src in sources for nbr in self.alive[src]]

        for h in range(1, maxi + 2):
            messages += len(inflight)
            for tok in inflight:
                msg_r[tok[0] % self.num_ranks] += 1
            lbl_h = int(labels[h])
            bit_h = int(indices[h])
            final = h == maxi + 1
            arrivals = []
            for tok in inflight:
                v, src, parent = tok[0], tok[1], tok[2]
                if not self.active[v] or int(self.labels[v]) != lbl_h:
                    continue
                if not (int(self.tv[v]) >> bit_h & 1):
                    continue
                if hopc is not None and not self._hop_meta_ok(
                    v, parent, int(hopc[h - 1])
                ):
                    continue
                if not final:
                    if not c.is_tds:
                        if v == src:
                            continue  # target cannot relay (nem_1.hpp:173-177)
                        if src in self.token_source_sets.get(v, ()):
                            continue
                    if c.is_tds:
                        # enumeration rule for position h
                        # (tds_batch_1.hpp:620-639)
                        visited = tok[3]
                        k = int(c.enumeration[h])
                        if k == h:
                            if v in visited:
                                continue
                        elif k < h:
                            if visited[k] != v:
                                continue
                        else:
                            continue
                arrivals.append(tok)

            if final:
                for tok in arrivals:
                    v, src, parent = tok[0], tok[1], tok[2]
                    if c.is_tds:
                        # acceptance compares against the token's expected
                        # target (== src unless selected-vertices,
                        # tds_batch_1.hpp:664-745)
                        visited, tgt = tok[3], tok[4]
                        if not c.valid_cycle:
                            if v == tgt:
                                continue
                            # path: emit before the ack; the ack validates
                            # the target only if it is in the map
                            subgraphs.append(visited + (v, v))
                            if tgt in token_source_map:
                                token_source_map[tgt] = True
                        else:
                            if v != tgt or visited[0] != v:
                                continue
                            if tgt not in token_source_map:
                                continue
                            token_source_map[tgt] = True
                            subgraphs.append(visited + (v, v))
                        continue
                    if not c.valid_cycle:
                        if v == src:
                            continue  # invalid cycle for a path constraint
                        if c.selected_vertices:
                            # aggregation: validate the destination iff it
                            # forwarded this source earlier
                            # (nem_1.hpp:694-716)
                            if (
                                src in self.token_source_sets.get(v, ())
                                and v in token_source_map
                            ):
                                token_source_map[v] = True
                            continue
                        token_source_map[src] = True
                    else:
                        if v != src:
                            continue
                        if src not in token_source_map:
                            # the reference logs an error and drops the
                            # token when the cycle source is missing from
                            # the map (possible only for a malformed
                            # selected+cycle constraint; nem_1.hpp:750-755)
                            continue
                        token_source_map[src] = True
                        if parent in self.alive[v]:
                            # mark the edge the winning token came in on
                            # (nem_1.hpp:762-770)
                            self.alive[v][parent] = 1
                break

            nxt = []
            if c.is_tds:
                # no per-(vertex,source) dedup in TDS — full enumeration
                for v, src, parent, visited, tgt in arrivals:
                    visited2 = visited + (v,)
                    for nbr in self.alive[v]:
                        if h == maxi:
                            # penultimate hop (tds_batch_1.hpp:806-846):
                            # cycle — only forward to the expected target,
                            # and skip the enumeration check (the closure is
                            # a dup of visited[0] by construction); path —
                            # never to the target, enumeration check applies.
                            if c.valid_cycle:
                                if nbr != tgt:
                                    continue
                                nxt.append((int(nbr), src, v, visited2, tgt))
                                continue
                            if nbr == tgt:
                                continue
                        k = int(c.enumeration[h + 1])
                        if k == h + 1:
                            if nbr in visited2:
                                continue
                        elif k < h + 1:
                            if visited2[k] != nbr:
                                continue
                        else:
                            continue
                        nxt.append((int(nbr), src, v, visited2, tgt))
            else:
                # group same-superstep arrivals by (v, src); min-parent wins
                best: dict[tuple[int, int], int] = {}
                for v, src, parent in arrivals:
                    key = (v, src)
                    if key not in best or parent < best[key]:
                        best[key] = parent
                for (v, src), parent in sorted(best.items()):
                    self.token_source_sets.setdefault(v, set()).add(src)
                    for nbr in self.alive[v]:
                        if nbr == parent:
                            continue
                        nxt.append((int(nbr), src, v))
            inflight = nxt

        if c.is_tds:
            result.subgraphs.setdefault(pl, []).extend(subgraphs)
        return token_source_map, messages, msg_r

    def invalidate_sources(self, c: NonLocalConstraint, token_source_map) -> bool:
        """Reset the source template-vertex bit of failed sources
        (run_pattern_matching_beta.cpp:964-1016)."""
        deleted = False
        bit = int(c.indices[-1] if c.selected_vertices else c.indices[0])
        for src, ok in token_source_map.items():
            if ok:
                continue
            tvv = int(self.tv[src])
            if tvv == 0:
                continue
            if tvv >> bit & 1:
                tvv &= ~(1 << bit)
                self.tv[src] = tvv
            if tvv == 0:
                self.active[src] = False
                self.alive[src].clear()
            deleted = True
        return deleted

    # ----------------------------------------------------------- driver loop

    def run(self, max_iterations: int = 100) -> MatchResult:
        result = MatchResult()
        result.pattern_found = [False] * len(self.constraints)
        global_init_step = True
        itr = 0
        while True:
            not_finished = self.lcc_call(global_init_step, itr, result)
            global_init_step = False
            if itr == 0:
                not_finished = True  # forced token passing (beta.cpp:691-696)
            if not_finished:
                not_finished = False
                for pl, c in enumerate(self.constraints):
                    tsm, msg_count, msg_r = self.nlcc_call(c, pl, result)
                    if any(tsm.values()):
                        result.pattern_found[pl] = True
                    deleted = self.invalidate_sources(c, tsm)
                    if deleted:
                        not_finished = True
                    av_r, ae_r = self._per_rank_counts()
                    result.rows.append(
                        PhaseRow(
                            itr, "TP", pl, *self._counts(), msg_count,
                            per_rank={"av": av_r, "ae": ae_r, "msg": msg_r},
                        )
                    )
                    if deleted and c.interleave_lcc:
                        if self.lcc_call(False, itr, result):
                            not_finished = True
            itr += 1
            if not not_finished or itr >= max_iterations:
                break
        result.iterations = itr
        for v in range(self.g.num_vertices):
            if self.tv[v]:
                result.active_vertices[v] = int(self.tv[v])
                for nbr in self.alive[v]:
                    result.active_edges.add((v, nbr))
        return result
