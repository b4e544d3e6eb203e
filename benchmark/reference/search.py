"""The plain reference search: the upstream's prune-to-fixpoint loop
(run_pattern_matching_beta.cpp:544-1351) over the graph, labels and
template that the benchmark hands the program.

* LCC (label_propagation_pattern_matching_nonunique_ee.hpp, and with
  ``counting`` the neighbour-label counts of ..._counting_ee.hpp): every
  superstep as whole-graph tensor operations, one element per directed edge,
  on any torch device. A vertex's template bits and an edge's membership in
  the alive set are plain arrays; nothing of the program's layout.
* NLCC and TDS (token_passing_pattern_matching_nonunique_nem_1.hpp,
  ..._tds_batch_1.hpp): one token at a time in Python over the alive
  adjacency, which LCC has cut to a small share of the graph.

Deterministic rules where the upstream's asynchronous schedule leaves a
choice: supersteps are breadth-synchronous, and among one superstep's
arrivals at (vertex, source) the token with the smallest parent id wins.
It imports nothing of the program.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .template import Template


class ReferenceSearch:
    def __init__(self, graph: dict, labels: np.ndarray, tmpl: Template,
                 counting: bool, device: torch.device | str,
                 supersteps: int | None = None):
        dev = torch.device(device)
        # supersteps an LCC call runs: the template's diameter (another
        # number only in the control, which breaks the fixpoint)
        self.supersteps = tmpl.diameter if supersteps is None else supersteps
        self.dev = dev
        self.t = tmpl
        self.V = V = int(graph["num_vertices"])
        self.row = torch.as_tensor(graph["edge_row"], dtype=torch.int64).to(dev)
        self.col = torch.as_tensor(graph["cols"], dtype=torch.int64).to(dev)
        rev = torch.as_tensor(graph["rev_edge"], dtype=torch.int64).to(dev)
        self.has_rev = rev >= 0
        self.rev = rev.clamp(min=0)
        self.keys = self.row * V + self.col  # sorted: CSR order
        self.labels = np.asarray(labels).astype(np.int64)
        self.label_list = self.labels.tolist()
        lab = torch.as_tensor(self.labels).to(dev)
        self.label_tv = torch.zeros(V, dtype=torch.int32, device=dev)
        for i, x in enumerate(tmpl.vertex_labels):
            self.label_tv |= (lab == x).to(torch.int32) << i
        self.counting = counting
        if counting:
            classes, self.required = tmpl.label_counts()
            self.n_classes = len(classes)
            cls = torch.full((V,), -1, dtype=torch.int64, device=dev)
            for j, x in enumerate(classes):
                cls[lab == x] = j
            self.cls = cls
        E = self.row.numel()
        self.tv = torch.zeros(V, dtype=torch.int32, device=dev)
        self.alive = torch.zeros(E, dtype=torch.bool, device=dev)
        self.marks = torch.zeros(E, dtype=torch.bool, device=dev)  # TP marks
        self.rows: list[tuple] = []
        self.subgraphs: dict[int, list[tuple]] = {}
        self.sets: dict[int, set[int]] = {}  # vertex -> sources it forwarded

    # ------------------------------------------------------------------ LCC

    def _keep(self, i: int, tn: torch.Tensor) -> torch.Tensor:
        """Template vertex i's local constraint (local_constraint_checking.hpp
        :1062-1113) against the neighbour bits ``tn`` heard."""
        m = self.t.mandatory[i]
        ok = (tn & m) == m
        if self.t.min_optional[i] > 0:
            o = self.t.optional[i]
            got = tn & o
            pop = sum(((got >> b) & 1) for b in range(self.t.k))
            ok &= (got == o) & (pop >= self.t.min_optional[i])
        return ok

    def lcc_call(self, global_init: bool, itr: int) -> bool:
        """One LCC call; True when a vertex that had heard a
        valid parent was invalidated."""
        t, V = self.t, self.V
        row, col = self.row, self.col
        adj = t.adjacent
        not_finished = False
        for s in range(self.supersteps):
            init = s == 0 and global_init
            if init:
                self.tv = self.label_tv.clone()
            tv = self.tv
            bits = tv[row]
            send = bits != 0
            if not init:
                send &= self.alive
            accept = torch.zeros(V, dtype=torch.int32, device=self.dev)
            for i in range(t.k):
                accept |= torch.where(((tv >> i) & 1) == 1, adj[i], 0).to(torch.int32)
            recv = send & ((bits & accept[col]) != 0)  # receiver col, parent row
            tn = torch.zeros(V, dtype=torch.int32, device=self.dev)
            for i in range(t.k):
                hit = recv & (((bits >> i) & 1) == 1)
                heard = torch.bincount(col[hit], minlength=V) > 0
                tn |= heard.to(torch.int32) << i
            live = tv != 0
            cand = tv.clone()
            for i in range(t.k):
                ok = self._keep(i, tn)
                if self.counting:
                    ok &= ~self._count_short(i, bits, recv)
                cand = torch.where((((cand >> i) & 1) == 1) & ~ok, cand & ~(1 << i), cand)
            silent = live & (tn == 0) if init else torch.zeros_like(live)
            cand = torch.where(silent, 0, cand)
            if bool((live & (cand == 0) & ~silent).any()):
                not_finished = True
            # an entry (row, col) of row's map is kept when its message from
            # col was accepted this superstep (init: it is made so), or a
            # token marked it
            flag = recv[self.rev] & self.has_rev
            alive = flag if init else self.alive & (flag | self.marks)
            self.tv = cand
            self.alive = alive & (cand[row] != 0)
            self.marks = torch.zeros_like(self.marks)
            self.rows.append((
                itr, "LP", s, int((cand != 0).sum()), int(self.alive.sum()),
                int(send.sum()),
            ))
        return not_finished

    def _count_short(self, i: int, bits: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        """Counting mode: vertices that heard fewer distinct valid parents of
        some label class than template vertex i has neighbours of it."""
        req = torch.as_tensor(self.required[i], device=self.dev)
        J = self.n_classes
        pc = self.cls[self.row]
        ok = recv & ((bits & self.t.adjacent[i]) != 0) & (pc >= 0)
        cnt = torch.bincount(self.col[ok] * J + pc[ok], minlength=self.V * J)
        return ((cnt.view(self.V, J) < req) & (req > 0)).any(1)

    # ------------------------------------------- the state between host and device

    def _to_host(self):
        self.tvh = self.tv.cpu().numpy().astype(np.int64)
        eids = torch.nonzero(self.alive).flatten()
        r = self.row[eids].cpu().numpy()
        c = self.col[eids].cpu().numpy()
        self.adj: dict[int, dict[int, int]] = defaultdict(dict)
        for a, b in zip(r.tolist(), c.tolist()):
            self.adj[a][b] = 0

    def _to_device(self):
        self.tv = torch.as_tensor(self.tvh.astype(np.int32)).to(self.dev)
        pairs = [(a, b, f) for a, m in self.adj.items() for b, f in m.items()]
        alive = torch.zeros_like(self.alive)
        marks = torch.zeros_like(self.marks)
        if pairs:
            p = torch.as_tensor(pairs, dtype=torch.int64).to(self.dev)
            eids = torch.searchsorted(self.keys, p[:, 0] * self.V + p[:, 1])
            alive[eids] = True
            marks[eids[p[:, 2] == 1]] = True
        self.alive, self.marks = alive, marks

    def _counts(self) -> tuple[int, int]:
        live = self.tvh != 0
        ae = sum(len(m) for v, m in self.adj.items() if live[v])
        return int(live.sum()), ae

    # ----------------------------------------------------------------- NLCC

    def _sources(self, c) -> list[int]:
        tv = self.tvh
        ok = (tv != 0) & (self.labels == c.labels[0]) & (((tv >> c.indices[0]) & 1) == 1)
        if not c.is_tds and not c.valid_cycle and not c.selected_vertices:
            ok &= ((tv >> c.indices[-1]) & 1) == 1
        return np.nonzero(ok)[0].tolist()

    def _reset_sets(self, c):
        if not c.selected_vertices:
            self.sets.clear()
            return
        for v in list(self.sets):
            if not (self.tvh[v] != 0 and self.labels[v] == c.labels[-1]):
                del self.sets[v]

    def nlcc_call(self, c, pl: int) -> tuple[dict, int]:
        """One token-passing run: (source -> validated, messages)."""
        self._reset_sets(c)
        sources = self._sources(c)
        if c.selected_vertices and not c.is_tds:
            dest = (self.tvh != 0) & (self.labels == c.labels[-1])
            tsm = {int(v): False for v in np.nonzero(dest)[0]}
        else:
            tsm = {s: False for s in sources}
        # plain lists: a token's checks index them one vertex at a time
        tv, labels = self.tvh.tolist(), self.label_list
        adj, sets = self.adj, self.sets
        maxi = c.cycle_length
        subgraphs: list[tuple] = []
        messages = 0
        if c.is_tds:
            if c.selected_vertices:
                inflight = [
                    (nbr, s, s, (s,), t)
                    for s in sources for t in sorted(sets.get(s, ())) for nbr in adj[s]
                ]
            else:
                inflight = [(nbr, s, s, (s,), s) for s in sources for nbr in adj[s]]
        else:
            inflight = [(nbr, s, s) for s in sources for nbr in adj[s]]

        for h in range(1, maxi + 2):
            messages += len(inflight)
            lbl_h, bit_h = c.labels[h], c.indices[h]
            final = h == maxi + 1
            arrivals = []
            for tok in inflight:
                v, src = tok[0], tok[1]
                tvv = tv[v]
                if tvv == 0 or labels[v] != lbl_h or not (tvv >> bit_h) & 1:
                    continue
                if not final:
                    if c.is_tds:
                        k = c.enumeration[h]
                        if k == h:
                            if v in tok[3]:
                                continue
                        elif k < h:
                            if tok[3][k] != v:
                                continue
                        else:
                            continue
                    else:
                        if v == src or src in sets.get(v, ()):
                            continue
                arrivals.append(tok)

            if final:
                for tok in arrivals:
                    v, src, parent = tok[0], tok[1], tok[2]
                    if c.is_tds:
                        visited, tgt = tok[3], tok[4]
                        if not c.valid_cycle:
                            if v == tgt:
                                continue
                            subgraphs.append(visited + (v, v))
                            if tgt in tsm:
                                tsm[tgt] = True
                        elif v == tgt and visited[0] == v and tgt in tsm:
                            tsm[tgt] = True
                            subgraphs.append(visited + (v, v))
                    elif not c.valid_cycle:
                        if v == src:
                            continue
                        if c.selected_vertices:
                            if src in sets.get(v, ()) and v in tsm:
                                tsm[v] = True
                            continue
                        tsm[src] = True
                    elif v == src and src in tsm:
                        tsm[src] = True
                        if parent in adj[v]:
                            adj[v][parent] = 1  # the winning token's edge
                break

            nxt = []
            if c.is_tds:
                for v, src, parent, visited, tgt in arrivals:
                    visited2 = visited + (v,)
                    for nbr in adj[v]:
                        if h == maxi:
                            if c.valid_cycle:
                                if nbr == tgt:
                                    nxt.append((nbr, src, v, visited2, tgt))
                                continue
                            if nbr == tgt:
                                continue
                        k = c.enumeration[h + 1]
                        if k == h + 1:
                            if nbr in visited2:
                                continue
                        elif k < h + 1:
                            if visited2[k] != nbr:
                                continue
                        else:
                            continue
                        nxt.append((nbr, src, v, visited2, tgt))
            else:
                best: dict[tuple[int, int], int] = {}
                for v, src, parent in arrivals:
                    if (v, src) not in best or parent < best[(v, src)]:
                        best[(v, src)] = parent
                for (v, src), parent in sorted(best.items()):
                    sets.setdefault(v, set()).add(src)
                    nxt.extend((nbr, src, v) for nbr in adj[v] if nbr != parent)
            inflight = nxt

        if c.is_tds:
            self.subgraphs.setdefault(pl, []).extend(subgraphs)
        return tsm, messages

    def _invalidate(self, c, tsm: dict) -> bool:
        """Clear the source's template bit of every source not validated
        (run_pattern_matching_beta.cpp:964-1016)."""
        deleted = False
        bit = c.indices[-1] if c.selected_vertices else c.indices[0]
        for src, ok in tsm.items():
            if ok or self.tvh[src] == 0:
                continue
            self.tvh[src] &= ~(1 << bit)
            if self.tvh[src] == 0:
                self.adj.pop(src, None)
            deleted = True
        return deleted

    # ------------------------------------------------------------ the loop

    def run(self, max_iterations: int = 100) -> dict:
        """The search to its fixpoint (or ``max_iterations``), as a dict of
        plain values: rows, found flags, iterations, vertices, edges,
        subgraphs and traversed edges."""
        cons = self.t.constraints
        found = [False] * len(cons)
        global_init = True
        itr = 0
        while True:
            not_finished = self.lcc_call(global_init, itr)
            global_init = False
            if itr == 0:
                not_finished = True  # forced token passing (beta.cpp:691-696)
            if not_finished:
                not_finished = False
                self._to_host()
                for pl, c in enumerate(cons):
                    tsm, msgs = self.nlcc_call(c, pl)
                    if any(tsm.values()):
                        found[pl] = True
                    deleted = self._invalidate(c, tsm)
                    not_finished |= deleted
                    self.rows.append((itr, "TP", pl, *self._counts(), msgs))
                    if deleted and c.interleave_lcc:
                        self._to_device()
                        not_finished |= self.lcc_call(False, itr)
                        self._to_host()
                self._to_device()
            itr += 1
            if not not_finished or itr >= max_iterations:
                break
        self._to_host()
        live = self.tvh != 0
        return {
            "rows": list(self.rows),
            "found": found,
            "iterations": itr,
            "vertices": {int(v): int(self.tvh[v]) for v in np.nonzero(live)[0]},
            "edges": {(a, b) for a, m in self.adj.items() if live[a] for b in m},
            "subgraphs": {pl: list(s) for pl, s in self.subgraphs.items()},
            "traversed_edges": sum(r[-1] for r in self.rows),
        }
