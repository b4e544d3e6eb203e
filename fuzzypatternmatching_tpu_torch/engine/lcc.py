"""Flat-CSR LCC engine on torch tensors.

Counterpart of ``fuzzypatternmatching_tpu/engine/lcc.py``: one superstep is
one pass over the receiver-centric CSR edge arrays. Each directed edge
e = (v, u) in v's CSR row is an inbox slot whose message is the sender's
candidate bitset ``tv[u]``, gated by the alive flag of the reverse edge;
acceptance is "the sender's bits meet the pattern adjacency of one of my
candidate bits"; ``tn`` is the OR of the accepted messages over each row;
the keep mask and the edge elimination are elementwise bit math. Counting
and edge-metadata modes change the acceptance as in the bucketed engine
(``engine/lcc_bucketed.py``).

Device arrays: ``col`` int32 [E], ``erow`` int64 [E], ``rev`` int32 [E]
with the ``-1`` of a missing reverse edge pointed at the always-dead pad
flag E. The alive and token-passing flags are bool [E + 1]. The alive bit of
each slot's reverse edge is read by the hand-written kernels of
``ops/lcc_superstep.py`` (``alive_table`` + ``rev_alive_lookup``) over the
E + 1 flags; the rest of the superstep is plain torch. The OR over a CSR
row is one ``scatter_reduce`` (amax) per template bit into a V-sized
plane: no [E, 16] temporary.

The flat engine has no slot-space fast path (no ``alive_pairs``): the
driver exchanges its state as E-sized global arrays
(``state_to_global`` / ``state_from_global``) and never compacts it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.lcc_superstep import alive_table, rev_alive_lookup
from ..pattern.pattern_graph import PatternGraph
from .lcc_bucketed import MAX_TEMPLATE_VERTICES, keep_mask_per_i, or_over_bits
from .result import stats_rows


@dataclass
class LccState:
    tv: torch.Tensor  # int32 [V] holding the 16-bit candidate sets
    edge_alive: torch.Tensor  # bool [E+1] (pad flag E always dead)
    tp_flag: torch.Tensor  # bool [E+1] token-passing success marks


class LccEngine:
    def __init__(
        self,
        graph: Graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        num_ranks: int = 1,
        counting: bool = False,
        edge_meta: tuple[np.ndarray, np.ndarray] | None = None,
        *,
        device: torch.device | str = "cuda",
    ):
        if pattern.vertex_count > MAX_TEMPLATE_VERTICES:
            raise ValueError(
                f"templates of more than {MAX_TEMPLATE_VERTICES} vertices "
                "are not supported"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device is available")
        if graph.num_edges >= np.iinfo(np.int32).max:
            raise ValueError(f"{graph.num_edges} edges do not fit int32 edge ids")
        dev = self.device
        self.graph = graph
        self.p = pattern
        self.num_vertices = v = graph.num_vertices
        self.num_edges = e = graph.num_edges
        self.num_ranks = num_ranks
        self.col = torch.from_numpy(graph.cols.astype(np.int32)).to(dev)
        self.erow = torch.from_numpy(graph.edge_row.astype(np.int64)).to(dev)
        rev = graph.rev_edge
        self.rev = torch.from_numpy(
            np.where(rev < 0, e, rev).astype(np.int32)
        ).to(dev)
        self.owner = torch.arange(v, dtype=torch.int64, device=dev) % num_ranks
        # output rank of each slot's row (only needed for several ranks)
        self.eowner = self.owner[self.erow] if num_ranks > 1 else None

        self.k = pattern.vertex_count
        self.adj_all = [int(x) for x in pattern.edges_bitset_all]
        self.mand = [int(x) for x in pattern.edges_bitset]
        self.opt = [int(x) for x in pattern.edges_bitset_optional]
        self.opt_min = [int(x) for x in pattern.min_optional_edge_count]
        self.label_tv = torch.from_numpy(
            pattern.label_match_bitset(np.asarray(labels)).astype(np.int32)
        ).to(dev)

        # counting: the label class (1..L) of each slot's sender, 0 = none
        self.counting = counting
        self.required = None
        self.col_class = None
        if counting:
            class_labels, self.required = pattern.neighbor_label_counts()
            lab = np.asarray(labels)
            sender_class = np.zeros(e, dtype=np.uint8)
            for j, cl in enumerate(class_labels):
                sender_class[lab[graph.cols] == cl] = j + 1
            self.col_class = torch.from_numpy(sender_class).to(dev)
        # edge metadata: per-slot codes into the allow table [M+1, K]
        self.meta_allow = None  # [K] int32 [M+1] tables: column i of allow
        self.meta_code = None
        if edge_meta is not None:
            allow, code = edge_meta
            allow32 = np.asarray(allow, dtype=np.uint32).astype(np.int32)
            self.meta_allow = [
                torch.from_numpy(allow32[:, i].copy()).to(dev)
                for i in range(self.k)
            ]
            code_dtype = np.uint8 if allow.shape[0] <= 256 else np.int32
            self.meta_code = torch.from_numpy(
                np.asarray(code).astype(code_dtype)
            ).to(dev)

    # -- helpers -----------------------------------------------------------

    def _row_any(self, flags: torch.Tensor) -> torch.Tensor:
        """bool [V]: any flag set in each CSR row."""
        return torch.zeros(
            self.num_vertices, dtype=torch.uint8, device=flags.device
        ).scatter_reduce_(0, self.erow, flags.to(torch.uint8), "amax") != 0

    def _row_or(self, bits: torch.Tensor) -> torch.Tensor:
        """int32 [V]: OR of the 16-bit sets of each CSR row, one amax
        scatter per template bit."""
        out = torch.zeros(self.num_vertices, dtype=torch.int32, device=bits.device)
        for i in range(self.k):
            out = out | (self._row_any(((bits >> i) & 1) != 0).to(torch.int32) << i)
        return out

    def _row_sum(self, flags: torch.Tensor) -> torch.Tensor:
        return torch.zeros(
            self.num_vertices, dtype=torch.int32, device=flags.device
        ).index_add_(0, self.erow, flags.to(torch.int32))

    # -- one superstep -----------------------------------------------------

    def _superstep(self, tv, edge_alive, tp_flag, *, init: bool):
        """Returns (tv, alive, tp_flag, stats) with stats = [av per rank |
        ae per rank | msg per rank | died] as an int64 device tensor."""
        e = self.num_edges
        meta = self.meta_allow is not None
        p = tv[self.col]  # sender candidate sets per inbox slot
        if init:
            send_ok = p != 0
        else:
            rev_alive = rev_alive_lookup(self.rev, alive_table(edge_alive))
            send_ok = (p != 0) & rev_alive
        p = torch.where(send_ok, p, 0)

        acc = None
        if meta:
            # per-slot allowed parents toward each receiver bit i, and a
            # separate tn per bit
            code = self.meta_code.to(torch.int32)
            tv_e = tv[self.erow]
            mask = torch.zeros_like(p)
            tn_list = []
            acc = []
            for i in range(self.k):
                allow_i = self.meta_allow[i][code]
                mask = mask | torch.where(((tv_e >> i) & 1) != 0, allow_i, 0)
                p_i = p & allow_i
                tn_list.append(self._row_or(p_i))
                if self.counting:
                    acc.append(p_i != 0)
            accept = (p & mask) != 0
            in_map = self._row_any(accept)
            new_tv = tv & keep_mask_per_i(tn_list, self.mand, self.opt, self.opt_min)
        else:
            accept = (p & or_over_bits(tv, self.adj_all)[self.erow]) != 0
            pa = torch.where(accept, p, 0)
            tn = self._row_or(pa)
            in_map = tn != 0
            new_tv = tv & keep_mask_per_i([tn] * self.k, self.mand, self.opt, self.opt_min)
            if self.counting:
                acc = [(pa & self.adj_all[i]) != 0 for i in range(self.k)]
        if self.counting:
            keep_cnt = torch.zeros_like(tv)
            of_class = {
                j: self.col_class == j + 1
                for j in np.nonzero(self.required.any(axis=0))[0]
            }
            for i in range(self.k):
                ok = torch.ones_like(in_map)
                for j in range(self.required.shape[1]):
                    req = int(self.required[i, j])
                    if req > 0:
                        ok = ok & (self._row_sum(acc[i] & of_class[j]) >= req)
                keep_cnt = keep_cnt | (ok.to(torch.int32) << i)
            new_tv = new_tv & keep_cnt
        if init:
            new_tv = torch.where(in_map, new_tv, 0)
            died = (in_map & (new_tv == 0)).any()
        else:
            died = ((tv != 0) & (new_tv == 0)).any()

        row_live = (new_tv != 0)[self.erow]
        if init:
            alive = accept & row_live
        else:
            alive = edge_alive[:e] & (accept | tp_flag[:e]) & row_live
        new_alive = torch.cat([alive, alive.new_zeros(1)])

        r = self.num_ranks
        live = new_tv != 0
        if r == 1:
            av, ae, msg = live.sum().view(1), alive.sum().view(1), send_ok.sum().view(1)
        else:
            def per_rank(owner, flags):
                return torch.zeros(
                    r, dtype=torch.int64, device=flags.device
                ).index_add_(0, owner, flags.to(torch.int64))

            av = per_rank(self.owner, live)
            ae = per_rank(self.eowner, alive)
            msg = per_rank(self.eowner, send_ok)
        stats = torch.cat([av, ae, msg, died.to(torch.int64).view(1)])
        return new_tv, new_alive, torch.zeros_like(new_alive), stats

    # -- public API --------------------------------------------------------

    def _flags(self, flags) -> torch.Tensor:
        """bool [E+1] device flags from an E-sized host array (pad dead)."""
        out = np.zeros(self.num_edges + 1, dtype=bool)
        out[: self.num_edges] = np.asarray(flags, dtype=bool)
        return torch.from_numpy(out).to(self.device)

    def init_state(self) -> LccState:
        dev = self.device
        return LccState(
            tv=torch.zeros(self.num_vertices, dtype=torch.int32, device=dev),
            edge_alive=torch.zeros(self.num_edges + 1, dtype=torch.bool, device=dev),
            tp_flag=torch.zeros(self.num_edges + 1, dtype=torch.bool, device=dev),
        )

    def state_from_global(self, tv, edge_alive, tp_flag) -> LccState:
        """State from host arrays: tv [V] (uint32 values), edge_alive and
        tp_flag bool [E] in CSR edge order."""
        tv = np.asarray(tv)
        e = (self.num_edges,)
        if (
            tv.shape != (self.num_vertices,)
            or np.shape(edge_alive) != e
            or np.shape(tp_flag) != e
        ):
            raise ValueError("state_from_global: shapes do not match this engine")
        return LccState(
            tv=torch.from_numpy(tv.astype(np.uint32).view(np.int32)).to(self.device),
            edge_alive=self._flags(edge_alive),
            tp_flag=self._flags(tp_flag),
        )

    def state_from_jax(self, tv, edge_alive, tp_flag) -> LccState:
        """State from the JAX engine's ``LccState`` arrays, as numpy: tv
        uint32 [V], edge_alive and tp_flag bool [E]. The edge order is the
        CSR's in both engines."""
        return self.state_from_global(tv, edge_alive, tp_flag)

    def state_to_global(self, state: LccState):
        """(tv uint32 [V], edge_alive bool [E]) on the host."""
        return (
            state.tv.cpu().numpy().view(np.uint32),
            state.edge_alive[: self.num_edges].cpu().numpy(),
        )

    def lcc_call(
        self, state: LccState, global_init_step: bool,
        n_steps: int | None = None,
    ):
        """Run ``n_steps`` supersteps (default: the pattern's diameter); the
        first is the global init step when ``global_init_step``. Returns
        (state, rows, died) with one (av, ae, msgs, per_rank) row per
        superstep."""
        tv, alive, flag = state.tv, state.edge_alive, state.tp_flag
        stats = []
        for s in range(self.p.diameter if n_steps is None else n_steps):
            init = s == 0 and global_init_step
            tv, alive, flag, st = self._superstep(
                self.label_tv if init else tv, alive, flag, init=init
            )
            stats.append(st)
        rows, any_died = (
            stats_rows(torch.stack(stats).cpu().numpy(), self.num_ranks) if stats else ([], False)
        )
        return LccState(tv, alive, flag), rows, any_died
