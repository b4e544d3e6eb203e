"""Bucketed-ELL LCC engine on torch tensors.

Counterpart of ``fuzzypatternmatching_tpu/engine/lcc_bucketed.py``. The
adjacency is laid out in degree buckets: vertices of similar
(deduplicated) degree share a dense ``[rows, width]`` neighbour matrix
padded to a power-of-two width between ``min_width`` and ``max_width``;
hubs wider than ``max_width`` are split over several rows of the widest
bucket and their partial results combined per segment. The slot layout
(bucket order, ``slot_base``, ``rev``, the edge-to-slot map) is the JAX
engine's, so states convert between the two (``state_from_jax``).

In the default mode a superstep is one fused pass over every bucket
(``ops/lcc_fused.py``, the tables of ``SuperstepPlanes``):

* init (global init step): ``init_superstep`` (K1). The neighbour
  candidates are the neighbours' label bitsets, replayed from per-slot
  label codes; accept test against the row's pattern-adjacency mask, row
  OR, the split hubs' segment OR, keep mask, alive update and counters;
* otherwise: ``alive_table`` packs the alive flags (words and group
  summary) and ``rev_alive_lookup`` reads the alive bit of every slot's
  reverse edge (``rev`` is one flat [S] tensor), then
  ``continuation_superstep`` (K2) gathers the tv of the senders whose
  reverse edge is alive and applies the same epilogue
  (``ops/lcc_superstep.py`` for the first two).

Two search modes change the acceptance, as in the JAX engine:

* counting (``counting=True``): candidate i also needs at least
  ``required[i, j]`` accepted neighbours of label class j (per-slot sender
  class codes, the planes' ``cls``; per-segment counts). Without edge
  metadata its supersteps are K1 and K2 under the counting rule, one
  launch each, in one ``fpm.lcc.count`` span;
* edge metadata (``edge_meta``): a slot's metadata code selects a row of
  the allow table, and tn is accumulated separately per receiver bit from
  the parents that edge may deliver toward that bit. Its acceptance and
  per-bit tn are not what the fused kernels compute, so after
  ``rev_alive_lookup`` this mode runs per bucket in plain torch
  (``_per_bucket``), with ``_count_mask``'s class counts when counting too.

tv is int32 holding the 16-bit candidate set; alive and the token-passing
flags are bool over the flat slot space plus one always-dead pad slot.

Where a recorder is open (``utils/trace.py``: a ``MatchEngine``'s
``fpm.build``, a search's closure build), the constructor opens
``fpm.build.lcc`` with ``.layout`` (``_build_layout``: bucket assignment,
``edge_to_slot``, ``rev``, in numpy), ``.codes`` (``_build_codes``: label
codes, pattern constants, edge-metadata codes, counting classes) and
``.planes`` (``_build_planes``: ``build_planes``, ``_rev_flat`` and each
bucket's rows, uploaded); a constructor called with none open records
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.lcc_fused import (
    MAX_TEMPLATE_VERTICES,
    Template,
    bucket_views,
    build_planes,
    continuation_superstep,
    count_mask,
    init_superstep,
    keep_mask_per_i,
    or_over_bits,
    segment_or,
)
from ..ops.lcc_superstep import alive_table, rev_alive_lookup, row_or
from ..pattern.pattern_graph import PatternGraph
from ..utils import trace
from ..utils.trace import to_device, to_host
from .result import stats_rows

@dataclass
class Bucket:
    rows: np.ndarray  # vertex id per row [n] (repeats for split hubs)
    adj: np.ndarray  # neighbour ids [n, w], sentinel V for padding
    rev: np.ndarray  # flat slot index of the reverse edge [n, w] (S = dead)
    slot_base: int  # flat offset of this bucket's slots
    edge_ids: np.ndarray  # original CSR edge index per slot [n, w], -1 pad
    seg_id: np.ndarray  # row -> compact vertex segment id [n]
    seg_rows: np.ndarray  # segment id -> vertex id [n_seg]


@dataclass
class _DeviceBucket:
    rows: torch.Tensor  # int64 [n]
    adj: torch.Tensor  # int32 [n, w]
    code: torch.Tensor  # label code of each slot's neighbour [n, w]
    seg_id: torch.Tensor  # int64 [n]
    seg_rows: torch.Tensor  # int64 [n_seg]
    own_rows: torch.Tensor  # output rank of each row, int64 [n]
    own_seg: torch.Tensor  # output rank of each segment, int64 [n_seg]
    # edge-metadata code of each slot (padding -> the all-zero row M),
    # uint8 when M + 1 <= 256, else int32 [n, w]
    meta: torch.Tensor | None = None
    # counting: label class (1..L) of each slot's sender, 0 = none [n, w]
    cls: torch.Tensor | None = None


@dataclass
class BucketedState:
    """The engine's device arrays and their host memos. Between the compact
    continuation's phases the driver holds the state on the host itself
    (``engine/driver.py::_HostState``), with the sub-engine's output state
    beside it for the search's next phase."""

    tv: torch.Tensor  # int32 [V] on the engine's device
    alive: torch.Tensor  # bool [S+1] (last slot always dead)
    tp_flag: torch.Tensor  # bool [S+1]
    # memo for alive_pairs (the driver asks several times per phase)
    pairs_cache: tuple | None = None
    # host copy of tv (uint32)
    tv_np: np.ndarray | None = None


class BucketedLccEngine:
    def __init__(
        self,
        graph: Graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        *,
        device: torch.device | str = "cuda",
        num_ranks: int = 1,
        min_width: int = 8,
        max_width: int = 8192,
        edge_meta: tuple[np.ndarray, np.ndarray] | None = None,
        counting: bool = False,
    ):
        if pattern.vertex_count > MAX_TEMPLATE_VERTICES:
            raise ValueError(
                f"templates of more than {MAX_TEMPLATE_VERTICES} vertices "
                "are not supported"
            )
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device is available")
        self.graph = graph
        self.p = pattern
        self.num_ranks = num_ranks
        # the build's phases, each a span where a recorder is open
        # (utils/trace.py: a MatchEngine's build, a closure's in a search)
        with trace.span("fpm.build.lcc"):
            with trace.span("fpm.build.lcc.layout"):
                self._build_layout(graph, min_width, max_width)
            with trace.span("fpm.build.lcc.codes"):
                codes = self._build_codes(labels, pattern, edge_meta, counting)
            with trace.span("fpm.build.lcc.planes"):
                self._build_planes(labels, *codes)

    def _build_layout(self, graph: Graph, min_width: int, max_width: int) -> None:
        """The slot layout: bucket assignment, ``num_slots``, the
        edge-to-slot map and each slot's reverse slot (numpy)."""
        v = graph.num_vertices
        self.num_vertices = v
        deg = np.diff(graph.row_ptr)

        # --- bucket assignment (the JAX engine's layout, slot for slot) ---
        nz = np.nonzero(deg > 0)[0]
        dnz = deg[nz]
        wexp = np.maximum(
            int(np.log2(min_width)),
            np.ceil(np.log2(np.maximum(dnz, 1))).astype(np.int64),
        )
        wexp = np.minimum(wexp, int(np.log2(max_width)))
        cap_exp = int(np.log2(max_width))

        self.buckets: list[Bucket] = []
        slot_base = 0
        for we in np.unique(wexp):
            w = 1 << int(we)
            vs = nz[wexp == we]
            if we == cap_exp:
                # split rows: vertex occupies ceil(d/w) rows
                n_rows_per = -(-deg[vs] // w)
                rows = np.repeat(vs, n_rows_per)
                seg_id = np.repeat(
                    np.arange(len(vs), dtype=np.int64), n_rows_per
                )
                chunk = np.arange(len(rows), dtype=np.int64) - np.repeat(
                    np.cumsum(n_rows_per) - n_rows_per, n_rows_per
                )
                starts = graph.row_ptr[rows] + chunk * w
                lens = np.minimum(graph.row_ptr[rows + 1] - starts, w)
            else:
                rows = vs
                seg_id = np.arange(len(vs), dtype=np.int64)
                starts = graph.row_ptr[rows]
                lens = deg[rows]
            offs = np.arange(w, dtype=np.int64)[None, :]
            valid = offs < lens[:, None]
            eidx = np.minimum(starts[:, None] + offs, graph.num_edges - 1)
            adj = np.where(valid, graph.cols[eidx], v).astype(np.int32)
            eids = np.where(valid, eidx, -1)
            self.buckets.append(
                Bucket(rows, adj, None, slot_base, eids, seg_id, vs)
            )
            slot_base += len(rows) * w
        self.num_slots = slot_base
        if slot_base >= np.iinfo(np.int32).max:
            raise ValueError(f"{slot_base} slots do not fit int32 slot ids")

        # original edge id <-> flat slot
        edge_to_slot = np.full(graph.num_edges, slot_base, dtype=np.int64)
        for b in self.buckets:
            flat_ids = b.edge_ids.reshape(-1)
            mask = flat_ids >= 0
            edge_to_slot[flat_ids[mask]] = b.slot_base + np.nonzero(mask)[0]
        self._edge_to_slot = edge_to_slot
        for b in self.buckets:
            flat_ids = b.edge_ids.reshape(-1)
            mask = flat_ids >= 0
            rv_flat = np.full(flat_ids.shape, slot_base, dtype=np.int32)
            rev_edges = graph.rev_edge[flat_ids[mask]]
            ok = rev_edges >= 0
            tmp = np.full(int(mask.sum()), slot_base, dtype=np.int64)
            tmp[ok] = edge_to_slot[rev_edges[ok]]
            rv_flat[np.nonzero(mask)[0]] = tmp
            b.rev = rv_flat.reshape(b.adj.shape)

    def _build_codes(self, labels, pattern: PatternGraph, edge_meta, counting: bool):
        """The label codes, the pattern constants, the slots' edge-metadata
        codes (and the allow table's upload) and the counting classes;
        returns (code_pad, code_tv, slot_meta, slot_cls)."""
        v = self.num_vertices
        # --- init-superstep label codes -----------------------------------
        # At the global init step tv == label_tv, so a slot's candidate set
        # is a function of its neighbour's label: a small per-slot label
        # code and a code -> bitset table replace the V-sized tv gather.
        uniq_labels, inv_lab = np.unique(np.asarray(labels), return_inverse=True)
        code_dtype = np.uint8 if len(uniq_labels) <= 255 else np.int32
        code_pad = np.zeros(v + 1, dtype=code_dtype)
        code_pad[:v] = (inv_lab.reshape(-1) + 1).astype(code_dtype)
        code_tv = np.zeros(len(uniq_labels) + 1, dtype=np.int32)
        code_tv[1:] = pattern.label_match_bitset(uniq_labels)

        # --- pattern constants (python ints: k <= 16 bits) ----------------
        self.k = pattern.vertex_count
        self.adj_all = [int(x) for x in pattern.edges_bitset_all]
        self.mand = [int(x) for x in pattern.edges_bitset]
        self.opt = [int(x) for x in pattern.edges_bitset_optional]
        self.opt_min = [int(x) for x in pattern.min_optional_edge_count]

        # --- edge metadata: per-slot codes into the allow table ------------
        slot_meta = [None] * len(self.buckets)
        self.meta_allow = None  # [K] int32 [M+1] tables: column i of allow
        if edge_meta is not None:
            allow, ecode = edge_meta
            ecode = np.asarray(ecode, dtype=np.int64)
            mzero = allow.shape[0] - 1  # the all-zero allow row
            meta_dtype = np.uint8 if allow.shape[0] <= 256 else np.int32
            slot_meta = [
                np.where(
                    b.edge_ids >= 0, ecode[np.maximum(b.edge_ids, 0)], mzero
                ).astype(meta_dtype)
                for b in self.buckets
            ]
            allow32 = np.asarray(allow, dtype=np.uint32).astype(np.int32)
            self.meta_allow = [
                to_device(allow32[:, i].copy(), self.device)
                for i in range(self.k)
            ]
        # --- counting: per-slot sender label classes -----------------------
        self.counting = counting
        slot_cls = [None] * len(self.buckets)
        self.required = None
        if counting:
            class_labels, self.required = pattern.neighbor_label_counts()
            lab = np.asarray(labels)
            class_pad = np.zeros(v + 1, dtype=np.uint8)
            for j, cl in enumerate(class_labels):
                class_pad[:v][lab == cl] = j + 1
            slot_cls = [class_pad[b.adj] for b in self.buckets]
        return code_pad, code_tv, slot_meta, slot_cls

    def _build_planes(self, labels, code_pad, code_tv, slot_meta, slot_cls) -> None:
        """The device planes: ``build_planes``, ``_rev_flat`` and each
        bucket's rows and metadata codes, uploaded."""
        v, dev = self.num_vertices, self.device
        lab_tv = self.p.label_match_bitset(np.asarray(labels)).astype(np.int32)
        self.label_tv = to_device(lab_tv, dev)
        # flat planes over every bucket and the bucket table, what the fused
        # supersteps read (ops/lcc_fused.py); each bucket's planes below
        # are views of them
        self._planes = build_planes(
            [b.adj.shape[1] for b in self.buckets], [b.rows for b in self.buckets],
            [b.seg_id for b in self.buckets], [b.seg_rows for b in self.buckets],
            [b.adj for b in self.buckets], [code_pad[b.adj] for b in self.buckets],
            code_tv, v, self.num_ranks, dev, cls=slot_cls if self.counting else None,
        )
        self._tmpl = Template(
            tuple(self.adj_all), tuple(self.mand), tuple(self.opt), tuple(self.opt_min),
            None if self.required is None else tuple(map(tuple, self.required.tolist())),
        )
        self._code_tv = self._planes.code_tv
        # rev of every slot, bucket after bucket: one lookup launch covers
        # the whole slot space
        self._rev_flat = to_device(
            np.concatenate(
                [b.rev.reshape(-1) for b in self.buckets]
                + [np.empty(0, dtype=np.int32)]
            ),
            dev,
        )
        self._dev = []
        for b, views, meta in zip(self.buckets, bucket_views(self._planes), slot_meta):
            self._dev.append(
                _DeviceBucket(
                    rows=to_device(b.rows.astype(np.int64), dev),
                    adj=views.adj,
                    code=views.code,
                    seg_id=views.seg_id,
                    seg_rows=views.seg_rows,
                    own_rows=views.own_rows,
                    own_seg=views.own_seg,
                    meta=None if meta is None else to_device(meta, dev),
                    cls=views.cls,
                )
            )

    # ------------------------------------------------------------------

    def _or_over_bits(self, tv: torch.Tensor) -> torch.Tensor:
        return or_over_bits(tv, self.adj_all)

    def _keep_mask_per_i(self, tn_list: list) -> torch.Tensor:
        return keep_mask_per_i(tn_list, self.mand, self.opt, self.opt_min)

    def _count_mask(self, d: _DeviceBucket, acc: list, n_seg: int):
        """Counting with edge metadata: ``count_mask`` over the bucket's
        sender classes (``acc[i]``: the bool [n, w] plane of slots accepted
        toward i)."""
        return count_mask(acc, d.cls, self.required, d.seg_id, n_seg)

    def _superstep(self, tv, alive, tp_flag, *, init: bool):
        """One superstep over every bucket. Returns (tv, alive, tp_flag,
        stats) with stats = [av per rank | ae per rank | msg per rank |
        died] as an int64 device tensor. The default and the counting mode
        are one fused superstep (ops/lcc_fused.py; the counting rule rides
        on the planes' ``cls`` and the template's ``required``), a counting
        superstep in one ``fpm.lcc.count`` span; edge metadata runs per
        bucket (``_per_bucket``)."""
        if self.counting:
            trace.count("lcc_count_supersteps")
            with trace.span("fpm.lcc.count"):
                if self.meta_allow is not None:
                    return self._per_bucket(tv, alive, tp_flag, init=init)
                return self._fused(tv, alive, tp_flag, init=init)
        if self.meta_allow is not None:
            return self._per_bucket(tv, alive, tp_flag, init=init)
        return self._fused(tv, alive, tp_flag, init=init)

    def _fused(self, tv, alive, tp_flag, *, init: bool):
        """K1, or ``alive_table`` + ``rev_alive_lookup`` + K2."""
        if init:
            return init_superstep(self._planes, tv, self._tmpl)
        alive_rev = rev_alive_lookup(self._rev_flat, alive_table(alive))
        return continuation_superstep(
            self._planes, tv, alive, tp_flag, alive_rev, self._tmpl
        )

    def _per_bucket(self, tv, alive, tp_flag, *, init: bool):
        """``_superstep`` of the edge-metadata mode (with or without the
        counting rule): plain torch per bucket."""
        dev = self.device
        r = self.num_ranks
        av = torch.zeros(r, dtype=torch.int64, device=dev)
        ae = torch.zeros(r, dtype=torch.int64, device=dev)
        msg = torch.zeros(r, dtype=torch.int64, device=dev)
        died = torch.zeros((), dtype=torch.bool, device=dev)
        new_tv = torch.zeros(self.num_vertices, dtype=torch.int32, device=dev)
        new_alive = torch.zeros(self.num_slots + 1, dtype=torch.bool, device=dev)
        if not init:
            tv_table = torch.cat([tv, tv.new_zeros(1)])
            alive_rev_flat = rev_alive_lookup(self._rev_flat, alive_table(alive))

        for b, d in zip(self.buckets, self._dev):
            n, w = b.adj.shape
            n_seg = len(b.seg_rows)
            split = n_seg != n
            lo, hi = b.slot_base, b.slot_base + n * w
            tv_seg = tv[d.seg_rows]
            if init:
                # tv == label_tv: the neighbour's candidates from its label
                p = self._code_tv[d.code.to(torch.int32)]
                send_ok = p != 0
                sendok_rows = send_ok.sum(dim=1, dtype=torch.int32)
            else:
                p = tv_table[d.adj]
                send_ok = (p != 0) & alive_rev_flat[lo:hi].view(n, w)
                p = torch.where(send_ok, p, 0)
                sendok_rows = send_ok.sum(dim=1, dtype=torch.int32)

            # per-slot allowed parents toward each receiver bit i (the slot's
            # metadata code selects the allow row) and a separate tn per bit
            code = d.meta.to(torch.int32)
            mask = torch.zeros_like(p)
            tn_list = []
            acc = []
            for i in range(self.k):
                allow_i = self.meta_allow[i][code]
                has_i = (((tv_seg >> i) & 1) != 0)[d.seg_id]
                mask = mask | torch.where(has_i[:, None], allow_i, 0)
                p_i = p & allow_i
                tn_i = row_or(p_i)
                tn_list.append(
                    segment_or(tn_i, d.seg_id, n_seg) if split else tn_i
                )
                if self.counting:
                    acc.append(p_i != 0)
            accept = (p & mask) != 0
            in_map = accept.any(dim=1)
            if split:
                in_map = torch.zeros(
                    n_seg, dtype=torch.int32, device=dev
                ).index_add_(0, d.seg_id, in_map.to(torch.int32)) > 0
            new_tv_seg = tv_seg & self._keep_mask_per_i(tn_list)
            if self.counting:
                new_tv_seg = new_tv_seg & self._count_mask(d, acc, n_seg)

            if init:
                new_tv_seg = torch.where(in_map, new_tv_seg, 0)
                died_b = in_map & (new_tv_seg == 0)
            else:
                died_b = (tv_seg != 0) & (new_tv_seg == 0)
            died = died | died_b.any()

            live_seg = new_tv_seg != 0
            row_live = live_seg[d.seg_id][:, None]
            if init:
                new_alive_b = accept & row_live
            else:
                own_alive = alive[lo:hi].view(n, w)
                own_flag = tp_flag[lo:hi].view(n, w)
                new_alive_b = own_alive & (accept | own_flag) & row_live
            new_alive[lo:hi] = new_alive_b.view(-1)
            new_tv[d.seg_rows] = new_tv_seg

            ae_rows = new_alive_b.sum(dim=1)
            if r == 1:
                av += live_seg.sum()
                ae += ae_rows.sum()
                msg += sendok_rows.sum()
            else:
                av.index_add_(0, d.own_seg, live_seg.to(torch.int64))
                ae.index_add_(0, d.own_rows, ae_rows)
                msg.index_add_(0, d.own_rows, sendok_rows.to(torch.int64))

        stats = torch.cat([av, ae, msg, died.to(torch.int64).view(1)])
        return new_tv, new_alive, torch.zeros_like(new_alive), stats

    # ------------------------------------------------------------------

    def _tv_to_device(self, tv_np: np.ndarray) -> torch.Tensor:
        return to_device(np.array(tv_np, dtype=np.uint32).view(np.int32), self.device)

    def _slots_to_device(self, slots: np.ndarray) -> torch.Tensor:
        """bool [S+1] device array with the given slots set (pad slot S
        stays dead)."""
        flags = np.zeros(self.num_slots + 1, dtype=bool)
        flags[slots] = True
        flags[-1] = False
        return to_device(flags, self.device)

    def init_state(self) -> BucketedState:
        dev = self.device
        return BucketedState(
            tv=torch.zeros(self.num_vertices, dtype=torch.int32, device=dev),
            alive=torch.zeros(self.num_slots + 1, dtype=torch.bool, device=dev),
            tp_flag=torch.zeros(self.num_slots + 1, dtype=torch.bool, device=dev),
        )

    def state_from_jax(self, tv, alive, tp_flag) -> BucketedState:
        """State from the JAX engine's ``BucketedState`` arrays, as numpy:
        tv uint32 [V], alive and tp_flag bool [S+1]. The slot layouts are
        identical, so both engines continue from the same state."""
        tv = np.asarray(tv)
        alive = np.asarray(alive, dtype=bool)
        tp_flag = np.asarray(tp_flag, dtype=bool)
        want = (self.num_slots + 1,)
        if tv.shape != (self.num_vertices,) or alive.shape != want or tp_flag.shape != want:
            raise ValueError("state_from_jax: shapes do not match this engine")
        return BucketedState(
            tv=self._tv_to_device(tv),
            alive=self._slots_to_device(np.nonzero(alive)[0]),
            tp_flag=self._slots_to_device(np.nonzero(tp_flag)[0]),
        )

    def state_from_global(self, tv, edge_alive, tp_flag) -> BucketedState:
        e2s = self._edge_to_slot
        return BucketedState(
            tv=self._tv_to_device(tv),
            alive=self._slots_to_device(e2s[np.asarray(edge_alive, dtype=bool)]),
            tp_flag=self._slots_to_device(e2s[np.asarray(tp_flag, dtype=bool)]),
        )

    def state_to_global(self, state: BucketedState):
        al_flat = to_host(state.alive)
        return self.tv_host(state).copy(), al_flat[self._edge_to_slot]

    def tv_host(self, state: BucketedState) -> np.ndarray:
        if state.tv_np is None:
            state.tv_np = to_host(state.tv).view(np.uint32)
        return state.tv_np

    def alive_pairs(self, state: BucketedState):
        """(row, col) int64 arrays of the alive slots in CSR row-major
        order: the alive slots found on the device, only their (row, col)
        keys downloaded, in one ``fpm.pairs`` span (none where the state
        holds them already)."""
        if state.pairs_cache is not None:
            return state.pairs_cache
        v = self.num_vertices
        with trace.span("fpm.pairs"):
            keys = [torch.empty(0, dtype=torch.int64, device=self.device)]
            for b, d in zip(self.buckets, self._dev):
                n, w = b.adj.shape
                sel = torch.nonzero(state.alive[b.slot_base : b.slot_base + n * w])
                sel = sel.view(-1)
                keys.append(d.rows[sel // w] * v + d.adj.view(-1)[sel])
            # keys are unique: sorting them is CSR row-major order
            k = to_host(torch.sort(torch.cat(keys)).values)
        state.pairs_cache = (k // v, k % v)
        return state.pairs_cache

    def state_from_edge_ids(
        self, tv: np.ndarray, edge_ids: np.ndarray, flag_ids=None,
    ) -> BucketedState:
        """State whose alive set is exactly the given original edge ids;
        ``flag_ids`` optionally sets TP success marks on those edges."""
        eids = np.asarray(edge_ids, dtype=np.int64)
        tv32 = np.asarray(tv).astype(np.uint32)
        fids = np.empty(0, np.int64) if flag_ids is None else np.asarray(
            flag_ids, dtype=np.int64
        )
        return BucketedState(
            tv=self._tv_to_device(tv32),
            alive=self._slots_to_device(self._edge_to_slot[eids]),
            tp_flag=self._slots_to_device(self._edge_to_slot[fids]),
            tv_np=tv32,
        )

    def state_on_alive(
        self, tv: np.ndarray, alive: torch.Tensor, flag_ids=None,
    ) -> BucketedState:
        """State over the device alive plane ``alive`` as it is (another
        state's: no superstep writes its input in place), with tv uploaded
        and TP success marks on the edge ids ``flag_ids`` alone, set on a
        fresh plane: what ``state_from_edge_ids`` gives for the plane's
        alive edges."""
        tv32 = np.asarray(tv).astype(np.uint32)
        flag = torch.zeros(self.num_slots + 1, dtype=torch.bool, device=self.device)
        if flag_ids is not None and len(flag_ids):
            slots = self._edge_to_slot[np.asarray(flag_ids, dtype=np.int64)]
            flag[to_device(slots, self.device)] = True
        return BucketedState(
            tv=self._tv_to_device(tv32), alive=alive, tp_flag=flag, tv_np=tv32,
        )

    def with_updates(self, state: BucketedState, tv: np.ndarray, tp_marks):
        """Replace tv and set token-passing success marks (slot flags)."""
        tv32 = np.asarray(tv).astype(np.uint32)
        flag = state.tp_flag
        if tp_marks:
            idx = self._edge_to_slot[np.asarray(list(tp_marks), dtype=np.int64)]
            flag = flag.clone()
            flag[to_device(idx, self.device)] = True
        return BucketedState(
            tv=self._tv_to_device(tv32),
            alive=state.alive,
            tp_flag=flag,
            # alive is unchanged, so the pairs stay valid
            pairs_cache=state.pairs_cache,
            tv_np=tv32,
        )

    def lcc_call(
        self, state: BucketedState, global_init_step: bool,
        n_steps: int | None = None,
    ):
        """Run ``n_steps`` supersteps (default: the pattern's diameter); the
        first is the global init step when ``global_init_step``, each over
        all ``num_slots`` slots (counted in ``lcc_slots``). Returns (state,
        rows, died) with one (av, ae, msgs, per_rank) row per superstep."""
        if n_steps is None:
            n_steps = self.p.diameter
        trace.count("lcc_slots", n_steps * self.num_slots)
        tv, alive, flag = state.tv, state.alive, state.tp_flag
        stats = []
        for step in range(n_steps):
            init = global_init_step and step == 0
            tv, alive, flag, st = self._superstep(
                self.label_tv if init else tv, alive, flag, init=init
            )
            stats.append(st)
        rows, any_died = (
            stats_rows(to_host(torch.stack(stats)), self.num_ranks) if stats else ([], False)
        )
        return BucketedState(tv, alive, flag), rows, any_died
