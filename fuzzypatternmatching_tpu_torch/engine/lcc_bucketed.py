"""Bucketed-ELL LCC engine on torch tensors.

Counterpart of ``fuzzypatternmatching_tpu/engine/lcc_bucketed.py`` (default
mode). The adjacency is laid out in degree buckets: vertices of similar
(deduplicated) degree share a dense ``[rows, width]`` neighbour matrix
padded to a power-of-two width between ``min_width`` and ``max_width``;
hubs wider than ``max_width`` are split over several rows of the widest
bucket and their partial results combined by ``_segment_or``. The slot
layout (bucket order, ``slot_base``, ``rev``, the edge-to-slot map) is the
JAX engine's, so states convert between the two (``state_from_jax``).

A superstep runs per bucket:

* init (global init step): the neighbour candidates are the neighbours'
  label bitsets, replayed from per-slot label codes; accept test against
  the row's pattern-adjacency mask, row OR, keep mask — plain torch;
* otherwise: the hand-written kernels of ``ops/lcc_superstep.py``. Once
  per superstep over every bucket, ``alive_table`` packs the alive flags
  (words and group summary) and ``rev_alive_lookup`` reads the alive bit
  of every slot's reverse edge (``rev`` is one flat [S] tensor, each
  bucket's plane a view of it); then per bucket ``gather_accept_or`` on
  the tv table, the keep mask and the alive update.

tv is int32 holding the 16-bit candidate set; alive and the token-passing
flags are bool over the flat slot space plus one always-dead pad slot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.lcc_superstep import (
    alive_table,
    gather_accept_or,
    rev_alive_lookup,
    row_or,
)
from ..pattern.pattern_graph import PatternGraph
from .lazy_state import merged_flag_ids, normalized_edge_ids, normalized_flag_ids

MAX_TEMPLATE_VERTICES = 16  # tv and the kernels' tables hold 16 bits


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


@dataclass
class BucketedState:
    tv: torch.Tensor | None  # int32 [V] on the engine's device
    alive: torch.Tensor | None  # bool [S+1] (last slot always dead)
    tp_flag: torch.Tensor | None  # bool [S+1]
    # memo for alive_pairs (the driver asks several times per phase)
    pairs_cache: tuple | None = None
    # host copy of tv (uint32)
    tv_np: np.ndarray | None = None
    # LAZY representation: between compact continuations the state lives on
    # the host as sorted original edge ids (alive set) and TP-marked edge
    # ids; tv/alive/tp_flag are None then and are uploaded only if a full
    # lcc_call runs on it
    lazy_edge_ids: np.ndarray | None = None
    lazy_flag_ids: np.ndarray | None = None


class BucketedLccEngine:
    def __init__(
        self,
        graph: Graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        *,
        device: torch.device | str,
        num_ranks: int = 1,
        min_width: int = 8,
        max_width: int = 8192,
        edge_meta: tuple[np.ndarray, np.ndarray] | None = None,
        counting: bool = False,
    ):
        if edge_meta is not None:
            raise ValueError(
                "edge-metadata matching is not ported to the torch engine"
            )
        if counting:
            raise ValueError("counting mode is not ported to the torch engine")
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

        # --- device planes -------------------------------------------------
        dev = self.device
        lab_tv = pattern.label_match_bitset(np.asarray(labels)).astype(np.int32)
        self.label_tv = torch.from_numpy(lab_tv).to(dev)
        self._code_tv = torch.from_numpy(code_tv).to(dev)
        # rev of every slot, bucket after bucket: one lookup launch covers
        # the whole slot space
        self._rev_flat = torch.from_numpy(
            np.concatenate(
                [b.rev.reshape(-1) for b in self.buckets]
                + [np.empty(0, dtype=np.int32)]
            )
        ).to(dev)
        self._dev = []
        for b in self.buckets:
            rows = torch.from_numpy(b.rows.astype(np.int64)).to(dev)
            seg_rows = torch.from_numpy(b.seg_rows.astype(np.int64)).to(dev)
            self._dev.append(
                _DeviceBucket(
                    rows=rows,
                    adj=torch.from_numpy(b.adj).to(dev),
                    code=torch.from_numpy(code_pad[b.adj]).to(dev),
                    seg_id=torch.from_numpy(b.seg_id.astype(np.int64)).to(dev),
                    seg_rows=seg_rows,
                    own_rows=rows % num_ranks,
                    own_seg=seg_rows % num_ranks,
                )
            )

    # ------------------------------------------------------------------

    def _or_over_bits(self, tv: torch.Tensor) -> torch.Tensor:
        m = torch.zeros_like(tv)
        for i in range(self.k):
            m = m | (((tv >> i) & 1) * self.adj_all[i])
        return m

    def _keep_mask(self, tn: torch.Tensor) -> torch.Tensor:
        keep = torch.zeros_like(tn)
        for i in range(self.k):
            ok = (self.mand[i] & ~tn) == 0
            if self.opt_min[i] > 0:
                t = self.opt[i] & tn
                count = torch.zeros_like(t)
                for bit in range(MAX_TEMPLATE_VERTICES):
                    count = count + ((t >> bit) & 1)
                ok = ok & (t == self.opt[i]) & (count >= self.opt_min[i])
            keep = keep | (ok.to(torch.int32) << i)
        return keep

    @staticmethod
    def _segment_or(values: torch.Tensor, seg_id: torch.Tensor, n_seg: int):
        """OR-combine int32 16-bit values per segment (split-hub partials)
        through a max over bit planes."""
        shifts = torch.arange(
            MAX_TEMPLATE_VERTICES, dtype=torch.int32, device=values.device
        )
        planes = (values[:, None] >> shifts) & 1
        seg = torch.zeros(
            (n_seg, MAX_TEMPLATE_VERTICES), dtype=torch.int32,
            device=values.device,
        ).scatter_reduce(
            0, seg_id[:, None].expand_as(planes), planes, "amax"
        )
        return (seg << shifts).sum(dim=1, dtype=torch.int32)

    def _superstep(self, tv, alive, tp_flag, *, init: bool):
        """One superstep over every bucket. Returns (tv, alive, tp_flag,
        stats) with stats = [av per rank | ae per rank | msg per rank |
        died] as an int64 device tensor."""
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
            lo, hi = b.slot_base, b.slot_base + n * w
            tv_seg = tv[d.seg_rows]
            adj_mask_rows = self._or_over_bits(tv_seg)[d.seg_id]
            if init:
                p = self._code_tv[d.code.to(torch.int32)]
                send_ok = p != 0
                accept = (p & adj_mask_rows[:, None]) != 0
                tn_rows = row_or(torch.where(accept, p, 0))
                sendok_rows = send_ok.sum(dim=1, dtype=torch.int32)
            else:
                alive_rev = alive_rev_flat[lo:hi].view(n, w)
                tn_rows, accept, sendok_rows = gather_accept_or(
                    d.adj, alive_rev, adj_mask_rows, tv_table
                )
            tn = self._segment_or(tn_rows, d.seg_id, n_seg) if n_seg != n else tn_rows

            new_tv_seg = tv_seg & self._keep_mask(tn)
            if init:
                in_map = tn != 0
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
        return torch.from_numpy(
            np.array(tv_np, dtype=np.uint32).view(np.int32)
        ).to(self.device)

    def _slots_to_device(self, slots: np.ndarray) -> torch.Tensor:
        """bool [S+1] device array with the given slots set (pad slot S
        stays dead)."""
        flags = np.zeros(self.num_slots + 1, dtype=bool)
        flags[slots] = True
        flags[-1] = False
        return torch.from_numpy(flags).to(self.device)

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
        if state.alive is None:
            edge_alive = np.zeros(self.graph.num_edges, dtype=bool)
            edge_alive[state.lazy_edge_ids] = True
            return state.tv_np.copy(), edge_alive
        al_flat = state.alive.cpu().numpy()
        return self.tv_host(state).copy(), al_flat[self._edge_to_slot]

    def tv_host(self, state: BucketedState) -> np.ndarray:
        if state.tv_np is None:
            state.tv_np = state.tv.cpu().numpy().view(np.uint32)
        return state.tv_np

    def alive_pairs(self, state: BucketedState):
        """(row, col) int64 arrays of the alive slots in CSR row-major
        order. Device states find the alive slots on the device and
        download only their (row, col) keys."""
        if state.pairs_cache is not None:
            return state.pairs_cache
        if state.alive is None:
            # lazy state: ascending edge ids are CSR row-major order
            eids = state.lazy_edge_ids
            state.pairs_cache = (
                self.graph.edge_row[eids].astype(np.int64),
                self.graph.cols[eids].astype(np.int64),
            )
            return state.pairs_cache
        v = self.num_vertices
        keys = [torch.empty(0, dtype=torch.int64, device=self.device)]
        for b, d in zip(self.buckets, self._dev):
            n, w = b.adj.shape
            sel = torch.nonzero(state.alive[b.slot_base : b.slot_base + n * w])
            sel = sel.view(-1)
            keys.append(d.rows[sel // w] * v + d.adj.view(-1)[sel])
        # keys are unique: sorting them is CSR row-major order
        k = torch.sort(torch.cat(keys)).values.cpu().numpy()
        state.pairs_cache = (k // v, k % v)
        return state.pairs_cache

    def state_from_edge_ids(
        self, tv: np.ndarray, edge_ids: np.ndarray, flag_ids=None,
        lazy: bool = False,
    ) -> BucketedState:
        """State whose alive set is exactly the given original edge ids;
        ``flag_ids`` optionally sets TP success marks on those edges.
        ``lazy=True`` keeps the state on the host (see BucketedState)."""
        eids = normalized_edge_ids(edge_ids)
        tv32 = np.asarray(tv).astype(np.uint32)
        if lazy:
            return BucketedState(
                tv=None, alive=None, tp_flag=None, tv_np=tv32,
                lazy_edge_ids=eids,
                lazy_flag_ids=normalized_flag_ids(flag_ids),
            )
        fids = np.empty(0, np.int64) if flag_ids is None else np.asarray(
            flag_ids, dtype=np.int64
        )
        return BucketedState(
            tv=self._tv_to_device(tv32),
            alive=self._slots_to_device(self._edge_to_slot[eids]),
            tp_flag=self._slots_to_device(self._edge_to_slot[fids]),
            tv_np=tv32,
        )

    def _materialize(self, state: BucketedState) -> BucketedState:
        """Device arrays for a lazy state (no-op otherwise)."""
        if state.alive is not None:
            return state
        s = self.state_from_edge_ids(
            state.tv_np, state.lazy_edge_ids, flag_ids=state.lazy_flag_ids
        )
        s.pairs_cache = state.pairs_cache
        return s

    def with_updates(self, state: BucketedState, tv: np.ndarray, tp_marks):
        """Replace tv and set token-passing success marks (slot flags)."""
        tv32 = np.asarray(tv).astype(np.uint32)
        if state.alive is None:
            return BucketedState(
                tv=None, alive=None, tp_flag=None, tv_np=tv32,
                pairs_cache=state.pairs_cache,
                lazy_edge_ids=state.lazy_edge_ids,
                lazy_flag_ids=merged_flag_ids(state.lazy_flag_ids, tp_marks),
            )
        flag = state.tp_flag
        if tp_marks:
            idx = self._edge_to_slot[np.asarray(list(tp_marks), dtype=np.int64)]
            flag = flag.clone()
            flag[torch.from_numpy(idx).to(self.device)] = True
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
        first is the global init step when ``global_init_step``. Returns
        (state, rows, died) with one (av, ae, msgs, per_rank) row per
        superstep."""
        if n_steps is None:
            n_steps = self.p.diameter
        state = self._materialize(state)
        tv, alive, flag = state.tv, state.alive, state.tp_flag
        stats = []
        for step in range(n_steps):
            init = global_init_step and step == 0
            tv, alive, flag, st = self._superstep(
                self.label_tv if init else tv, alive, flag, init=init
            )
            stats.append(st)
        rr = self.num_ranks
        rows = []
        any_died = False
        if stats:
            st_np = torch.stack(stats).cpu().numpy()
            for row in st_np:
                per = {
                    "av": row[0:rr].copy(),
                    "ae": row[rr : 2 * rr].copy(),
                    "msg": row[2 * rr : 3 * rr].copy(),
                }
                rows.append(
                    (int(per["av"].sum()), int(per["ae"].sum()),
                     int(per["msg"].sum()), per)
                )
            any_died = bool((st_np[:, -1] != 0).any())
        return BucketedState(tv, alive, flag), rows, any_died
