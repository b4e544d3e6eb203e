"""Multi-device LCC: the superstep over a 1-D mesh of shards.

The port of ``fuzzypatternmatching_tpu/parallel/sharded.py``. The layout is
the JAX engine's:

* **Balanced edge partition with hub splitting.** The CSR edges are cut
  into n contiguous chunks of about E/n; a hub row that spans a chunk
  boundary is split across shards (the reference's delegate replication):
  each shard ORs its fragment's partial neighbour bitset and the partials
  meet at the vertex's owner.
* **Vertex-block ownership.** tv is block-partitioned, owner = v // block,
  the owner function of the mesh NLCC router too (``nlcc_sharded.py``).
* **Halo exchange.** Each superstep moves (i) the tv of each chunk's own
  row range, (ii) one payload word per reverse-edge slot a chunk reads,
  ``alive << 31 | row tv``, so that one gather gives both the sender's
  candidates and its alive flag, and (iii) the per-row partial ORs to the
  owners and the new tv back. Send and receive index lists are built once,
  at construction. At n = 1 the identity exchanges collapse (the payload
  array is the gather table itself).
* **ELL buckets per chunk**: each chunk's row fragments sit in buckets of
  the half-step widths ``WIDTHS`` (a fragment longer than 1,024 splits into
  full 1,024-wide pieces, all in the widest bucket); bucket shapes are the
  same on every shard (the most rows any chunk has of a width).
* Convergence counters are sums over the mesh (``Mesh.psum``), and the
  per-output-rank attribution is ``gid % num_ranks`` over each owner block.

The superstep is per-shard code between the mesh's exchanges
(``parallel/mesh.py``); a process runs its own shards one after the other.
On a mesh across processes every process builds the same host layout (as
every JAX process builds the same global arrays before ``device_put``) and
uploads and runs only its own shards; the exchanges and the counters go
through the process group, so ``lcc_call`` returns the same rows in every
process. The host reads of the whole state (``tv_host``, ``alive_pairs``,
``state_to_global``, ``with_updates``) serve the
single-controller host loop of ``MatchEngine`` and refuse such a mesh;
``local_blocks`` reads each process's own shards.
Its default, non-init branch calls ``gather_accept_or_payload`` once per
shard over all of its buckets (two kernels: the pack of the payload halo's
sends bits, and the gather through them); the init superstep, the counting
and the metadata branches are plain torch, as in the bucketed engine. Left
out, as TPU workarounds: the cummax segment forms, the scan-chunking of
long calls, the packed transfer mirrors and the host reconstruction of the
post-init state (``alive_pairs`` is a device nonzero and a sort), and the
power-of-two rounding of the halo sizes.

``comm_stats`` is the JAX engine's accounting of the three exchanges (the
reference's mailbox counters), from the request lists built at
construction: per shard, the useful entries of the tv halo, the payload
halo (``alive_halo``) and the partial-OR exchange (``directions: 2``:
partials in, new tv back), split into ``useful_intra`` (to itself) and
``useful_cross``; ``wire_entries_per_device``, the exchange's padded size
per shard; ``entry_bytes``; and per shard ``cut_edges`` (slots whose
reverse edge another shard holds) and ``local_rev_edges``. The useful
counts and the edge counts equal the JAX engine's. The wire sizes are
``n * halo_h``, ``n * halo_hrev`` and ``n * halo_k``, exact where the JAX
engine rounds to powers of two, so never larger; the alive halo's entry
is the 4-byte payload word (1 byte in JAX, whose alive halo carries the
flag alone). ``Mesh.cross_bytes`` counts what actually crosses processes.

Pad slots are inert: their reverse-edge index reads the appended zero
payload word, and their label code is 0. Every scatter of the exchanges
writes pads to a scratch row past the end, which is sliced off.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.lcc_bucketed import (
    MAX_TEMPLATE_VERTICES,
    keep_mask_per_i,
    or_over_bits,
    segment_or,
)
from ..ops.lcc_superstep import gather_accept_or_payload, row_or
from ..engine.result import stats_rows
from ..pattern.pattern_graph import PatternGraph
from .mesh import Mesh

# ELL bucket widths (half steps up to the cap): against power-of-two widths
# up to 8192 they cut the padding of the R-MAT s21 ELL from 1.44x to 1.22x
WIDTHS = [8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024]
# bit 31 of an int32 payload word: the sender's edge is alive
_ALIVE_BIT = torch.iinfo(torch.int32).min


def _unique_inverse(keys: np.ndarray, size: int):
    """(sorted distinct keys, each key's index among them) of keys in
    [0, size), by a mark array and its running count: linear, no sort."""
    mark = np.zeros(size, dtype=bool)
    mark[keys] = True
    rank = np.cumsum(mark, dtype=np.int32 if size < 2**31 else np.int64)
    return np.flatnonzero(mark), rank[keys].astype(np.int64) - 1


@dataclass
class ShardedState:
    tv: list  # per shard int32 [block], the owner blocks of tv
    alive: list  # per shard bool [S], the chunk's ELL slots
    tp_flag: list  # per shard bool [S]
    # memo for alive_pairs: (rows, cols, edge ids)
    pairs_cache: tuple | None = None
    tv_np: np.ndarray | None = None  # host copy of tv (uint32 [V])


@dataclass
class _Shard:
    """One shard's tables, on its device."""

    device: torch.device
    revmap: torch.Tensor  # int32 [S]: payload-halo index of each slot's reverse edge
    rowmap: torch.Tensor  # int64 [rmax]: row-tv halo index of each local row
    sendidx_tv: torch.Tensor | None  # int64 [n, H]: own tv entries for each chunk
    sendidx_al: torch.Tensor | None  # int64 [n, Hrev]: own payload slots for each chunk
    sendrows: torch.Tensor  # int64 [n, K]: local rows for each owner (pad rmax)
    ridx: torch.Tensor  # int64 [n, K]: owner block rows from each chunk (pad block)
    code: torch.Tensor  # label code of each slot's neighbour [S] (0 = pad)
    label_tv: torch.Tensor  # int32 [block]
    init_rowtv: torch.Tensor  # int32 [rmax]: label tv of each local row
    ellrow_row: torch.Tensor  # int64 [n_ellrows]: local row of each ELL row (pad rmax)
    seg_id_wide: torch.Tensor  # int64: distinct-row index of each widest-bucket row
    row_to_segpos: torch.Tensor  # int64 [rmax]: local row -> per-bucket row outputs
    slot_to_edge: torch.Tensor  # int32 [S]: CSR edge of each slot, -1 pad
    code_tv: torch.Tensor  # int32 [labels + 1]: label code -> label tv
    rank_ell: torch.Tensor | None = None  # int64 [n_ellrows]: output rank per ELL row
    rank_own: torch.Tensor | None = None  # int64 [block]: output rank per owned vertex
    meta: torch.Tensor | None = None  # [S] metadata code per slot (pad: all-zero row)
    meta_allow: list | None = None  # per template vertex i: int32 [M + 1]
    cls: torch.Tensor | None = None  # uint8 [S] sender label class (counting)


class ShardedLccEngine:
    """The LCC engine API (``lcc_call``, states, ``alive_pairs``) over an
    n-shard mesh. ``graph`` is a ``Graph`` or a ``storage.GraphDb``: it is
    read only through the edge-range accessors."""

    def __init__(
        self,
        graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        mesh: Mesh | None = None,
        num_devices: int | None = None,
        num_ranks: int = 1,
        edge_meta: tuple[np.ndarray, np.ndarray] | None = None,
        counting: bool = False,
        *,
        device: torch.device | str = "cuda",
    ):
        if pattern.vertex_count > MAX_TEMPLATE_VERTICES:
            raise ValueError(
                f"templates of more than {MAX_TEMPLATE_VERTICES} vertices "
                "are not supported"
            )
        if mesh is None:
            from ..utils.dist import build_mesh

            mesh = build_mesh(num_devices=num_devices, device=device)
        self.mesh = mesh
        self.n = n = mesh.n  # global shards; this process holds mesh.shard_ids
        self.graph = graph
        self.p = pattern
        self.num_ranks = num_ranks
        v = graph.num_vertices
        e = graph.num_edges
        self.num_vertices = v
        self.block = b = -(-v // n)
        self.vpad = n * b
        self.ec = ec = max(-(-e // n), 1)

        # --- balanced contiguous edge chunks (hub rows may split) ----------
        rowstart = np.zeros(n, dtype=np.int64)
        rowend = np.zeros(n, dtype=np.int64)
        for r in range(n):
            lo, hi = r * ec, min((r + 1) * ec, e)
            if lo < hi:
                ends = graph.edge_row_at(np.array([lo, hi - 1], dtype=np.int64))
                rowstart[r], rowend[r] = ends[0], ends[1]
            else:  # empty trailing chunk: a degenerate single-row range
                rowstart[r] = rowend[r] = max(v - 1, 0)
        self.rmax = rmax = int(max(rowend - rowstart + 1))

        # --- row fragments per chunk, in ELL width buckets -----------------
        cap = WIDTHS[-1]
        frag_rows, frag_offs, frag_lens, frag_wes, col_chunks = [], [], [], [], []
        for r in range(n):
            lo, hi = r * ec, min((r + 1) * ec, e)
            cnt = max(hi - lo, 0)
            hi = max(hi, lo)
            col_chunks.append(np.asarray(graph.cols_range(lo, hi)))
            if cnt == 0:
                for acc in (frag_rows, frag_offs, frag_lens, frag_wes):
                    acc.append(np.empty(0, dtype=np.int64))
                continue
            lr = (np.asarray(graph.edge_row_range(lo, hi)) - rowstart[r]).astype(np.int64)
            heads = np.concatenate(([True], lr[1:] != lr[:-1]))
            hpos = np.nonzero(heads)[0]
            flen = np.diff(np.concatenate((hpos, [cnt])))
            frow, foff = lr[hpos], hpos
            # fragments wider than the cap split into cap-wide pieces
            npieces = -(-flen // cap)
            prow = np.repeat(frow, npieces)
            pidx = np.arange(len(prow)) - np.repeat(np.cumsum(npieces) - npieces, npieces)
            poff = np.repeat(foff, npieces) + pidx * cap
            plen = np.minimum(np.repeat(foff + flen, npieces) - poff, cap)
            pwe = np.searchsorted(WIDTHS, np.maximum(plen, WIDTHS[0]))
            # every piece of a split fragment stays in the widest bucket (a
            # short tail in a narrower bucket would put one row in two
            # buckets and lose a partial in the combine)
            pwe = np.where(np.repeat(npieces > 1, npieces), len(WIDTHS) - 1, pwe)
            frag_rows.append(prow)
            frag_offs.append(poff)
            frag_lens.append(plen)
            frag_wes.append(pwe)
        wes_present = sorted(set(int(w) for ws in frag_wes for w in np.unique(ws))) or [0]
        # unified bucket table: per width, the most pieces any chunk has
        nb_by_we = {
            we: max(max(int(np.sum(frag_wes[r] == we)) for r in range(n)), 1)
            for we in wes_present
        }
        self.ell_buckets = []  # (width index, width, slot offset, rows, row offset)
        off = row_off = 0
        for we in wes_present:
            nb, w = nb_by_we[we], WIDTHS[we]
            self.ell_buckets.append((we, w, off, nb, row_off))
            off += nb * w
            row_off += nb
        self.S = S = off
        self.n_ellrows = row_off
        self.bucket_dims = [(w, nb) for _, w, _, nb, _ in self.ell_buckets]
        if n * S >= np.iinfo(np.int32).max:
            raise ValueError(f"{n * S} slots do not fit int32 slot ids")

        slot_to_edge = np.full((n, S), -1, dtype=np.int64)
        ellrow_row = np.full((n, self.n_ellrows), rmax, dtype=np.int64)
        for r in range(n):
            for we, w, boff, _, broff in self.ell_buckets:
                sel = np.nonzero(frag_wes[r] == we)[0]
                if len(sel) == 0:
                    continue
                j = np.arange(len(sel))
                offs = np.arange(w)
                valid = offs[None, :] < frag_lens[r][sel][:, None]
                pos = (boff + j * w)[:, None] + offs[None, :]
                eid = (r * ec + frag_offs[r][sel])[:, None] + offs[None, :]
                slot_to_edge[r, pos[valid]] = eid[valid]
                ellrow_row[r, broff + j] = frag_rows[r][sel]
        # distinct-row (segment) spaces: only the widest bucket can hold
        # several pieces of one row, and they are consecutive there
        _, _, _, nb_wide, roff_wide = self.ell_buckets[-1]
        seg_id_wide = np.zeros((n, nb_wide), dtype=np.int64)
        nseg_wide = 1
        for r in range(n):
            rows_w = ellrow_row[r, roff_wide : roff_wide + nb_wide]
            heads = np.concatenate(([True], rows_w[1:] != rows_w[:-1])) & (rows_w != rmax)
            sid = np.cumsum(heads) - 1
            sid[rows_w == rmax] = 0
            seg_id_wide[r] = np.maximum(sid, 0)
            nseg_wide = max(nseg_wide, int(heads.sum()))
        self.nseg_wide = nseg_wide
        # local row -> position in the concatenated per-bucket row outputs
        # (narrow buckets one value per ELL row, the widest nseg_wide)
        self.n_segout = (self.n_ellrows - nb_wide) + nseg_wide
        row_to_segpos = np.full((n, rmax), self.n_segout, dtype=np.int64)
        for r in range(n):
            for _, _, _, nb, broff in self.ell_buckets[:-1]:
                rows_b = ellrow_row[r, broff : broff + nb]
                ok = rows_b != rmax
                row_to_segpos[r, rows_b[ok]] = broff + np.nonzero(ok)[0]
            rows_w = ellrow_row[r, roff_wide : roff_wide + nb_wide]
            ok = rows_w != rmax
            row_to_segpos[r, rows_w[ok]] = roff_wide + seg_id_wide[r][ok]

        # --- row-tv halo: each chunk receives the tv of its own contiguous
        # row range (column tv arrives in the payload halo) ------------------
        req_tv, u_meta = [], []
        for r in range(n):
            U = np.arange(rowstart[r], rowend[r] + 1, dtype=np.int64)
            seg_start = np.searchsorted(U // b, np.arange(n + 1))
            req_tv.append([U[seg_start[o] : seg_start[o + 1]] for o in range(n)])
            u_meta.append(seg_start)
        self.halo_h = H = max(1, max(len(q) for req in req_tv for q in req))
        sendidx_tv = np.full((n, n, H), b, dtype=np.int64)  # [owner, dest, H]
        rowmap = np.full((n, rmax), n * H, dtype=np.int64)
        for r in range(n):
            for o in range(n):
                q = req_tv[r][o]
                sendidx_tv[o, r, : len(q)] = q - o * b
                rowmap[r, u_meta[r][o] : u_meta[r][o + 1]] = o * H + np.arange(len(q))
        # n = 1 is the identity only when the first edge's row is vertex 0:
        # otherwise the request starts at rowstart[0] and tv would be read
        # shifted
        self._tv_identity = n == 1 and int(rowstart[0]) == 0

        # --- payload halo in ELL coordinates: per chunk, the payload words
        # of the reverse edges of its slots -----------------------------------
        e2chunk = np.full(e, -1, dtype=np.int64)
        e2pos = np.full(e, -1, dtype=np.int64)
        for r in range(n):
            ok = slot_to_edge[r] >= 0
            e2chunk[slot_to_edge[r][ok]] = r
            e2pos[slot_to_edge[r][ok]] = np.nonzero(ok)[0]
        self._edge_to_ellslot = e2chunk * S + e2pos
        req_al, rv_meta = [], []
        for r in range(n):
            lo, hi = r * ec, min((r + 1) * ec, e)
            rv_chunkarr = np.asarray(graph.rev_range(lo, max(hi, lo)))
            eids = slot_to_edge[r]
            ok = eids >= 0
            rv_eid = np.full(S, -1, dtype=np.int64)
            rv_eid[ok] = rv_chunkarr[eids[ok] - lo]
            rv_ok = rv_eid >= 0
            rv_chunk = e2chunk[rv_eid[rv_ok]]
            rv_pos = e2pos[rv_eid[rv_ok]]
            if n == 1:
                req, inv = [], None  # identity: the payload array is the table
            else:
                keys, inv = _unique_inverse(rv_chunk * S + rv_pos, n * S)
                seg_start = np.searchsorted(keys // S, np.arange(n + 1))
                req = [(keys % S)[seg_start[o] : seg_start[o + 1]] for o in range(n)]
                inv = inv - seg_start[rv_chunk]
            req_al.append(req)
            rv_meta.append((rv_ok, rv_chunk, rv_pos, inv))
        self.halo_hrev = Hrev = S if n == 1 else max(
            1, max(len(q) for req in req_al for q in req)
        )
        sendidx_al = np.full((n, n, Hrev), S, dtype=np.int64)  # [owner, dest, Hrev]
        revmap = np.full((n, S), n * Hrev, dtype=np.int32)
        for r in range(n):
            rv_ok, rv_chunk, rv_pos, inv = rv_meta[r]
            if n == 1:
                revmap[r][rv_ok] = rv_pos
                continue
            for o in range(n):
                q = req_al[r][o]
                sendidx_al[o, r, : len(q)] = q
            revmap[r][rv_ok] = rv_chunk * Hrev + inv
        self._al_identity = n == 1

        # --- partial-OR exchange: chunk r's rows grouped by owner ----------
        spans = [
            [
                (max(rowstart[r], o * b),
                 max(0, min(rowend[r] + 1, (o + 1) * b) - max(rowstart[r], o * b)))
                for o in range(n)
            ]
            for r in range(n)
        ]
        self.halo_k = K = max(1, max(c for sp in spans for _, c in sp))
        sendrows = np.full((n, n, K), rmax, dtype=np.int64)  # [chunk, owner, K]
        ridx = np.full((n, n, K), b, dtype=np.int64)  # [owner, chunk, K]
        for r in range(n):
            for o in range(n):
                lo_v, cnt = spans[r][o]
                if cnt:
                    sendrows[r, o, :cnt] = np.arange(lo_v, lo_v + cnt) - rowstart[r]
                    ridx[o, r, :cnt] = np.arange(lo_v, lo_v + cnt) - o * b

        # --- communication volumes (the reference's mailbox send/recv
        # counters): per shard, the useful entries each exchange moves from
        # the request lists, split intra-/cross-shard, and the wire sizes --
        def split_counts(count):
            cnt = np.array([[count(r, o) for o in range(n)] for r in range(n)], dtype=np.int64)
            intra = np.diagonal(cnt).copy()
            return cnt.sum(axis=1) - intra, intra

        owners = [rv_meta[r][1] for r in range(n)]
        tv_cross, tv_intra = split_counts(lambda r, o: len(req_tv[r][o]))
        al_cross, al_intra = split_counts(
            lambda r, o: len(req_al[r][o]) if n > 1 else len(owners[r])
        )
        or_cross, or_intra = split_counts(lambda r, o: spans[r][o][1])
        self.comm_stats = {
            "tv_halo": {
                "useful_cross": tv_cross, "useful_intra": tv_intra,
                "wire_entries_per_device": int(n * H), "entry_bytes": 4,
            },
            "alive_halo": {  # the payload word: alive << 31 | row tv
                "useful_cross": al_cross, "useful_intra": al_intra,
                "wire_entries_per_device": int(n * Hrev), "entry_bytes": 4,
            },
            "partial_or": {  # two directions: partials in, new tv back
                "useful_cross": or_cross, "useful_intra": or_intra,
                "wire_entries_per_device": int(n * K), "entry_bytes": 4,
                "directions": 2,
            },
            "cut_edges": np.array([np.sum(owners[r] != r) for r in range(n)], dtype=np.int64),
            "local_rev_edges": np.array(
                [np.sum(owners[r] == r) for r in range(n)], dtype=np.int64
            ),
        }

        # --- init superstep: tv == label tv, so a slot's candidates are a
        # function of its neighbour's label code; no halo at init ----------
        labels = np.asarray(labels)
        uniq_labels, inv_lab = np.unique(labels, return_inverse=True)
        code_dtype = np.uint8 if len(uniq_labels) <= 255 else np.int32
        code_vert = np.zeros(v + 1, dtype=code_dtype)
        code_vert[:v] = (inv_lab.reshape(-1) + 1).astype(code_dtype)
        code_tv = np.zeros(len(uniq_labels) + 1, dtype=np.int32)
        code_tv[1:] = pattern.label_match_bitset(uniq_labels)
        lab_tv = pattern.label_match_bitset(labels).astype(np.int32)
        lab_pad = np.zeros(self.vpad, dtype=np.int32)
        lab_pad[:v] = lab_tv
        col_of_slot = []
        for r in range(n):
            ok = slot_to_edge[r] >= 0
            cs = np.full(S, v, dtype=np.int64)  # pad -> the sentinel vertex
            cs[ok] = col_chunks[r][slot_to_edge[r][ok] - r * ec]
            col_of_slot.append(cs)
        init_rowtv = np.zeros((n, rmax), dtype=np.int32)
        for r in range(n):
            rr = np.arange(rowstart[r], rowend[r] + 1)
            init_rowtv[r, : len(rr)] = lab_tv[np.minimum(rr, v - 1)] * (rr < v)

        # --- pattern constants (python ints: k <= 16 bits) ----------------
        self.k = pattern.vertex_count
        self.adj_all = [int(x) for x in pattern.edges_bitset_all]
        self.mand = [int(x) for x in pattern.edges_bitset]
        self.opt = [int(x) for x in pattern.edges_bitset_optional]
        self.opt_min = [int(x) for x in pattern.min_optional_edge_count]

        # edge metadata: per-slot codes into the allow table
        self.meta_allow = None
        mc_s = None
        if edge_meta is not None:
            allow, ecode = edge_meta
            ecode = np.asarray(ecode, dtype=np.int64)
            mzero = allow.shape[0] - 1  # the all-zero allow row
            meta_dtype = np.uint8 if allow.shape[0] <= 256 else np.int32
            mc_s = np.full((n, S), mzero, dtype=meta_dtype)
            for r in range(n):
                ok = slot_to_edge[r] >= 0
                mc_s[r][ok] = ecode[slot_to_edge[r][ok]]
            self.meta_allow = np.asarray(allow, dtype=np.uint32).astype(np.int32)
        # counting: per-slot sender label classes
        self.counting = counting
        self.required = None
        cls_s = None
        if counting:
            class_labels, self.required = pattern.neighbor_label_counts()
            class_vert = np.zeros(v + 1, dtype=np.uint8)
            for j, cl in enumerate(class_labels):
                class_vert[:v][labels == cl] = j + 1
            cls_s = [class_vert[col_of_slot[r]] for r in range(n)]

        # --- upload this process's shards ----------------------------------
        R = num_ranks
        self._shards = []
        for r, dev in zip(mesh.shard_ids, mesh.devices):
            def put(a, dev=dev):
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

            self._shards.append(_Shard(
                device=dev,
                revmap=put(revmap[r]),
                rowmap=put(rowmap[r]),
                sendidx_tv=None if self._tv_identity else put(sendidx_tv[r]),
                sendidx_al=None if self._al_identity else put(sendidx_al[r]),
                sendrows=put(sendrows[r]),
                ridx=put(ridx[r]),
                code=put(code_vert[col_of_slot[r]]),
                label_tv=put(lab_pad[r * b : (r + 1) * b]),
                init_rowtv=put(init_rowtv[r]),
                ellrow_row=put(ellrow_row[r]),
                seg_id_wide=put(seg_id_wide[r]),
                row_to_segpos=put(row_to_segpos[r]),
                slot_to_edge=put(slot_to_edge[r].astype(np.int32)),
                code_tv=put(code_tv),
                rank_ell=None if R == 1 else put(
                    (rowstart[r] + np.minimum(ellrow_row[r], rmax - 1)) % R
                ),
                rank_own=None if R == 1 else put((r * b + np.arange(b)) % R),
                meta=None if mc_s is None else put(mc_s[r]),
                meta_allow=None if mc_s is None else [
                    put(self.meta_allow[:, i]) for i in range(self.k)
                ],
                cls=None if cls_s is None else put(cls_s[r]),
            ))
        # counting: the (template vertex, label class, required count) pairs
        self._pairs = [] if not counting else [
            (i, j, int(self.required[i, j]))
            for i in range(self.k)
            for j in range(self.required.shape[1])
            if self.required[i, j] > 0
        ]

    # ---------------------------------------------------------------- shards

    def _wide_or(self, sh: _Shard, vals: torch.Tensor) -> torch.Tensor:
        return segment_or(vals, sh.seg_id_wide, self.nseg_wide)

    def _payload(self, rt_ell: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """Payload words of a chunk's slots, ``alive << 31 | row tv``, and
        an appended zero word (what pad indices read)."""
        out = torch.empty(self.S + 1, dtype=torch.int32, device=alive.device)
        out[self.S] = 0
        for _, w, off, nb, roff in self.ell_buckets:
            rt = rt_ell[roff : roff + nb, None]
            oa = alive[off : off + nb * w].view(nb, w)
            out[off : off + nb * w].view(nb, w).copy_(torch.where(oa, rt | _ALIVE_BIT, rt))
        return out

    def _chunk_partials(self, sh: _Shard, rt_ell, plH, init: bool):
        """Per-bucket work of one chunk: the per-row partials (tn, or per
        receiver bit plus accept-any with metadata) as [rmax, C], the
        counting partials [rmax, P] (or None), the accept plane per bucket,
        and the send counts per output rank."""
        meta = self.meta_allow is not None
        R = self.num_ranks
        dev = sh.device
        last = len(self.ell_buckets) - 1
        if not meta:
            m_ell = or_over_bits(rt_ell, self.adj_all)
        if not (init or meta or self.counting):
            # every bucket at once: flat per-row and per-slot outputs
            tn_all, acc_all, sor_all = gather_accept_or_payload(
                sh.revmap, m_ell, plH, self.bucket_dims
            )
        tn_parts, accany_parts = [], []
        tn_i_parts = [[] for _ in range(self.k)]
        cnt_parts = [[] for _ in self._pairs]
        acc_parts = []
        msg = torch.zeros(R, dtype=torch.int64, device=dev)
        for bi, (_, w, off, nb, roff) in enumerate(self.ell_buckets):
            sl = slice(off, off + nb * w)
            wide = bi == last
            if init:
                # tv == label tv: the neighbour's candidates from its label
                p = sh.code_tv[sh.code[sl].view(nb, w).to(torch.int64)]
                send_ok = p != 0
                sor = send_ok.sum(dim=1, dtype=torch.int32)
            elif meta or self.counting:
                p_raw = plH[sh.revmap[sl].view(nb, w)]
                p = p_raw & 0x7FFFFFFF
                # pads read the appended zero word, which fails both tests
                send_ok = (p != 0) & (p_raw < 0)
                p = torch.where(send_ok, p, 0)
                sor = send_ok.sum(dim=1, dtype=torch.int32)
            acc_i = None
            if meta:
                mc = sh.meta[sl].view(nb, w).to(torch.int64)
                rb = rt_ell[roff : roff + nb]  # receiver bits per ELL row
                mask = torch.zeros_like(p)
                acc_i = []
                for i in range(self.k):
                    allow_i = sh.meta_allow[i][mc]
                    has_i = ((rb >> i) & 1) != 0
                    mask = mask | torch.where(has_i[:, None], allow_i, 0)
                    p_i = p & allow_i
                    tn_i = row_or(p_i)
                    tn_i_parts[i].append(self._wide_or(sh, tn_i) if wide else tn_i)
                    acc_i.append(p_i != 0)
                accept = (p & mask) != 0
                aa = accept.any(dim=1).to(torch.int32)
                accany_parts.append(self._wide_or(sh, aa) if wide else aa)
            else:
                m_b = m_ell[roff : roff + nb]
                if init or self.counting:
                    accept = (p & m_b[:, None]) != 0
                    pa = torch.where(accept, p, 0)
                    tn = row_or(pa)
                    acc_i = [(pa & self.adj_all[i]) != 0 for i in range(self.k)]
                else:
                    tn, sor = tn_all[roff : roff + nb], sor_all[roff : roff + nb]
                    accept = acc_all[sl].view(nb, w)
                tn_parts.append(self._wide_or(sh, tn) if wide else tn)
            if self.counting:
                cls_b = sh.cls[sl].view(nb, w)
                for idx, (i, j, _) in enumerate(self._pairs):
                    cnt = (acc_i[i] & (cls_b == j + 1)).sum(dim=1, dtype=torch.int32)
                    if wide:
                        cnt = torch.zeros(
                            self.nseg_wide, dtype=torch.int32, device=dev
                        ).index_add_(0, sh.seg_id_wide, cnt)
                    cnt_parts[idx].append(cnt)
            acc_parts.append(accept)
            if R == 1:
                msg += sor.sum()
            else:
                msg.index_add_(0, sh.rank_ell[roff : roff + nb], sor.to(torch.int64))

        def rows(parts):
            # per-bucket row values -> [rmax]; rows of no bucket read a zero
            segall = torch.cat(parts + [parts[0].new_zeros(1)])
            return segall[sh.row_to_segpos]

        if meta:
            stack = torch.stack(
                [rows(tn_i_parts[i]) for i in range(self.k)] + [rows(accany_parts)], dim=1
            )  # [rmax, K + 1]: column K is accept-any (in_map)
        else:
            stack = rows(tn_parts)[:, None]
        cnt_stack = (
            torch.stack([rows(c) for c in cnt_parts], dim=1) if self.counting else None
        )
        return stack, cnt_stack, acc_parts, msg

    def _superstep(self, tv, alive, flag, *, init: bool):
        """One superstep on every shard. Returns (tv, alive, tp_flag, stats)
        with stats = [av per rank | ae per rank | msg per rank | died], int64
        on the first shard's device."""
        mesh, n, b, rmax = self.mesh, self.n, self.block, self.rmax
        R = self.num_ranks
        sh = self._shards
        meta = self.meta_allow is not None

        # --- row tv of each chunk's rows -----------------------------------
        if init:
            tv_loc = [s.label_tv for s in sh]
            rowtv = [s.init_rowtv for s in sh]
        else:
            tv_loc = tv
            if self._tv_identity:
                t, H = tv[0], self.halo_h
                base = t[:H] if t.shape[0] >= H else torch.cat([t, t.new_zeros(H - t.shape[0])])
                tvH = [torch.cat([base, t.new_zeros(1)])]
            else:
                sends = [torch.cat([t, t.new_zeros(1)])[s.sendidx_tv] for t, s in zip(tv, sh)]
                tvH = [torch.cat([x.reshape(-1), x.new_zeros(1)]) for x in mesh.all_to_all(sends)]
            rowtv = [h[s.rowmap] for h, s in zip(tvH, sh)]
        rt_ell = [torch.cat([rt, rt.new_zeros(1)])[s.ellrow_row] for rt, s in zip(rowtv, sh)]

        # --- payload halo ---------------------------------------------------
        plH = [None] * n
        if not init:
            payload = [self._payload(rt, a) for rt, a in zip(rt_ell, alive)]
            if self._al_identity:
                plH = payload
            else:
                sends = [p[s.sendidx_al] for p, s in zip(payload, sh)]
                plH = [
                    torch.cat([x.reshape(-1), x.new_zeros(1)]) for x in mesh.all_to_all(sends)
                ]

        parts = [self._chunk_partials(s, rt_ell[r], plH[r], init) for r, s in enumerate(sh)]

        # --- partials to the owners, OR-combined (counts added) --------------
        def deliver(stacks, combine):
            sends = [torch.cat([st, st.new_zeros(1, st.shape[1])])[s.sendrows]
                     for st, s in zip(stacks, sh)]
            out = []
            for s, recv in zip(sh, mesh.all_to_all(sends)):
                buf = recv.new_zeros((b + 1, recv.shape[2]))  # row b: the pads' scratch
                for src in range(n):
                    combine(buf, s.ridx[src], recv[src])
                out.append(buf[:b])
            return out

        def or_rows(buf, idx, vals):
            buf[idx] = buf[idx] | vals  # rows of one chunk are distinct; pads carry 0

        own = deliver([p[0] for p in parts], or_rows)
        if self.counting:
            own_cnt = deliver([p[1] for p in parts], lambda buf, idx, vals: buf.index_add_(0, idx, vals))
        new_tv, died = [], []
        for o in range(len(sh)):  # the local shards as owners
            if meta:
                in_map = own[o][:, self.k] != 0
                nt = tv_loc[o] & keep_mask_per_i(
                    [own[o][:, i] for i in range(self.k)], self.mand, self.opt, self.opt_min
                )
            else:
                tn = own[o][:, 0]
                in_map = tn != 0
                nt = tv_loc[o] & keep_mask_per_i([tn] * self.k, self.mand, self.opt, self.opt_min)
            if self.counting:
                keep_cnt = torch.zeros(b, dtype=torch.int32, device=sh[o].device)
                for i in range(self.k):
                    ok_i = torch.ones(b, dtype=torch.bool, device=sh[o].device)
                    for pidx, (pi, _, req) in enumerate(self._pairs):
                        if pi == i:
                            ok_i = ok_i & (own_cnt[o][:, pidx] >= req)
                    keep_cnt = keep_cnt | (ok_i.to(torch.int32) << i)
                nt = nt & keep_cnt
            if init:
                nt = torch.where(in_map, nt, 0)
                died.append((in_map & (nt == 0)).any().to(torch.int64).view(1))
            else:
                died.append(((tv_loc[o] != 0) & (nt == 0)).any().to(torch.int64).view(1))
            new_tv.append(nt)

        # --- new tv back to the chunks holding each row --------------------
        sends = [torch.cat([t, t.new_zeros(1)])[s.ridx] for t, s in zip(new_tv, sh)]
        new_alive, counters = [], []
        for r, (s, recv) in enumerate(zip(sh, mesh.all_to_all(sends))):
            row_tv = recv.new_zeros(rmax + 1)  # row rmax: the pads' scratch
            for o in range(n):
                row_tv[s.sendrows[o]] = recv[o]
            row_tv[rmax] = 0
            lv_ell = row_tv[s.ellrow_row] != 0  # live rows per ELL row
            acc_parts, msg = parts[r][2], parts[r][3]
            na_all = torch.empty(self.S, dtype=torch.bool, device=s.device)
            ae = torch.zeros(R, dtype=torch.int64, device=s.device)
            for bi, (_, w, off, nb, roff) in enumerate(self.ell_buckets):
                sl = slice(off, off + nb * w)
                rl = lv_ell[roff : roff + nb, None]
                if init:
                    na = acc_parts[bi] & rl
                else:
                    na = alive[r][sl].view(nb, w) & (acc_parts[bi] | flag[r][sl].view(nb, w)) & rl
                na_all[sl] = na.view(-1)
                nar = na.sum(dim=1)
                if R == 1:
                    ae += nar.sum()
                else:
                    ae.index_add_(0, s.rank_ell[roff : roff + nb], nar)
            new_alive.append(na_all)
            live = (new_tv[r] != 0).to(torch.int64)
            av = live.sum().view(1) if R == 1 else torch.zeros(
                R, dtype=torch.int64, device=s.device
            ).index_add_(0, s.rank_own, live)
            counters.append(torch.cat([av, ae, msg]))

        # --- exact per-rank counters and the died flag over the mesh -------
        stats = torch.cat([mesh.psum(counters)[0], mesh.pmax(died)[0]])
        return new_tv, new_alive, [torch.zeros_like(a) for a in new_alive], stats

    # -------------------------------------------------------------- public

    def per_device_elems(self) -> int:
        """Per-shard working set in array elements: the O((V + E)/n + cut)
        bound of the halo layout (a replicated plane holds O(V + E) on every
        device). Counts the state (tv, alive, tp_flag), the slot tables
        (revmap, label code, slot_to_edge), the row tables (rowmap,
        row_to_segpos, init_rowtv, ellrow_row), the label-tv block and the
        halo index lists."""
        n, b, rmax, S = self.n, self.block, self.rmax, self.S
        elems = (
            2 * b
            + 5 * S
            + 3 * rmax
            + self.n_ellrows
            + n * (self.halo_h + self.halo_hrev + 2 * self.halo_k)
        )
        if self.meta_allow is not None:
            elems += S
        if self.counting:
            elems += S
        return elems

    def init_state(self) -> ShardedState:
        return ShardedState(
            tv=[torch.zeros(self.block, dtype=torch.int32, device=s.device)
                for s in self._shards],
            alive=[torch.zeros(self.S, dtype=torch.bool, device=s.device)
                   for s in self._shards],
            tp_flag=[torch.zeros(self.S, dtype=torch.bool, device=s.device)
                     for s in self._shards],
        )

    def _slot_flags(self, edge_ids) -> list[torch.Tensor]:
        """Per local shard bool [S] slot flags set at the given edges."""
        flags = np.zeros(self.n * self.S, dtype=bool)
        if edge_ids is not None and len(edge_ids):
            flags[self._edge_to_ellslot[np.asarray(edge_ids, dtype=np.int64)]] = True
        flags = flags.reshape(self.n, self.S)
        return [
            torch.from_numpy(flags[r]).to(s.device)
            for r, s in zip(self.mesh.shard_ids, self._shards)
        ]

    def _tv_blocks(self, tv: np.ndarray) -> list[torch.Tensor]:
        tv_p = np.zeros(self.vpad, dtype=np.uint32)
        tv_p[: self.num_vertices] = tv
        tv_p = tv_p.view(np.int32)
        b = self.block
        return [
            torch.from_numpy(tv_p[r * b : (r + 1) * b].copy()).to(s.device)
            for r, s in zip(self.mesh.shard_ids, self._shards)
        ]

    def _single_controller(self, what: str) -> None:
        if self.mesh.spans_processes:
            raise NotImplementedError(
                f"{what} reads the whole state, which a mesh across processes "
                "holds in several processes: the host loop that needs it is "
                "single-controller, as in the JAX package (its multi-process "
                "run covers the data plane, init_state + lcc_call); use "
                "local_blocks for each process's shards"
            )

    def local_blocks(self, state: ShardedState) -> dict[int, tuple[np.ndarray, np.ndarray]]:
        """This process's shards of a state: global shard id -> (its owner
        block of tv, int32 [block]; its alive slots, bool [S])."""
        return {
            r: (t.cpu().numpy(), a.cpu().numpy())
            for r, t, a in zip(self.mesh.shard_ids, state.tv, state.alive)
        }

    def state_from_global(self, tv, edge_alive, tp_flag) -> ShardedState:
        """State from flat (V, E)-indexed host arrays."""
        return self.state_from_edge_ids(
            tv, np.nonzero(np.asarray(edge_alive, dtype=bool))[0],
            flag_ids=np.nonzero(np.asarray(tp_flag, dtype=bool))[0],
        )

    def state_to_global(self, state: ShardedState):
        self._single_controller("state_to_global")
        alive = np.zeros(self.graph.num_edges, dtype=bool)
        alive[self.alive_edge_ids(state)] = True
        return self.tv_host(state).copy(), alive

    def tv_host(self, state: ShardedState) -> np.ndarray:
        self._single_controller("tv_host")
        if state.tv_np is None:
            tv = torch.cat([t.cpu() for t in state.tv]).numpy().view(np.uint32)
            state.tv_np = tv[: self.num_vertices]
        return state.tv_np

    def alive_pairs(self, state: ShardedState):
        """(row, col) int64 arrays of the alive edges in CSR row-major
        order: the alive slots found on the device, their edge ids sorted
        (ascending ids are row-major order)."""
        self._single_controller("alive_pairs")
        if state.pairs_cache is not None:
            return state.pairs_cache[:2]
        dev0 = self._shards[0].device
        eids = [
            s.slot_to_edge[torch.nonzero(a).view(-1)].to(dev0)
            for s, a in zip(self._shards, state.alive)
        ]
        ids = torch.sort(torch.cat(eids)).values.cpu().numpy().astype(np.int64)
        state.pairs_cache = (
            np.asarray(self.graph.edge_row_at(ids)).astype(np.int64),
            np.asarray(self.graph.cols_at(ids)).astype(np.int64),
            ids,
        )
        return state.pairs_cache[:2]

    def alive_edge_ids(self, state: ShardedState) -> np.ndarray:
        """CSR edge ids of the alive set, in ``alive_pairs`` order."""
        self.alive_pairs(state)
        return state.pairs_cache[2]

    def state_from_edge_ids(
        self, tv: np.ndarray, edge_ids: np.ndarray, flag_ids=None,
    ) -> ShardedState:
        """State whose alive set is exactly the given edge ids, with TP
        marks on ``flag_ids``."""
        tv32 = np.asarray(tv).astype(np.uint32)
        return ShardedState(
            tv=self._tv_blocks(tv32),
            alive=self._slot_flags(edge_ids),
            tp_flag=self._slot_flags(flag_ids),
            tv_np=tv32,
        )

    def with_updates(self, state: ShardedState, tv: np.ndarray, tp_marks):
        """Replace tv and set token-passing success marks (slot flags)."""
        self._single_controller("with_updates")
        tv32 = np.asarray(tv).astype(np.uint32)
        flag = state.tp_flag
        if tp_marks:
            slots = self._edge_to_ellslot[np.asarray(list(tp_marks), dtype=np.int64)]
            flag = [f.clone() for f in flag]
            for r, s in enumerate(self._shards):
                mine = slots[slots // self.S == r] % self.S
                flag[r][torch.from_numpy(mine).to(s.device)] = True
        return ShardedState(
            tv=self._tv_blocks(tv32), alive=state.alive, tp_flag=flag,
            pairs_cache=state.pairs_cache,  # alive unchanged
            tv_np=tv32,
        )

    def lcc_call(
        self, state: ShardedState, global_init_step: bool,
        n_steps: int | None = None,
    ):
        """``n_steps`` supersteps (default: the pattern's diameter), the
        first the global init step when ``global_init_step``. Returns
        (state, rows, died), one (av, ae, msgs, per_rank) row a superstep."""
        if n_steps is None:
            n_steps = self.p.diameter
        tv, alive, flag = state.tv, state.alive, state.tp_flag
        stats = []
        for step in range(n_steps):
            tv, alive, flag, st = self._superstep(
                tv, alive, flag, init=global_init_step and step == 0
            )
            stats.append(st)
        rows, any_died = (
            stats_rows(torch.stack(stats).cpu().numpy(), self.num_ranks) if stats else ([], False)
        )
        return ShardedState(tv, alive, flag), rows, any_died
