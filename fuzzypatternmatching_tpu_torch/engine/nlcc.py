"""NLCC — non-local constraint checking as vectorized frontier supersteps.

Re-expresses the reference's asynchronous token-passing visitors
(token_passing_pattern_matching_nonunique_nem_1.hpp — path/cycle checks;
..._tds_batch_1.hpp — template-driven search with walk history) as
breadth-synchronous frontier expansion over the *pruned* adjacency (the
dense mirror of ``vertex_active_edges_map``).

Determinism: the reference forwards at most one token per (vertex, source)
per constraint run, first-arrival-wins (nem_1.hpp:131-139, 270-286). Here
the winner is defined as: earliest superstep, then smallest parent id.

Token-source batching (the ``-x`` flag / max_ranks_per_itr machinery,
tds_batch_1.hpp:1149-1303) becomes an outer loop over source chunks that
bounds peak frontier memory without changing results (TDS has no dedup, so
batches are independent; nem dedup is per-source, hence also
batch-independent).

The port's own copy of ``fuzzypatternmatching_tpu/engine/nlcc.py``; on the
same inputs it gives the same messages, winners and subgraphs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.csr import Graph
from ..pattern.nonlocal_constraint import NonLocalConstraint
from ..utils import trace


class AliveCsr:
    """Pruned adjacency: only edges whose receiver-side slot is alive and
    whose row vertex is still active. ``meta`` (optional, aligned with
    ``col``) carries per-edge metadata codes for the edge-metadata-
    constrained matching mode.

    ``from_pairs`` indexes only the rows that hold edges: ``rows`` (sorted
    distinct row ids) and ``row_ptr`` (their offsets into ``col``), built
    in O(alive pairs). The dense ``ptr`` (int64 [V + 1]) is built from
    them the first time it is read (the device engines upload it) and
    counted by the ``nlcc_dense_ptr_builds`` trace counter; the host walks
    never read it. ``AliveCsr(ptr=, col=)`` and ``build`` give the dense
    pointer itself."""

    def __init__(
        self, ptr: np.ndarray | None = None, col: np.ndarray | None = None,
        meta: np.ndarray | None = None, *, rows: np.ndarray | None = None,
        row_ptr: np.ndarray | None = None, num_vertices: int | None = None,
    ):
        self._ptr = ptr  # int64 [V+1], or None until read
        self.col = col  # int64 [A]
        self.meta = meta  # int64 [A] metadata codes | None
        self.rows = rows  # int64 [R] ascending rows with edges | None
        self.row_ptr = row_ptr  # int64 [R+1] offsets of ``rows`` in col
        self.num_vertices = len(ptr) - 1 if ptr is not None else num_vertices

    @classmethod
    def from_pairs(
        cls, arow: np.ndarray, acol: np.ndarray, live: np.ndarray,
        num_vertices: int, meta: np.ndarray | None = None,
    ) -> "AliveCsr":
        """Build from (row, col) alive-slot pairs (already row-sorted);
        ``live`` is per vertex, nonzero where the row is live (a bool mask
        or tv itself)."""
        mask = live[arow] != 0
        r, c = arow[mask].astype(np.int64), acol[mask]
        first = np.flatnonzero(np.diff(r, prepend=-1))
        return cls(
            col=c.astype(np.int64), meta=None if meta is None else meta[mask],
            rows=r[first], row_ptr=np.append(first, len(r)),
            num_vertices=num_vertices,
        )

    @classmethod
    def build(
        cls, graph: Graph, edge_alive: np.ndarray, live: np.ndarray,
        meta: np.ndarray | None = None,
    ) -> "AliveCsr":
        """Build from E-sized alive flags (the flat engine), with the
        dense pointer."""
        trace.count("nlcc_dense_ptr_builds")
        mask = edge_alive & live[graph.edge_row]
        arow = graph.edge_row[mask]
        acol = graph.cols[mask]
        counts = np.bincount(arow, minlength=graph.num_vertices)
        ptr = np.zeros(graph.num_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        return cls(
            ptr=ptr, col=acol.astype(np.int64),
            meta=None if meta is None else meta[mask],
        )

    @property
    def ptr(self) -> np.ndarray:
        """Row offsets of every vertex, int64 [V + 1]."""
        if self._ptr is None:
            trace.count("nlcc_dense_ptr_builds")
            counts = np.zeros(self.num_vertices + 1, dtype=np.int64)
            counts[self.rows + 1] = np.diff(self.row_ptr)
            self._ptr = np.cumsum(counts)
        return self._ptr

    def _extents(self, vs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(first edge position, degree) of each vs[i]."""
        if self.rows is None:
            start = self._ptr[vs]
            return start, self._ptr[vs + 1] - start
        if len(self.rows) == 0:
            none = np.zeros(len(vs), dtype=np.int64)
            return none, none
        i = np.minimum(np.searchsorted(self.rows, vs), len(self.rows) - 1)
        start = self.row_ptr[i]
        return start, np.where(self.rows[i] == vs, self.row_ptr[i + 1] - start, 0)

    def degrees(self, vs: np.ndarray) -> np.ndarray:
        """Alive degree of each vs[i] (``ptr[vs + 1] - ptr[vs]``)."""
        return self._extents(vs)[1]

    # accumulated (post-filter) frontiers beyond this size abort with
    # guidance rather than exhausting host memory; RAW expansion is never
    # materialized beyond EXPAND_CHUNK entries at a time (per-hop chunking,
    # the walk-side analog of tds_batch's source batching)
    MAX_FRONTIER = 1 << 28
    EXPAND_CHUNK = 1 << 25

    def expand(
        self, vs: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All alive neighbors of each vs[i]: returns (token_index, neighbor,
        edge_position) with one row per (i, nbr) pair; edge_position indexes
        ``col``/``meta``."""
        start, cnt = self._extents(vs)
        total = int(cnt.sum())
        rep = np.repeat(np.arange(len(vs), dtype=np.int64), cnt)
        offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        pos = start[rep] + offs
        return rep, self.col[pos], pos

    def expand_slices(self, vs: np.ndarray, chunk: int | None = None):
        """Yield (lo, hi, rep, nbr, pos) covering ``vs`` in slices whose raw
        expansion stays within ~``chunk`` entries (single rows may exceed
        it; a row is never split)."""
        if chunk is None:
            chunk = self.EXPAND_CHUNK
        cum = np.cumsum(self.degrees(vs))
        lo = 0
        while lo < len(vs):
            base = cum[lo - 1] if lo else 0
            hi = int(np.searchsorted(cum, base + chunk, side="left")) + 1
            hi = min(max(hi, lo + 1), len(vs))
            rep, nbr, pos = self.expand(vs[lo:hi])
            yield lo, hi, rep, nbr, pos
            lo = hi


@dataclass
class ForwardedSets:
    """Persistent (vertex, source) forwarded-token keys — the dense mirror
    of vertex_token_source_set, shared across constraint runs for the
    selected-vertices work aggregation (beta.cpp:791-852)."""

    keys: np.ndarray  # sorted v*V + src

    @classmethod
    def empty(cls) -> "ForwardedSets":
        return cls(keys=np.empty(0, dtype=np.int64))

    def reset_for(
        self,
        c: NonLocalConstraint,
        labels: np.ndarray,
        tv: np.ndarray,
        num_vertices: int,
    ) -> None:
        if not c.selected_vertices:
            self.keys = np.empty(0, dtype=np.int64)
            return
        v_of = self.keys // np.int64(num_vertices)
        keep = (tv[v_of] != 0) & (labels[v_of] == c.labels[-1])
        self.keys = self.keys[keep]

    def contains(self, keys: np.ndarray) -> np.ndarray:
        if len(self.keys) == 0:
            return np.zeros(len(keys), dtype=bool)
        pos = np.searchsorted(self.keys, keys)
        pos_c = np.minimum(pos, len(self.keys) - 1)
        return self.keys[pos_c] == keys

    def add(self, keys: np.ndarray) -> None:
        self.keys = np.union1d(self.keys, keys)


@dataclass
class NlccOutcome:
    sources: np.ndarray  # all token sources (the token_source_map keys)
    validated: np.ndarray  # bool per source
    messages: int
    edge_marks: list  # (v, parent) pairs to flag (cycle success marks)
    subgraphs: np.ndarray | None = None  # [N, walk_len+1] enumerated matches
    msg_per_rank: np.ndarray | None = None  # arrival counts by receiver owner


def token_sources(
    c: NonLocalConstraint,
    labels: np.ndarray,
    tv: np.ndarray,
    candidates: np.ndarray | None = None,
    *,
    active: np.ndarray | None = None,
) -> np.ndarray:
    """Qualifying token sources (nem_1.hpp:387-479; tds_batch_1.hpp:1067-1135).

    Path-check (non-TDS) sources must hold both endpoint template bits.
    ``candidates`` (sorted ids with labels == c.labels[0], precomputed
    once per constraint — labels never change) skips the V-sized label
    scan this otherwise repeats on every call. ``active`` (sorted ids that
    include every vertex with tv != 0; tv only loses bits while it is
    held) narrows the scan to those vertices; with ``candidates`` too, the
    sources are those of both."""
    if active is not None:
        tva = tv[active]
        m = (labels[active] == c.labels[0]) & ((tva >> int(c.indices[0])) & 1).astype(bool)
        if not c.is_tds and not c.valid_cycle and not c.selected_vertices:
            m &= ((tva >> int(c.indices[-1])) & 1).astype(bool)
        src = active[m].astype(np.int64)
        if candidates is not None:
            src = src[_in_sorted_np(candidates, src)]
        return src
    if candidates is not None:
        tvc = tv[candidates]
        m = ((tvc >> int(c.indices[0])) & 1).astype(bool)
        if not c.is_tds and not c.valid_cycle and not c.selected_vertices:
            m &= ((tvc >> int(c.indices[-1])) & 1).astype(bool)
        return candidates[m].astype(np.int64)
    mask = (labels == c.labels[0]) & ((tv >> int(c.indices[0])) & 1).astype(bool)
    if not c.is_tds and not c.valid_cycle and not c.selected_vertices:
        mask &= ((tv >> int(c.indices[-1])) & 1).astype(bool)
    return np.nonzero(mask)[0].astype(np.int64)


def map_keys_of(
    c: NonLocalConstraint, labels: np.ndarray, tv: np.ndarray,
    active: np.ndarray | None = None,
) -> np.ndarray:
    """The selected-vertices token_source_map keys: active vertices with
    the constraint's final label (nem_1.hpp:414-432, 694-716); over
    ``active`` (as in ``token_sources``) when given."""
    if active is None:
        return np.nonzero((tv != 0) & (labels == c.labels[-1]))[0].astype(np.int64)
    return active[(tv[active] != 0) & (labels[active] == c.labels[-1])].astype(np.int64)


def _in_sorted_np(sorted_arr: np.ndarray, q: np.ndarray) -> np.ndarray:
    if len(sorted_arr) == 0:
        return np.zeros(len(q), dtype=bool)
    pos = np.minimum(np.searchsorted(sorted_arr, q), len(sorted_arr) - 1)
    return sorted_arr[pos] == q


def _arrival_ok(
    cur: np.ndarray, labels: np.ndarray, tv: np.ndarray, c, h: int
) -> np.ndarray:
    return (labels[cur] == c.labels[h]) & (
        (tv[cur] >> int(c.indices[h])) & 1
    ).astype(bool)


def _expand_nem_hop(
    acsr: AliveCsr,
    v_sel: np.ndarray,
    s_sel: np.ndarray,
    p_sel: np.ndarray,
    labels: np.ndarray,
    tv: np.ndarray,
    c: NonLocalConstraint,
    h_next: int,
    num_ranks: int,
    drop_parent_return: bool,
    hopc: np.ndarray | None = None,
):
    """One hop of token fan-out in bounded slices: every arrival is counted
    (message accounting lives here), then only tokens passing the
    hop-``h_next`` label/bit arrival check — and, in metadata mode, whose
    traversed edge carries the hop's required metadata code (``hopc``) —
    are kept. The raw expansion is never materialized at once (per-hop
    chunking; the MemoryError abort of round 1 is gone)."""
    messages = 0
    msg_r = np.zeros(num_ranks, dtype=np.int64)
    cur_p, src_p, par_p = [], [], []
    kept = 0
    for lo, hi, rep, nbr, pos in acsr.expand_slices(v_sel):
        if drop_parent_return:
            keep = nbr != p_sel[lo:hi][rep]
            nbr, rep, pos = nbr[keep], rep[keep], pos[keep]
        messages += len(nbr)
        if len(nbr):
            msg_r += np.bincount(nbr % num_ranks, minlength=num_ranks)
        ok = _arrival_ok(nbr, labels, tv, c, h_next)
        if hopc is not None:
            ok &= acsr.meta[pos] == hopc[h_next - 1]
        kept += int(ok.sum())
        if kept > AliveCsr.MAX_FRONTIER:
            raise MemoryError(
                f"surviving token frontier exceeds {AliveCsr.MAX_FRONTIER} "
                "entries even after per-hop arrival filtering; tighten the "
                "pattern's local constraints"
            )
        cur_p.append(nbr[ok])
        src_p.append(s_sel[lo:hi][rep][ok])
        par_p.append(v_sel[lo:hi][rep][ok])
    e = np.empty(0, dtype=np.int64)
    cur = np.concatenate(cur_p) if cur_p else e
    src = np.concatenate(src_p) if src_p else e
    parent = np.concatenate(par_p) if par_p else e
    return cur, src, parent, messages, msg_r


def run_nem(
    acsr: AliveCsr,
    labels: np.ndarray,
    tv: np.ndarray,
    c: NonLocalConstraint,
    num_vertices: int,
    batch_size: int = 1 << 22,
    num_ranks: int = 1,
    forwarded: ForwardedSets | None = None,
    hopc: np.ndarray | None = None,
    candidates: np.ndarray | None = None,
    *,
    active: np.ndarray | None = None,
) -> NlccOutcome:
    """nem-style walk constraint: one pass of
    token_passing_pattern_matching (nem_1.hpp:913-939). ``forwarded`` is the
    persistent per-(vertex, source) dedup/aggregation set; pass the same
    object across constraints after calling ``reset_for``. ``hopc``
    (metadata mode) gives the per-hop required edge-metadata code;
    ``candidates`` and ``active`` bound the source scan
    (``token_sources``)."""
    if forwarded is None:
        forwarded = ForwardedSets.empty()
    sources = token_sources(c, labels, tv, candidates, active=active)
    if c.selected_vertices:
        # destinations (active final-label vertices) are the validated
        # entities in aggregation mode
        map_keys = map_keys_of(c, labels, tv, active)
    else:
        map_keys = sources
    validated = np.zeros(len(map_keys), dtype=bool)
    src_pos = {int(s): i for i, s in enumerate(map_keys)}
    maxi = c.cycle_length
    vv = np.int64(num_vertices)
    messages = 0
    msg_r = np.zeros(num_ranks, dtype=np.int64)
    edge_marks: list = []

    for lo in range(0, max(len(sources), 1), batch_size):
        batch = sources[lo : lo + batch_size]
        if len(batch) == 0:
            continue
        cur, src, parent, m, mr = _expand_nem_hop(
            acsr, batch, batch, batch, labels, tv, c, 1, num_ranks, False,
            hopc=hopc,
        )
        messages += m
        msg_r += mr
        for h in range(1, maxi + 2):
            if len(cur) == 0:
                break
            # label/bit arrival checks for hop h were applied at expansion
            if h == maxi + 1:
                if not c.valid_cycle:
                    acc = cur != src
                    if c.selected_vertices:
                        # validate destinations that forwarded this source
                        acc &= forwarded.contains(cur * vv + src)
                        for d in np.unique(cur[acc]):
                            if int(d) in src_pos:
                                validated[src_pos[int(d)]] = True
                        break
                else:
                    # a cycle source missing from the map is dropped, like
                    # the reference's error path (nem_1.hpp:750-755) —
                    # reachable only via a malformed selected+cycle combo
                    acc = (cur == src) & _in_sorted_np(map_keys, src)
                    for v, p in zip(cur[acc], parent[acc]):
                        edge_marks.append((int(v), int(p)))
                for s in np.unique(src[acc]):
                    validated[src_pos[int(s)]] = True
                break
            ok = cur != src  # the target cannot relay (nem_1.hpp:173-177)
            keys = cur * vv + src
            ok &= ~forwarded.contains(keys)
            k_ok, p_ok = keys[ok], parent[ok]
            cur_ok, src_ok = cur[ok], src[ok]
            # winner per (v, src): smallest parent id
            order = np.lexsort((p_ok, k_ok))
            k_sorted = k_ok[order]
            first = np.ones(len(order), dtype=bool)
            first[1:] = k_sorted[1:] != k_sorted[:-1]
            sel = order[first]
            forwarded.add(k_sorted[first])
            v_sel, s_sel, p_sel = cur_ok[sel], src_ok[sel], p_ok[sel]
            cur, src, parent, m, mr = _expand_nem_hop(
                acsr, v_sel, s_sel, p_sel, labels, tv, c, h + 1, num_ranks,
                True, hopc=hopc,
            )
            messages += m
            msg_r += mr
    return NlccOutcome(map_keys if c.selected_vertices else sources, validated, messages, edge_marks, None, msg_r)


def tds_start_pairs(
    c: NonLocalConstraint,
    sources: np.ndarray,
    forwarded: ForwardedSets | None,
    num_vertices: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(start, expected-target) pairs. Normally target == start; in
    selected-vertices mode each source emits one token per remembered
    original source (tds_batch_1.hpp:439-441, 494-500)."""
    if not c.selected_vertices:
        return sources, sources
    if forwarded is None or len(forwarded.keys) == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e
    v_of = forwarded.keys // np.int64(num_vertices)
    t_of = forwarded.keys % np.int64(num_vertices)
    keep = np.isin(v_of, sources)
    return v_of[keep], t_of[keep]


def run_tds(
    acsr: AliveCsr,
    labels: np.ndarray,
    tv: np.ndarray,
    c: NonLocalConstraint,
    num_vertices: int,
    source_batch: int = 1 << 16,
    collect_subgraphs: bool = True,
    num_ranks: int = 1,
    forwarded: ForwardedSets | None = None,
    hopc: np.ndarray | None = None,
    candidates: np.ndarray | None = None,
    *,
    active: np.ndarray | None = None,
) -> NlccOutcome:
    """TDS enumeration walk with full history
    (tds_batch_1.hpp:560-930, 1149-1303). ``hopc`` (metadata mode) gives
    the per-hop required edge-metadata code; ``candidates`` and ``active``
    bound the source scan (``token_sources``)."""
    sources = token_sources(c, labels, tv, candidates, active=active)
    validated = np.zeros(len(sources), dtype=bool)
    src_pos = {int(s): i for i, s in enumerate(sources)}
    starts, targets = tds_start_pairs(c, sources, forwarded, num_vertices)
    maxi = c.cycle_length
    enum = c.enumeration
    messages = 0
    msg_r = np.zeros(num_ranks, dtype=np.int64)
    sub_parts: list[np.ndarray] = []

    def expand_hop(cur, tgt, visited, h):
        """Walk fan-out for hop h+1 in bounded slices: apply the sender-side
        keep rules (penultimate-hop target rules + enumeration lookahead),
        count the surviving arrivals, then keep only tokens passing the
        hop-(h+1) arrival check — the raw expansion and the [N, W] history
        matrix are never materialized at once."""
        nonlocal messages, msg_r
        cur_p, tgt_p, vis_p = [], [], []
        kept = 0
        for lo, hi, rep, nbr, pos in acsr.expand_slices(cur):
            tgt_r, vis_r = tgt[lo:hi][rep], visited[lo:hi][rep]
            if h == maxi:
                # penultimate hop (tds_batch_1.hpp:806-846)
                if c.valid_cycle:
                    keep = nbr == tgt_r  # cycle closes on the target; no enum
                else:
                    keep = nbr != tgt_r
            else:
                keep = np.ones(len(nbr), dtype=bool)
            if not (h == maxi and c.valid_cycle):
                k2 = int(enum[h + 1])
                if k2 == h + 1:
                    keep &= ~np.any(vis_r == nbr[:, None], axis=1)
                elif k2 < h + 1:
                    keep &= vis_r[:, k2] == nbr
                else:
                    keep &= False
            nbr, tgt_r, vis_r, pos = nbr[keep], tgt_r[keep], vis_r[keep], pos[keep]
            messages += len(nbr)
            if len(nbr):
                msg_r += np.bincount(nbr % num_ranks, minlength=num_ranks)
            ok = _arrival_ok(nbr, labels, tv, c, h + 1)
            if hopc is not None:
                ok &= acsr.meta[pos] == hopc[h]
            kept += int(ok.sum())
            if kept > AliveCsr.MAX_FRONTIER:
                raise MemoryError(
                    "surviving TDS walk frontier exceeds "
                    f"{AliveCsr.MAX_FRONTIER} entries even after per-hop "
                    "filtering; reduce the token-source batch (-x) or "
                    "tighten the pattern"
                )
            cur_p.append(nbr[ok])
            tgt_p.append(tgt_r[ok])
            vis_p.append(vis_r[ok])
        e = np.empty(0, dtype=np.int64)
        w = visited.shape[1]
        return (
            np.concatenate(cur_p) if cur_p else e,
            np.concatenate(tgt_p) if tgt_p else e,
            np.concatenate(vis_p) if vis_p else np.empty((0, w), np.int64),
        )

    for lo in range(0, max(len(starts), 1), source_batch):
        batch = starts[lo : lo + source_batch]
        btgt = targets[lo : lo + source_batch]
        if len(batch) == 0:
            continue
        # initial fan-out (position-0 send) — counted and arrival-filtered
        # for hop 1, like every later hop
        cur_p, tgt_p, vis_p = [], [], []
        for slo, shi, rep, nbr, pos in acsr.expand_slices(batch):
            messages += len(nbr)
            if len(nbr):
                msg_r += np.bincount(nbr % num_ranks, minlength=num_ranks)
            ok = _arrival_ok(nbr, labels, tv, c, 1)
            if hopc is not None:
                ok &= acsr.meta[pos] == hopc[0]
            cur_p.append(nbr[ok])
            tgt_p.append(btgt[slo:shi][rep][ok])
            vis_p.append(batch[slo:shi][rep][ok][:, None])
        e = np.empty(0, dtype=np.int64)
        cur = np.concatenate(cur_p) if cur_p else e
        tgt = np.concatenate(tgt_p) if tgt_p else e
        visited = (
            np.concatenate(vis_p) if vis_p else np.empty((0, 1), np.int64)
        )
        for h in range(1, maxi + 2):
            if len(cur) == 0:
                break
            # label/bit arrival checks for hop h were applied at expansion
            if h == maxi + 1:
                if not c.valid_cycle:
                    acc = cur != tgt
                    emit = acc  # path writes before the ack (…hpp:684-696)
                else:
                    acc = (cur == tgt) & (visited[:, 0] == cur)
                    # cycle writes only after the map lookup succeeds
                    emit = acc & np.isin(tgt, sources)
                for s in np.unique(tgt[acc]):
                    if int(s) in src_pos:
                        validated[src_pos[int(s)]] = True
                if collect_subgraphs and np.any(emit):
                    sub_parts.append(
                        np.hstack(
                            [visited[emit], cur[emit, None], cur[emit, None]]
                        )
                    )
                break
            # receiver-side enumeration rule for position h
            # (tds_batch_1.hpp:620-639)
            k = int(enum[h])
            ok = np.ones(len(cur), dtype=bool)
            if k == h:
                ok &= ~np.any(visited == cur[:, None], axis=1)
            elif k < h:
                ok &= visited[:, k] == cur
            else:
                ok &= False
            cur, tgt, visited = cur[ok], tgt[ok], visited[ok]
            visited = np.hstack([visited, cur[:, None]])
            cur, tgt, visited = expand_hop(cur, tgt, visited, h)

    subgraphs = (
        np.vstack(sub_parts)
        if sub_parts
        else np.empty((0, maxi + 3), dtype=np.int64)
    )
    return NlccOutcome(sources, validated, messages, [], subgraphs, msg_r)


def invalidate_sources(
    tv: np.ndarray, c: NonLocalConstraint, outcome: NlccOutcome
) -> bool:
    """Reset the source template-vertex bit of failed sources, in place
    (run_pattern_matching_beta.cpp:964-1016). Returns token_source_deleted."""
    failed = outcome.sources[~outcome.validated]
    failed = failed[tv[failed] != 0]
    if len(failed) == 0:
        return False
    bit = int(c.indices[-1] if c.selected_vertices else c.indices[0])
    tv[failed] &= np.uint32(~np.uint32(1 << bit))
    return True
