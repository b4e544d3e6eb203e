"""Mesh NLCC: the token walks over the shards of a mesh.

The port of ``fuzzypatternmatching_tpu/parallel/nlcc_sharded.py`` (the
reference's nem_1.hpp / tds_batch_1.hpp token passing through its MPI
mailbox). One constraint runs hop by hop on every shard:

* vertices and their rows of the pruned (alive) CSR are block-partitioned
  over the shards, owner = v // block, the layout of the mesh LCC engine;
* each hop expands the tokens of a shard over its local rows and routes
  every new token to the owner of its arrival vertex (``_route``, a ragged
  exchange on the mesh);
* the per-(vertex, source) forwarded-token dedup (nem_1.hpp:131-139,
  270-286) is local to the owner by construction, since every arrival of a
  key lands on its vertex's owner in the same hop, with the single-device
  rule: the earliest superstep, then the smallest parent;
* message counts are summed over the shards.

Frontiers are sized exactly, from host reads of the totals (as in
``engine/nlcc_device.py``): there is no capacity, no doubling and no
overflow, so the driver's ``nlcc_fallbacks`` stays 0.

The walk kernels of ``ops/nlcc_frontier.py`` run where their operands fit
a shard: ``expand_frontier`` over the shard's local ``ptr`` (row index =
vertex - block start) and its ``col`` of global ids, with the return to
the parent dropped at the sender; ``forward_winners`` on the owner after
routing, against the keys it forwarded before. The hop's arrival test
reads ``ok_bits`` of the arrival vertex, which only its owner holds, so it
is applied after routing, in plain torch (``expand_frontier`` runs
unfiltered, ``h_next = -1``), and so are TDS's walk-history rules, as in
``DeviceNlcc``. With metadata hop filters (``hopc``) each token carries
the code of the edge it traversed, found by a search of the shard's sorted
(row, col) edge keys.

Results equal the host engine (``engine/nlcc.py``) and the JAX package's
``ShardedNlcc``: the same NlccOutcome, counts, winners and subgraphs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.nlcc import (
    AliveCsr,
    ForwardedSets,
    NlccOutcome,
    map_keys_of,
    tds_start_pairs,
    token_sources,
)
from ..ops import nlcc_frontier as nf
from ..pattern.nonlocal_constraint import NonLocalConstraint
from .mesh import Mesh


class _ShardCsr:
    """One shard's rows of the alive CSR, on its device."""

    def __init__(self, ptr, col, meta, ekey):
        self.ptr = ptr  # int64 [block + 1], local row offsets
        self.col = col  # int32 [A_r], global neighbour ids
        self.meta = meta  # int64 [A_r] metadata codes, or None
        self.ekey = ekey  # int64 [A_r] row * V + col, ascending, or None


class ShardedNlcc:
    """``run_nem`` / ``run_tds`` of ``engine/nlcc.py`` over a mesh (the API
    of ``DeviceNlcc``, plus ``source_batch``)."""

    def __init__(self, num_vertices: int, mesh: Mesh, num_ranks: int = 1):
        if num_vertices >= (1 << 31):
            raise ValueError("device NLCC dedup keys require V < 2^31")
        if mesh.spans_processes:
            raise NotImplementedError(
                "the mesh NLCC runs in the single-controller host loop "
                "(MatchEngine), on a mesh held by one process"
            )
        self.V = num_vertices
        self.R = num_ranks
        self.mesh = mesh
        self.n = n = mesh.n
        self.block = -(-num_vertices // n)

    # -- the alive CSR on the shards (cached per AliveCsr instance) ---------

    def prepare(self, acsr: AliveCsr) -> list[_ShardCsr]:
        cached = getattr(acsr, "_shard_cache", None)
        if cached is not None and cached[0] is self:
            return cached[1]
        b, v = self.block, self.V
        out = []
        for r, dev in enumerate(self.mesh.devices):
            vlo, vhi = min(r * b, v), min((r + 1) * b, v)
            lo, hi = int(acsr.ptr[vlo]), int(acsr.ptr[vhi])
            ptr = np.empty(b + 1, dtype=np.int64)
            ptr[: vhi - vlo + 1] = acsr.ptr[vlo : vhi + 1] - lo
            ptr[vhi - vlo + 1 :] = ptr[vhi - vlo]
            col = np.asarray(acsr.col[lo:hi])
            meta = ekey = None
            if acsr.meta is not None:
                rows = np.repeat(np.arange(vlo, vhi, dtype=np.int64), np.diff(acsr.ptr[vlo : vhi + 1]))
                ekey = rows * v + col
                if np.any(ekey[1:] <= ekey[:-1]):
                    raise ValueError("ShardedNlcc: AliveCsr rows are not sorted by column")
                meta = torch.from_numpy(np.asarray(acsr.meta[lo:hi], dtype=np.int64)).to(dev)
                ekey = torch.from_numpy(ekey).to(dev)
            out.append(_ShardCsr(
                torch.from_numpy(ptr).to(dev),
                torch.from_numpy(col.astype(np.int32)).to(dev),
                meta, ekey,
            ))
        acsr._shard_cache = (self, out)
        return out

    # -- host-side helpers ---------------------------------------------------

    def _ok_bits(self, labels, tv, c: NonLocalConstraint, map_keys=None) -> list[torch.Tensor]:
        """Per-shard int32 [block] words (the JAX package's uint32): bit h
        set iff the vertex passes the hop-h arrival check; bit 31 iff it is
        a token_source_map key (cycle tokens whose source is missing from
        the map are dropped, nem_1.hpp:750-755)."""
        if c.cycle_length + 1 > nf.MAX_HOP_BIT:
            raise ValueError(
                f"walks of more than {nf.MAX_HOP_BIT} hops do not fit the arrival bits"
            )
        bits = np.zeros(self.n * self.block, dtype=np.uint32)
        for h in range(0, c.cycle_length + 2):
            ok = (labels == c.labels[h]) & (((tv >> int(c.indices[h])) & 1) != 0)
            bits[: self.V] |= ok.astype(np.uint32) << np.uint32(h)
        if map_keys is not None:
            bits[map_keys] |= np.uint32(1) << np.uint32(31)
        bits = bits.view(np.int32).reshape(self.n, self.block)
        return [torch.from_numpy(bits[r].copy()).to(d) for r, d in enumerate(self.mesh.devices)]

    def _partition(self, vals: np.ndarray, *extra: np.ndarray) -> list[list[torch.Tensor]]:
        """Split vertex-id arrays (``vals`` ascending; ``extra`` aligned
        with it) by owner: per shard [vals_r, *extra_r] as int32 tensors."""
        bounds = np.searchsorted(vals, np.arange(self.n + 1) * self.block)
        return [
            [torch.from_numpy(np.ascontiguousarray(a[bounds[r] : bounds[r + 1]], dtype=np.int32)).to(d)
             for a in (vals, *extra)]
            for r, d in enumerate(self.mesh.devices)
        ]

    def _partition_keys(self, keys: np.ndarray) -> list[torch.Tensor]:
        """Owner-partition sorted dedup keys (key // V is the vertex)."""
        owners = keys // np.int64(self.V) // self.block
        bounds = np.searchsorted(owners, np.arange(self.n + 1))
        return [
            torch.from_numpy(np.ascontiguousarray(keys[bounds[r] : bounds[r + 1]], dtype=np.int64)).to(d)
            for r, d in enumerate(self.mesh.devices)
        ]

    def _first_expansion(self, acsr: AliveCsr, sources: np.ndarray) -> int:
        """The largest first-hop fan-out of one shard (what "auto"
        placement weighs)."""
        if len(sources) == 0:
            return 0
        deg = acsr.degrees(sources)
        per_dev = np.bincount(sources // self.block, weights=deg, minlength=self.n)
        return int(per_dev.max())

    # -- the walk's building blocks ------------------------------------------

    def _route(self, dests: list, fields: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        """Deliver every token to shard ``dests[s]`` (int64 [L_s] on shard
        s): ``fields[s]`` are [L_s] or [L_s, W] tensors riding with the
        tokens. Shard d receives its tokens in (source shard, lane) order."""
        n = self.n
        sends = []  # per source shard, per field: n per-destination slices
        for dest, fs in zip(dests, fields):
            order = torch.sort(dest, stable=True).indices
            counts = torch.bincount(dest, minlength=n).cpu().tolist()
            sends.append([torch.split(f[order], counts) for f in fs])
        return [
            list(per_field)
            for per_field in zip(*[
                self.mesh.all_to_all_ragged([sends[s][i] for s in range(n)])
                for i in range(len(fields[0]))
            ])
        ]

    def _expand(self, sh: _ShardCsr, cur: torch.Tensor, parent: torch.Tensor,
                ok: torch.Tensor, vlo: int, drop_parent: bool):
        """Every alive neighbour of the tokens at ``cur`` (global ids, on
        this shard), less the lane back to ``parent`` where asked: (token
        index int64, neighbour int32)."""
        ex = nf.expand_frontier(
            sh.ptr, sh.col, (cur - vlo).to(torch.int32), parent, ok, -1, self.R, drop_parent
        )
        return ex.tok.long(), ex.nbr

    def _edge_meta(self, sh: _ShardCsr, row: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        """Metadata code of the traversed edges (row -> nbr) of this shard."""
        return sh.meta[torch.searchsorted(sh.ekey, row.long() * self.V + nbr.long())]

    def _count(self, cur: list[torch.Tensor]) -> np.ndarray:
        """Messages per output rank (``v % R``) of the arrived tokens."""
        per = [
            torch.bincount((c % self.R).long(), minlength=self.R) for c in cur
        ]
        return self.mesh.psum(per)[0].cpu().numpy()

    def _ack(self, validated: list, vals: list[torch.Tensor]) -> None:
        """Route validation acks to each vertex's owner and set them."""
        b = self.block
        recv = self._route([(v // b).long() for v in vals], [[v] for v in vals])
        for r, (got,) in enumerate(recv):
            validated[r][(got - r * b).long()] = True

    # -- public API (mirrors DeviceNlcc) -------------------------------------

    def run_nem(
        self,
        acsr: AliveCsr,
        labels: np.ndarray,
        tv: np.ndarray,
        c: NonLocalConstraint,
        num_vertices: int,
        forwarded: ForwardedSets | None = None,
        hopc: np.ndarray | None = None,
        candidates: np.ndarray | None = None,
        source_batch: int | None = None,
        *,
        active: np.ndarray | None = None,
    ) -> NlccOutcome:
        assert num_vertices == self.V
        if forwarded is None:
            forwarded = ForwardedSets.empty()
        sources = token_sources(c, labels, tv, candidates, active=active)
        if c.selected_vertices:
            map_keys = map_keys_of(c, labels, tv, active)
        else:
            map_keys = sources
        shards = self.prepare(acsr)
        if hopc is not None and acsr.meta is None:
            raise ValueError("hopc given but the AliveCsr carries no meta")
        # dedup keys are per (vertex, SOURCE): source batches are independent
        # (the -x machinery, tds_batch_1.hpp:1149-1303)
        sb = source_batch or max(len(sources), 1)
        fwd = self._partition_keys(forwarded.keys)
        ok_bits = self._ok_bits(labels, tv, c, map_keys)
        validated = [torch.zeros(self.block, dtype=torch.bool, device=d) for d in self.mesh.devices]
        edge_marks: list = []
        msg_r = np.zeros(self.R, dtype=np.int64)
        new_keys: list[torch.Tensor] = []
        for lo in range(0, len(sources), sb):
            batch = sources[lo : lo + sb]
            marks, m = self._nem_batch(shards, ok_bits, batch, fwd, validated, c, hopc, new_keys)
            edge_marks += marks
            msg_r += m
        if new_keys:
            # ForwardedSets.add's sorted union, taken on the device: the keys
            # forwarded before and this run's winners are all distinct
            dev0 = self.mesh.devices[0]
            keys = torch.cat([torch.from_numpy(forwarded.keys).to(dev0)]
                             + [k.to(dev0) for k in new_keys])
            forwarded.keys = torch.sort(keys).values.cpu().numpy()
        validated_v = torch.cat([x.cpu() for x in validated]).numpy()[: self.V]
        return NlccOutcome(
            map_keys,
            validated_v[map_keys] if len(map_keys) else np.zeros(0, dtype=bool),
            int(msg_r.sum()),
            edge_marks,
            None,
            msg_r,
        )

    def _nem_batch(self, shards, ok_bits, batch, fwd, validated, c, hopc, new_keys):
        """One source batch of a nem constraint: appends the keys it
        forwards to ``new_keys``; returns (edge marks, messages per rank)."""
        V, b, n, maxi = self.V, self.block, self.n, c.cycle_length
        meta = hopc is not None
        msg = np.zeros(self.R, dtype=np.int64)
        seen = list(fwd)  # per shard: keys forwarded before, then this batch's winners
        sends, dests = [], []
        for r, (sh, (src0,)) in enumerate(zip(shards, self._partition(batch))):
            tok, nbr = self._expand(sh, src0, src0, ok_bits[r], r * b, False)
            f = [nbr, src0[tok], src0[tok]]
            if meta:
                f.append(self._edge_meta(sh, src0[tok], nbr))
            sends.append(f)
            dests.append((nbr // b).long())
        toks = self._route(dests, sends)
        edge_marks: list = []
        for h in range(1, maxi + 2):
            msg += self._count([t[0] for t in toks])
            if h == maxi + 1:
                acks = []
                for r, (cur, src, parent, *em) in enumerate(toks):
                    cur_loc = (cur - r * b).long()
                    ok = ((ok_bits[r][cur_loc] >> h) & 1) != 0
                    if meta:
                        ok &= em[0] == int(hopc[h - 1])
                    if not c.valid_cycle:
                        acc = ok & (cur != src)
                        if c.selected_vertices:
                            keys = cur.long() * V + src.long()
                            acc &= nf.in_sorted(torch.sort(seen[r]).values, keys)
                            validated[r][cur_loc[acc]] = True
                        else:
                            # validated entities are the (remote) sources:
                            # route the acks back to their owners
                            # (nem_1.hpp:720-726 ack_success visitor)
                            acks.append(src[acc])
                    else:
                        # bit 31: the source is a token_source_map key
                        acc = ok & (cur == src) & (ok_bits[r][cur_loc] < 0)
                        validated[r][cur_loc[acc]] = True
                        edge_marks += list(zip(cur[acc].tolist(), parent[acc].tolist()))
                if acks:
                    self._ack(validated, acks)
                break
            sends, dests = [], []
            for r, (sh, (cur, src, parent, *em)) in enumerate(zip(shards, toks)):
                cur_loc = (cur - r * b).long()
                ok = ((ok_bits[r][cur_loc] >> h) & 1) != 0
                if meta:
                    ok &= em[0] == int(hopc[h - 1])
                ok &= cur != src  # the target cannot relay (nem_1.hpp:173-177)
                cur, src, parent = cur[ok], src[ok], parent[ok]
                keys = cur.long() * V + src.long()
                win = nf.forward_winners(keys, parent, seen[r])
                cur, src, keys = cur[win], src[win], keys[win]
                seen[r] = torch.cat([seen[r], keys])
                new_keys.append(keys)
                # no return to the vertex the winner received the token from
                tok, nbr = self._expand(sh, cur, parent[win], ok_bits[r], r * b, True)
                f = [nbr, src[tok], cur[tok]]
                if meta:
                    f.append(self._edge_meta(sh, cur[tok], nbr))
                sends.append(f)
                dests.append((nbr // b).long())
            toks = self._route(dests, sends)
        return edge_marks, msg

    def run_tds(
        self,
        acsr: AliveCsr,
        labels: np.ndarray,
        tv: np.ndarray,
        c: NonLocalConstraint,
        num_vertices: int,
        collect_subgraphs: bool = True,
        forwarded: ForwardedSets | None = None,
        hopc: np.ndarray | None = None,
        candidates: np.ndarray | None = None,
        source_batch: int | None = None,
        *,
        active: np.ndarray | None = None,
    ) -> NlccOutcome:
        assert num_vertices == self.V
        sources = token_sources(c, labels, tv, candidates, active=active)
        starts, targets = tds_start_pairs(c, sources, forwarded, self.V)
        order = np.argsort(starts, kind="stable")
        starts, targets = starts[order], targets[order]
        shards = self.prepare(acsr)
        if hopc is not None and acsr.meta is None:
            raise ValueError("hopc given but the AliveCsr carries no meta")
        ok_bits = self._ok_bits(labels, tv, c)
        # TDS has no cross-source dedup: batches of the start set are
        # independent (tds_batch_1.hpp:1149-1303)
        sb = source_batch or max(len(starts), 1)
        validated = [torch.zeros(self.block, dtype=torch.bool, device=d) for d in self.mesh.devices]
        msg_r = np.zeros(self.R, dtype=np.int64)
        sub_parts: list[np.ndarray] = []
        for lo in range(0, len(starts), sb):
            m, subs = self._tds_batch(
                shards, ok_bits, starts[lo : lo + sb], targets[lo : lo + sb],
                validated, c, hopc, collect_subgraphs,
            )
            msg_r += m
            sub_parts += subs
        subgraphs = (
            np.vstack(sub_parts) if sub_parts
            else np.empty((0, c.cycle_length + 3), dtype=np.int64)
        )
        validated_v = torch.cat([x.cpu() for x in validated]).numpy()[: self.V]
        return NlccOutcome(
            sources,
            validated_v[sources] if len(sources) else np.zeros(0, dtype=bool),
            int(msg_r.sum()),
            [],
            subgraphs,
            msg_r,
        )

    def _tds_batch(self, shards, ok_bits, starts, targets, validated, c, hopc, collect):
        """One start batch of a TDS constraint. Returns (messages per rank,
        subgraph row blocks)."""
        b, maxi = self.block, c.cycle_length
        W = maxi + 1  # walk history columns 0..maxi
        enum = c.enumeration
        meta = hopc is not None
        msg = np.zeros(self.R, dtype=np.int64)
        sends, dests = [], []
        for r, (sh, (st, tg)) in enumerate(zip(shards, self._partition(starts, targets))):
            tok, nbr = self._expand(sh, st, st, ok_bits[r], r * b, False)
            visited = torch.zeros((nbr.shape[0], W), dtype=torch.int32, device=nbr.device)
            visited[:, 0] = st[tok]
            f = [nbr, tg[tok], visited]
            if meta:
                f.append(self._edge_meta(sh, st[tok], nbr))
            sends.append(f)
            dests.append((nbr // b).long())
        toks = self._route(dests, sends)
        subs: list[np.ndarray] = []
        for h in range(1, maxi + 2):
            msg += self._count([t[0] for t in toks])
            oks = []
            for r, (cur, tgt, visited, *em) in enumerate(toks):
                ok = ((ok_bits[r][(cur - r * b).long()] >> h) & 1) != 0
                if meta:
                    ok &= em[0] == int(hopc[h - 1])
                oks.append(ok)
            if h == maxi + 1:
                acks = []
                for r, ((cur, tgt, visited, *_), ok) in enumerate(zip(toks, oks)):
                    if not c.valid_cycle:
                        acc = ok & (cur != tgt)
                        emit = acc  # path writes before the ack
                        acks.append(tgt[acc])
                    else:
                        acc = ok & (cur == tgt) & (visited[:, 0] == cur)
                        t_loc = (tgt[acc] - r * b).long()  # tgt == cur: this shard's
                        validated[r][t_loc] = True
                        # cycle writes only when the target is in the map
                        emit = acc.clone()
                        emit[acc] = (ok_bits[r][t_loc] & 1) != 0
                    if collect and bool(emit.any()):
                        last = cur[emit, None]
                        subs.append(torch.cat([visited[emit], last, last], 1).cpu().numpy().astype(np.int64))
                if acks:
                    self._ack(validated, acks)
                break
            sends, dests = [], []
            for r, (sh, (cur, tgt, visited, *_), ok) in enumerate(zip(shards, toks, oks)):
                # receiver-side enumeration rule (tds_batch_1.hpp:620-639)
                k = int(enum[h])
                if k == h:
                    ok &= ~(visited[:, :h] == cur[:, None]).any(1)
                elif k < h:
                    ok &= visited[:, k] == cur
                else:
                    ok &= False
                cur, tgt, visited = cur[ok], tgt[ok], visited[ok]
                visited[:, h] = cur
                tok, nbr = self._expand(sh, cur, cur, ok_bits[r], r * b, False)
                tgt2, vis2 = tgt[tok], visited[tok]
                if h == maxi and c.valid_cycle:
                    keep = nbr == tgt2  # the cycle must close on the target
                else:
                    # penultimate hop of a path (tds_batch_1.hpp:806-846)
                    keep = nbr != tgt2 if h == maxi else torch.ones_like(nbr, dtype=torch.bool)
                    k2 = int(enum[h + 1])
                    if k2 == h + 1:
                        keep &= ~(vis2[:, : h + 1] == nbr[:, None]).any(1)
                    elif k2 < h + 1:
                        keep &= vis2[:, k2] == nbr
                    else:
                        keep &= False
                nbr, tgt2, vis2, row = nbr[keep], tgt2[keep], vis2[keep], cur[tok][keep]
                f = [nbr, tgt2, vis2]
                if meta:
                    f.append(self._edge_meta(sh, row, nbr))
                sends.append(f)
                dests.append((nbr // b).long())
            toks = self._route(dests, sends)
        return msg, subs
