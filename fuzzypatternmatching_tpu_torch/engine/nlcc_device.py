"""Device-side NLCC: the token-passing walks on a torch device.

Counterpart of ``fuzzypatternmatching_tpu/engine/nlcc_device.py``. A whole
constraint (all ``cycle_length + 1`` hops of nem_1.hpp / tds_batch_1.hpp
token passing) runs hop by hop on the device, with the JAX package's walk
structure (``_nem_prog``, ``_tds_prog``):

  * each hop's fan-out is ``ops.nlcc_frontier.expand_frontier``, which
    counts the messages and keeps only the lanes passing the next hop's
    arrival bit, into a frontier sized exactly: there is no capacity, no
    doubling and no overflow;
  * the per-(vertex, source) forwarded-token dedup of a nem hop
    (nem_1.hpp:131-139, 270-286) is ``ops.nlcc_frontier.forward_winners``:
    the key not forwarded before, the smallest parent winning;
  * TDS keeps its walk history as an int32 [lanes, cycle_length + 1]
    tensor gathered by token, and applies its sender-side keep rules in
    plain torch.

Results equal ``engine/nlcc.py`` (the host engine) and the JAX package's
``DeviceNlcc``: the same NlccOutcome, message counts, winners and
subgraphs. Dedup keys are ``v * V + src`` in int64.

While a torch profiler records (``utils/trace.py``), a walk keeps spans
inside MatchEngine's ``fpm.nlcc.walk.device``: ``.prepare`` (the CSR
upload and ``_ok_bits``), ``.expand`` (each ``expand_frontier`` call),
``.winners`` (a nem hop's ``forward_winners`` and the forwarded keys'
concatenation; a TDS hop's receiver-side and sender-side keep rules) and
``.out`` (the acceptance, the validated read, the edge marks, the
forwarded keys' sort and download and the message counts); and it counts
the lanes each expansion took in (``nlcc_device_lanes``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import nlcc_frontier as nf
from ..pattern.nonlocal_constraint import NonLocalConstraint
from ..utils import trace
from ..utils.trace import to_device, to_host
from .nlcc import (
    AliveCsr,
    ForwardedSets,
    NlccOutcome,
    map_keys_of,
    tds_start_pairs,
    token_sources,
)


# the walk's spans, inside MatchEngine's fpm.nlcc.walk.device
_PREPARE = "fpm.nlcc.walk.device.prepare"
_EXPAND = "fpm.nlcc.walk.device.expand"
_WINNERS = "fpm.nlcc.walk.device.winners"
_OUT = "fpm.nlcc.walk.device.out"


def _ids(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Vertex ids (any integer array below 2^31) as int32 on ``dev``."""
    return to_device(np.ascontiguousarray(a, dtype=np.int32), dev)


class DeviceNlcc:
    """run_nem / run_tds of ``engine/nlcc.py`` on a torch device."""

    def __init__(
        self, num_vertices: int, num_ranks: int = 1, *,
        device: torch.device | str = "cuda",
    ):
        if num_vertices >= (1 << 31):
            raise ValueError("device NLCC dedup keys require V < 2^31")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device is available")
        self.V = num_vertices
        self.R = num_ranks
        self._labels: tuple | None = None  # (host labels, their device copy)

    # -- CSR upload (cached per AliveCsr instance) --------------------------

    def prepare(self, acsr: AliveCsr) -> tuple[torch.Tensor, torch.Tensor]:
        """The alive CSR on the device: ``ptr`` int64 [V + 1], ``col``
        int32 [A], uploaded once per AliveCsr."""
        dev = getattr(acsr, "_dev_cache", None)
        if dev is not None and dev[0] == self.device:
            return dev[1], dev[2]
        ptr = to_device(np.ascontiguousarray(acsr.ptr, dtype=np.int64), self.device)
        col = _ids(acsr.col, self.device)
        acsr._dev_cache = (self.device, ptr, col)
        return ptr, col

    # -- host-side helpers ---------------------------------------------------

    def _labels_dev(self, labels: np.ndarray) -> torch.Tensor:
        """The labels as int64 on the device, uploaded once per array."""
        if self._labels is None or self._labels[0] is not labels:
            lab = np.ascontiguousarray(labels, dtype=np.uint64).view(np.int64)
            self._labels = (labels, to_device(lab, self.device))
        return self._labels[1]

    def _ok_bits(
        self, labels, tv, c: NonLocalConstraint,
        map_keys: np.ndarray | None = None,
    ) -> torch.Tensor:
        """Per-vertex bitmask on the device (int32 holding the JAX
        package's uint32 words): bit h set iff the vertex passes the hop-h
        arrival check (label + template-vertex bit); bit 0 set iff it
        qualifies as a token source (the token_source_map membership test);
        bit 31 set iff the vertex is a token_source_map key (cycle
        acceptance drops tokens whose source is missing from the map, like
        the reference's error path — nem_1.hpp:750-755). tv is fixed for
        the duration of one constraint run, so this is precomputable."""
        if c.cycle_length + 1 > nf.MAX_HOP_BIT:
            raise ValueError(
                f"walks of more than {nf.MAX_HOP_BIT} hops do not fit the arrival bits"
            )
        lab = self._labels_dev(labels)
        tvd = to_device(np.ascontiguousarray(tv, dtype=np.uint32).view(np.int32), self.device)
        bits = torch.zeros(self.V, dtype=torch.int32, device=self.device)
        for h in range(0, c.cycle_length + 2):
            ok = (lab == int(c.labels[h])) & (((tvd >> int(c.indices[h])) & 1) != 0)
            bits |= ok.int() << h
        if map_keys is not None:
            bits[_ids(map_keys, self.device).long()] |= torch.iinfo(torch.int32).min
        return bits

    def _first_expansion(self, acsr: AliveCsr, sources: np.ndarray) -> int:
        if len(sources) == 0:
            return 0
        return int(acsr.degrees(sources).sum())

    def _msg_out(self, msg_r: torch.Tensor) -> tuple[int, np.ndarray]:
        m = to_host(msg_r)
        return int(m.sum()), m

    @staticmethod
    def _expand(*args) -> nf.Expansion:
        """``nf.expand_frontier(*args)`` in its span, its lanes counted."""
        with trace.span(_EXPAND):
            ex = nf.expand_frontier(*args)
        trace.count("nlcc_device_lanes", ex.lanes)
        return ex

    # -- public API (mirrors engine/nlcc.py) ---------------------------------

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
        *,
        active: np.ndarray | None = None,
    ) -> NlccOutcome:
        assert num_vertices == self.V
        if hopc is not None:
            raise NotImplementedError(
                "metadata hop filters run in the host or mesh NLCC engines"
            )
        if forwarded is None:
            forwarded = ForwardedSets.empty()
        sources = token_sources(c, labels, tv, candidates, active=active)
        if c.selected_vertices:
            map_keys = map_keys_of(c, labels, tv, active)
        else:
            map_keys = sources
        dev, V, R, maxi = self.device, self.V, self.R, c.cycle_length
        with trace.span(_PREPARE):
            ptr, col = self.prepare(acsr)
            ok_bits = self._ok_bits(labels, tv, c, map_keys)
        validated = torch.zeros(V, dtype=torch.bool, device=dev)
        seen = to_device(forwarded.keys, dev)  # fwd_in, then winners
        edge_marks: list = []

        src0 = _ids(sources, dev)
        ex = self._expand(ptr, col, src0, src0, ok_bits, 1, R, False)
        msg_r = ex.msg_per_rank
        cur, src, parent = ex.nbr, src0[ex.tok], src0[ex.tok]
        for h in range(1, maxi + 1):
            if cur.numel() == 0:
                break
            # label/bit arrival checks for hop h were applied at expansion
            with trace.span(_WINNERS):
                relay = cur != src  # the target cannot relay (nem_1.hpp:173-177)
                cur, src, parent = cur[relay], src[relay], parent[relay]
                keys = cur.long() * V + src
                win = nf.forward_winners(keys, parent, seen)
                cur, src, parent, keys = cur[win], src[win], parent[win], keys[win]
                seen = torch.cat([seen, keys])
            # don't return to the vertex the winner received the token from
            ex = self._expand(ptr, col, cur, parent, ok_bits, h + 1, R, True)
            msg_r = msg_r + ex.msg_per_rank
            cur, src, parent = ex.nbr, src[ex.tok], cur[ex.tok]

        with trace.span(_OUT):
            # the tokens that arrived at hop maxi + 1 (arrival checks
            # applied at expansion)
            if cur.numel() > 0:
                if not c.valid_cycle:
                    acc = cur != src
                    if c.selected_vertices:
                        # validate destinations that forwarded this source
                        keys = cur.long() * V + src
                        acc &= nf.in_sorted(torch.sort(seen).values, keys)
                        validated[cur[acc].long()] = True
                    else:
                        validated[src[acc].long()] = True
                else:
                    # bit 31: the source is a token_source_map key
                    acc = (cur == src) & (ok_bits[cur.long()] < 0)
                    validated[src[acc].long()] = True
                    edge_marks = list(
                        zip(to_host(cur[acc]).tolist(), to_host(parent[acc]).tolist())
                    )
            if seen.shape[0] > len(forwarded.keys):
                # ForwardedSets.add's sorted union, taken on the device: the
                # earlier keys and this run's winners are all distinct
                forwarded.keys = to_host(torch.sort(seen).values)
            messages, msg_r = self._msg_out(msg_r)
            found = to_host(validated[_ids(map_keys, dev).long()])
        return NlccOutcome(map_keys, found, messages, edge_marks, None, msg_r)

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
        *,
        active: np.ndarray | None = None,
    ) -> NlccOutcome:
        assert num_vertices == self.V
        if hopc is not None:
            raise NotImplementedError(
                "metadata hop filters run in the host or mesh NLCC engines"
            )
        sources = token_sources(c, labels, tv, candidates, active=active)
        starts, targets = tds_start_pairs(c, sources, forwarded, self.V)
        dev, V, R, maxi = self.device, self.V, self.R, c.cycle_length
        W = maxi + 1  # walk history columns 0..maxi
        enum = c.enumeration
        with trace.span(_PREPARE):
            ptr, col = self.prepare(acsr)
            ok_bits = self._ok_bits(labels, tv, c)
        validated = torch.zeros(V, dtype=torch.bool, device=dev)
        subgraphs = np.empty((0, maxi + 3), dtype=np.int64)

        # initial fan-out (position-0 send): counted, and arrival-filtered
        # for hop 1, like every later hop
        st, tg = _ids(starts, dev), _ids(targets, dev)
        ex = self._expand(ptr, col, st, st, ok_bits, 1, R, False)
        msg_r = ex.msg_per_rank
        # the walk start lives in visited[:, 0]; tgt is the expected target
        # (== start unless selected-vertices, tds_batch_1.hpp:494-500)
        cur, tgt = ex.nbr, tg[ex.tok]
        visited = torch.zeros((cur.shape[0], W), dtype=torch.int32, device=dev)
        visited[:, 0] = st[ex.tok]
        for h in range(1, maxi + 1):
            if cur.numel() == 0:
                break
            with trace.span(_WINNERS):
                # receiver-side enumeration rule (tds_batch_1.hpp:620-639)
                k = int(enum[h])
                if k == h:
                    ok = ~(visited[:, :h] == cur[:, None]).any(1)
                elif k < h:
                    ok = visited[:, k] == cur
                else:
                    ok = torch.zeros_like(cur, dtype=torch.bool)
                cur, tgt, visited = cur[ok], tgt[ok], visited[ok]
                visited[:, h] = cur
            ex = self._expand(ptr, col, cur, cur, ok_bits, -1, R, False)
            with trace.span(_WINNERS):
                nbr, tgt, visited = ex.nbr, tgt[ex.tok], visited[ex.tok]
                if h == maxi:
                    # penultimate hop (tds_batch_1.hpp:806-846)
                    keep = nbr == tgt if c.valid_cycle else nbr != tgt
                else:
                    keep = torch.ones_like(nbr, dtype=torch.bool)
                if not (h == maxi and c.valid_cycle):  # a cycle closes on the target
                    k2 = int(enum[h + 1])
                    if k2 == h + 1:
                        keep &= ~(visited[:, : h + 1] == nbr[:, None]).any(1)
                    elif k2 < h + 1:
                        keep &= visited[:, k2] == nbr
                    else:
                        keep &= False
                msg_r = msg_r.index_add(0, (nbr % R).long(), keep.long())
                keep &= ((ok_bits[nbr.long()] >> (h + 1)) & 1) != 0
                cur, tgt, visited = nbr[keep], tgt[keep], visited[keep]

        with trace.span(_OUT):
            # the walks that arrived at hop maxi + 1
            if cur.numel() > 0:
                if not c.valid_cycle:
                    acc = cur != tgt
                    emit = acc  # path writes before the ack
                else:
                    acc = (cur == tgt) & (visited[:, 0] == cur)
                    # cycle writes only when the target is in the map
                    emit = acc & ((ok_bits[tgt.long()] & 1) != 0)
                validated[tgt[acc].long()] = True
                if collect_subgraphs and bool(emit.any()):
                    last = cur[emit, None]
                    subgraphs = to_host(torch.cat([visited[emit], last, last], 1))
                    subgraphs = subgraphs.astype(np.int64)
            messages, msg_r = self._msg_out(msg_r)
            found = to_host(validated[_ids(sources, dev).long()])
        return NlccOutcome(sources, found, messages, [], subgraphs, msg_r)
