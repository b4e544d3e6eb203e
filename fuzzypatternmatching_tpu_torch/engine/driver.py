"""Match driver on the torch LCC engine — the prune-to-fixpoint loop.

Counterpart of ``fuzzypatternmatching_tpu/engine/driver.py``: LCC call
(diameter supersteps), forced token passing on iteration 0, per-constraint
NLCC with source invalidation, interleaved LCC re-runs after source
deletions, global fixpoint. LCC runs on the given device, on the bucketed
engine (``engine/lcc_bucketed.py``) with the compact continuation — after
the global init superstep the remaining supersteps run on an engine rebuilt
over the pruned subgraph, on the same device — or on the flat engine
(``engine/lcc.py``), whose state the driver exchanges as E-sized global
arrays, or on a mesh of shards (``lcc_engine="sharded"`` or ``mesh=``:
``parallel/sharded.py``, with the compact continuation on the mesh's first
device). The compact continuation keeps its state between LCC phases on
the host, in the driver (``_HostState``: tv, the alive pairs and the TP
marks), beside the sub-engine's device state that the search's next phase
starts from; the engines hold only device states. Each NLCC constraint runs on
the device engine (``engine/nlcc_device.py``; on a mesh
``parallel/nlcc_sharded.py``) or the host engine (``engine/nlcc.py``, the
port's copy of the JAX package's), placed by ``nlcc_mode``; the placement
never changes a result.

Counting-LCC (``counting=True``) and edge-metadata matching
(``edge_data``, active only when the pattern carries ``pattern_edge_data``
too) run on every LCC engine; with metadata a constraint runs on the host
NLCC engine or the mesh NLCC, whose walks filter each hop by the edge's
metadata, never on the single-device ``DeviceNlcc``.

``superstep_timing=True`` runs one LCC call per superstep and records each
one's own seconds (the reference's per-step brackets, beta.cpp:592-596).

While a torch profiler records, ``run()`` keeps its spans and counters on
the result (``utils/trace.py``): ``fpm.search`` around the whole run;
``fpm.lcc`` around each LCC phase, with ``fpm.lcc.call`` (an LCC call on
the full engine, its stats read included), ``fpm.lcc.download`` (the
state's tv and alive pairs) and ``fpm.lcc.compact`` (the compact
continuation: ``.closure``, ``.call``, ``.back``; a search's first phase maps
the init superstep's alive plane into the cached closure on the device and
downloads nothing, counted in ``compact_device_maps``); ``fpm.nlcc`` around
each constraint, with ``fpm.nlcc.csr``, ``fpm.nlcc.place``,
``fpm.nlcc.walk.host`` or ``fpm.nlcc.walk.device`` (with the device
walk's own spans inside: ``engine/nlcc_device.py``) and ``fpm.nlcc.marks``
(the outcome applied and the TP row counted), and any LCC phase it causes;
``fpm.state`` (each host read of the state), ``fpm.update`` (each upload
of tv and marks) and ``fpm.result`` (the final read and the active sets).
The bucketed engine opens ``fpm.pairs`` inside whichever of these reads
the alive pairs off the device (``alive_pairs``), and counts the slots
its supersteps run over (``lcc_slots``). A closure built on a cache miss
opens ``fpm.lcc.compact.build`` inside ``.closure`` (``_closure``), with
``.keys`` (the alive keys' symmetric union and its rows and columns),
``.graph`` (``from_edges`` over it, and its edge metadata), the
sub-engine's ``fpm.build.lcc`` (``engine/lcc_bucketed.py``), ``.alive``
(the alive set's edge ids in it) and ``.slot_map`` (``_slot_map``, with
the graph's edge keys where they are first built).

The constructor is recorded on the host clock, and so is an engine's
first search where no profiler records it (``utils/trace.py``: ``build``,
``search``; ``setup_records``): ``fpm.build`` around the
constructor, its own time the labels, the edge metadata, the compact
test and the token-source candidates, and one device synchronise at its
end, so that it ends once the planes have landed; inside it
``fpm.build.lcc`` (the bucketed engine's, with its ``.layout``,
``.codes`` and ``.planes``) and ``fpm.build.nlcc`` (the ``DeviceNlcc``
or ``ShardedNlcc`` constructor). The first search's record holds the
spans above, its closure's build among them.

The positional parameters are the JAX ``MatchEngine``'s, in its order;
``device`` is keyword-only. ``lcc_pallas`` is taken and ignored: in the JAX
package it chose the Pallas superstep, whose results equal the XLA one's,
and the port has only its kernels.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..graph.csr import Graph, from_edges
from ..ops.lcc_superstep import map_alive
from ..pattern.nonlocal_constraint import NonLocalConstraint
from ..pattern.pattern_graph import PatternGraph
from ..utils import trace
from ..utils.trace import to_device, to_host
from .lcc import LccEngine
from .lcc_bucketed import BucketedLccEngine, BucketedState
from .nlcc import (
    AliveCsr,
    ForwardedSets,
    invalidate_sources,
    run_nem,
    run_tds,
    token_sources,
)
from .nlcc_device import DeviceNlcc
from .result import MatchResult, PhaseRow

# "auto" places a constraint on the device when its first token expansion
# has at least this many lanes (set from H100 timings of both placements,
# PERF.md)
NLCC_DEVICE_MIN = 1 << 12


@dataclass
class _HostState:
    """The compact continuation's state between LCC phases, on the host:
    tv (uint32 [V]), the alive (row, col) pairs in CSR row-major order and
    the TP success marks (CSR edge ids), all int64. The sub-engine numbers
    vertices as the graph does, so its output is this record as it comes;
    it becomes a full-engine state only in ``_lcc_calls``. ``sub`` and
    ``sub_state`` are the sub-engine it came out of and that engine's
    output state, whose alive plane on the device holds exactly these
    pairs: the search's next phase starts from that plane
    (``_compact_call``). None in a state made any other way."""

    tv: np.ndarray
    arow: np.ndarray
    acol: np.ndarray
    marks: np.ndarray
    sub: BucketedLccEngine | None = None
    sub_state: BucketedState | None = None

    def with_updates(self, tv: np.ndarray, tp_marks) -> _HostState:
        """New tv, and ``tp_marks`` merged into the marks (an empty list
        leaves them as they are); the alive set and its plane stay."""
        marks = self.marks
        if tp_marks:
            marks = np.union1d(marks, np.asarray(list(tp_marks), dtype=np.int64))
        return _HostState(
            np.asarray(tv).astype(np.uint32), self.arow, self.acol, marks,
            self.sub, self.sub_state,
        )


class _SlotMap(NamedTuple):
    """The cached closure's slots in the full bucketed engine, on the
    device, int32 [the sub-engine's num_slots + 1] each: ``sub2full`` the
    full engine's slot of each closure slot (its dead pad slot S for a pad
    slot, and for a key the graph lacks), ``row`` and ``col`` the slot's
    vertices (0 for a pad slot). What ``map_alive`` reads."""

    sub2full: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor


class MatchEngine:
    def __init__(
        self,
        graph: Graph,
        labels: np.ndarray,
        pattern: PatternGraph,
        constraints: list[NonLocalConstraint],
        num_ranks: int = 1,
        lcc_engine: str = "bucketed",
        mesh=None,
        source_batch: int = 1 << 16,
        nlcc_mode: str = "auto",
        nlcc_device_min: int = NLCC_DEVICE_MIN,
        superstep_timing: bool = False,
        counting: bool = False,
        lcc_pallas: bool = False,
        edge_data: np.ndarray | None = None,
        compact: bool = True,
        *,
        device: torch.device | str = "cuda",
    ):
        if lcc_engine not in ("bucketed", "flat", "sharded"):
            raise ValueError(
                f"lcc_engine={lcc_engine!r}: not bucketed, flat or sharded"
            )
        if nlcc_mode not in ("auto", "device", "host"):
            raise ValueError(f"nlcc_mode={nlcc_mode!r}: not auto, device or host")
        sharded = lcc_engine == "sharded" or mesh is not None
        if not sharded and not isinstance(graph, Graph):
            raise TypeError(
                "a lazily-opened GraphDb (storage.open_db) requires "
                "lcc_engine='sharded'; other engines need storage.load"
            )
        # the constructor's spans, recorded on the host clock (utils/trace.py);
        # it ends once the device holds the planes
        with trace.build(id(self)):
            if sharded and mesh is None:
                from ..utils.dist import build_mesh

                mesh = build_mesh(device=device)
            if sharded and mesh.spans_processes:
                raise NotImplementedError(
                    f"{mesh}: the match loop is single-controller, as in the JAX "
                    "package: it reads the whole LCC state on the host between "
                    "calls (the compact continuation, the NLCC placement and "
                    "walks), and a mesh across processes holds it in several "
                    "processes. Across processes only the LCC data plane runs "
                    "(parallel/sharded.py: init_state + lcc_call; "
                    "cli/sharded_lcc_demo.py)"
                )
            # the mesh's first device hosts the driver's own device work (the
            # compact sub-engine)
            self.device = mesh.devices[0] if sharded else torch.device(device)
            self.superstep_timing = superstep_timing
            self.graph = graph
            self.labels = np.asarray(labels, dtype=np.uint64)
            self.pattern = pattern
            self.constraints = constraints
            self.num_ranks = num_ranks
            self.source_batch = source_batch
            self.counting = counting
            # edge-metadata matching is active iff BOTH the graph's edge data
            # and the pattern's edge data are present: (vals, allow, code per
            # CSR edge), a value no pattern edge requires coded M (the all-zero
            # allow row)
            self._meta = None
            if edge_data is not None and pattern.edge_data is not None:
                vals, allow = pattern.edge_meta_tables()
                ed = np.asarray(edge_data, dtype=np.int64)
                pos = np.minimum(np.searchsorted(vals, ed), len(vals) - 1)
                code = np.where(vals[pos] == ed, pos, len(vals)).astype(np.int64)
                self._meta = (vals, allow, code)
            em = None if self._meta is None else (self._meta[1], self._meta[2])
            if sharded:
                from ..parallel.sharded import ShardedLccEngine

                self.lcc = ShardedLccEngine(
                    graph, self.labels, pattern, mesh=mesh, num_ranks=num_ranks,
                    edge_meta=em, counting=counting,
                )
            elif lcc_engine == "bucketed":
                self.lcc = BucketedLccEngine(
                    graph, self.labels, pattern, device=self.device,
                    num_ranks=num_ranks, edge_meta=em, counting=counting,
                )
            else:
                self.lcc = LccEngine(
                    graph, self.labels, pattern, num_ranks=num_ranks,
                    counting=counting, edge_meta=em, device=self.device,
                )
            # the bucketed and mesh engines' states hold the alive set in slot
            # space (``alive_pairs``); the flat engine's are E-sized global arrays
            self._fast = hasattr(self.lcc, "alive_pairs")
            # NLCC placement: "device" runs every constraint on the device
            # engine, "host" on the host engine, "auto" moves a constraint to
            # the device when its first token expansion has at least
            # ``nlcc_device_min`` lanes
            self.nlcc_mode = nlcc_mode
            self.nlcc_device_min = nlcc_device_min
            self._dev_nlcc = None
            if nlcc_mode != "host" and graph.num_vertices < (1 << 31):
                with trace.span("fpm.build.nlcc"):
                    if sharded:
                        # on a mesh the token walks run on its shards
                        from ..parallel.nlcc_sharded import ShardedNlcc

                        self._dev_nlcc = ShardedNlcc(
                            graph.num_vertices, mesh, num_ranks=num_ranks
                        )
                    else:
                        self._dev_nlcc = DeviceNlcc(
                            graph.num_vertices, num_ranks=num_ranks, device=self.device
                        )
            # the JAX API's count of device runs redone on the host; the device
            # engine sizes every frontier exactly, so nothing is redone
            self.nlcc_fallbacks = 0
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
            # the compact closure needs the full edge_row/cols arrays, which a
            # lazily-opened GraphDb lacks
            self._compact_engine = compact and self._fast and isinstance(graph, Graph)
            # (fp, keys, union, alive_sub_eids, sub, slot map): the compact
            # closure and its engine, keyed on the alive set it was built for; it
            # also serves any alive set inside ``union`` (``_closure``), and
            # through the slot map (None beside a mesh engine) a search's first
            # phase on the device (``_mapped_call``)
            self._sub_cache: tuple | None = None
            self._edge_keys: np.ndarray | None = None
            # per-constraint token-source label candidates (labels never change)
            self._cands = [
                np.nonzero(self.labels == c.labels[0])[0].astype(np.int64)
                for c in constraints
            ]
            self._sync()
        self._unsearched = True

    def _edge_index(self, v: int, u: int) -> int:
        """Edge slot of (v, u): binary search within v's sorted CSR row."""
        lo, hi = int(self.graph.row_ptr[v]), int(self.graph.row_ptr[v + 1])
        row_cols = self.graph.cols_range(lo, hi)
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
        with trace.span("fpm.lcc"):
            return self._lcc_calls(state, global_init, itr, result, tp_mark_eids)

    def _lcc_calls(self, state, global_init, itr, result, tp_mark_eids):
        if self.superstep_timing:
            # one LCC call per superstep, each timed on its own
            rows, died_any, first = [], False, global_init
            for _ in range(self.pattern.diameter):
                self._sync()
                t0 = time.perf_counter()
                with trace.span("fpm.lcc.call"):
                    state, r1, d1 = self.lcc.lcc_call(state, first, n_steps=1)
                self._sync()
                dt = time.perf_counter() - t0
                died_any = died_any or d1
                first = False
                for row in r1:
                    rows.append((row, dt))
            for s, ((av, ae, msgs, per_rank), dt) in enumerate(rows):
                result.rows.append(PhaseRow(itr, "LP", s, av, ae, msgs, dt, per_rank))
                result.traversed_edges += msgs
            return state, died_any
        if not (self._compact_ok and self._compact_engine):
            t0 = time.perf_counter()
            with trace.span("fpm.lcc.call"):
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
            with trace.span("fpm.lcc.call"):
                state, r1, d1 = self.lcc.lcc_call(state, True, n_steps=1)
            rows_all += r1
            died_any = died_any or d1
            steps_left -= 1
        if steps_left > 0:
            out = None
            if global_init and not tp_mark_eids:
                out = self._mapped_call(state, r1, steps_left)
            if out is None:
                out = self._host_call(state, steps_left, tp_mark_eids)
            state, r2, d2 = out
            rows_all += r2
            died_any = died_any or d2
        dt = (time.perf_counter() - t0) / max(len(rows_all), 1)
        self._emit_lp_rows(rows_all, dt, itr, result)
        return state, died_any

    def _host_call(self, state, steps_left, tp_mark_eids):
        """The supersteps after the init one from the state's alive pairs on
        the host: a device state's downloaded, a host state's read in
        place; on the full engine where the alive set is empty or above
        E/4, else on the compact closure (``_compact_call``)."""
        if isinstance(state, _HostState):
            tv, arow, acol = state.tv, state.arow, state.acol
        else:
            with trace.span("fpm.lcc.download"):
                tv = self.lcc.tv_host(state)
                arow, acol = self.lcc.alive_pairs(state)
        if len(arow) == 0 or len(arow) > self.graph.num_edges // 4:
            with trace.span("fpm.lcc.call"):
                if isinstance(state, _HostState):
                    # a compact phase's output lies inside its input (at
                    # most E/4), so only an empty alive set gets here
                    state = self._state_from_pairs(tv, arow, acol, state.marks)
                return self.lcc.lcc_call(state, False, n_steps=steps_left)
        with trace.span("fpm.lcc.compact"):
            return self._compact_call(
                tv, arow, acol, steps_left, tp_mark_eids,
                carried=state if isinstance(state, _HostState) else None,
            )

    def _mapped_call(self, state, init_rows, steps_left):
        """A search's first compact phase from the init superstep's device
        state, with nothing downloaded, looked up or built on the host: the
        alive count is the init superstep's own (``ae`` of its stats row),
        the sub-engine's alive plane is the full engine's read through the
        cached closure's slot map (``map_alive``), tv is the full state's on
        the device (the sub-engine numbers vertices as the graph does) and
        the flag plane is zero (a first phase has no marks). The map writes
        every alive slot exactly where the alive set lies inside the cached
        closure; else, and where the cache holds no map or the count is
        outside the compact route, None: the host route (``_host_call``)
        runs, and builds a closure where it must."""
        cache = self._sub_cache
        if cache is None or cache[5] is None:
            return None
        n_alive = sum(row[1] for row in init_rows)
        if not 0 < n_alive <= self.graph.num_edges // 4:
            return None
        sub, smap = cache[4], cache[5]
        with trace.span("fpm.lcc.compact"):
            with trace.span("fpm.lcc.compact.closure"):
                # the alive slots written, and whether a live vertex touches
                # none (the died flag, as in _compact_call), in one host read
                alive, _, stats = map_alive(
                    state.alive, smap.sub2full, smap.row, smap.col, state.tv
                )
                flag = torch.zeros_like(alive)
                mapped, lone = to_host(stats).tolist()
                if mapped != n_alive:
                    return None
            trace.count("compact_device_maps")
            with trace.span("fpm.lcc.compact.call"):
                sub_state, rows, died = sub.lcc_call(
                    BucketedState(state.tv, alive, flag), False, n_steps=steps_left
                )
            with trace.span("fpm.lcc.compact.back"):
                return self._host_state_of(sub, sub_state), rows, died or bool(lone)

    @staticmethod
    def _host_state_of(sub, sub_state) -> _HostState:
        """The driver's host state of a compact phase's output: the
        sub-engine's tv and alive pairs as they come (the sub-engine starts
        alive only on graph edges and alive only shrinks), no marks, and
        the sub-engine and its state beside them."""
        a2r, a2c = sub.alive_pairs(sub_state)
        return _HostState(
            sub.tv_host(sub_state), a2r, a2c, np.empty(0, np.int64), sub, sub_state
        )

    def _compact_call(self, tv, arow, acol, steps_left, tp_mark_eids, carried=None):
        """``steps_left`` supersteps on the SYMMETRIC CLOSURE of the alive
        set, or on a cached closure that contains it: a live sender edge
        (u,v) delivers into receiver slot (v,u) even when that slot itself is
        dead (its message still feeds tn), so dead-but-reachable slots exist
        in the subgraph with alive=False. A slot of a larger closure outside
        this one is dead both ways: it sends, receives and keeps nothing.

        ``carried``, the host state that the search's previous phase
        returned: where its sub-engine is still the cached one, the phase
        starts from that engine's alive plane on the device, so it neither
        looks the closure up nor builds the slot planes on the host."""
        cache = self._sub_cache
        carry = carried is not None and cache is not None and carried.sub is cache[4]
        with trace.span("fpm.lcc.compact.closure"):
            if carry:
                union, sub = cache[2], carried.sub
            else:
                union, alive_sub_eids, sub = self._closure(arow, acol)
        with trace.span("fpm.lcc.compact.call"):
            flag_ids = self._marks_in_closure(union, tp_mark_eids)
            if carry:
                trace.count("compact_state_carries")
                sub_state = sub.state_on_alive(tv, carried.sub_state.alive, flag_ids)
            else:
                sub_state = sub.state_from_edge_ids(tv, alive_sub_eids, flag_ids=flag_ids)
            sub_state, rows, died = sub.lcc_call(sub_state, False, n_steps=steps_left)
        with trace.span("fpm.lcc.compact.back"):
            # a live vertex with no alive incident edge: the full engine
            # kills it in this call's first superstep and raises the died
            # flag. The sub-engine zeroes its tv too, whether a larger cached
            # closure holds its row (the keep rule) or not (no row), but
            # raises the flag only in the first case
            touched = np.zeros(len(tv), dtype=bool)
            touched[arow] = True
            touched[acol] = True
            if ((tv != 0) & ~touched).any():
                died = True
            return self._host_state_of(sub, sub_state), rows, died

    def _marks_in_closure(self, union, tp_mark_eids):
        """The TP marks (CSR edge ids) as edge ids of the closure whose keys
        are ``union``; None where there are none. Marks on dead slots are
        no-ops in the full engine (own_alive gates the flag), so only union
        hits carry over."""
        if not tp_mark_eids:
            return None
        mk = self._edge_keys_cached()[np.asarray(tp_mark_eids, dtype=np.int64)]
        mp = np.minimum(np.searchsorted(union, mk), len(union) - 1)
        return mp[union[mp] == mk]

    def _closure(self, arow, acol):
        """(union, alive_sub_eids, sub): the keys of a symmetric closure that
        contains the alive set, the alive set's edge ids in it and the engine
        over it. From ``_sub_cache`` when the alive set is the cached one or
        lies inside its closure (the alive set only shrinks within a search,
        so a later LCC phase's lies inside the first's: such a phase skips
        this lookup where it carries the cached engine's device state,
        ``_compact_call``); the entry then keeps the larger closure, which
        the next search's first phase hits exactly. Else built, and
        cached."""
        vv = np.uint64(self.graph.num_vertices)
        keys = arow.astype(np.uint64) * vv + acol.astype(np.uint64)
        fp = (len(keys), int(keys[0]), int(keys[-1]))
        cache = self._sub_cache
        if cache is not None:
            if cache[0] == fp and np.array_equal(keys, cache[1]):
                return cache[2:5]
            union = cache[2]
            # keys and union are sorted: each key's position in union
            pos = np.searchsorted(union, keys)
            if pos[-1] < len(union) and np.array_equal(union[pos], keys):
                trace.count("compact_subset_hits")
                return union, pos, cache[4]
        trace.count("compact_builds")
        with trace.span("fpm.lcc.compact.build"):
            with trace.span("fpm.lcc.compact.build.keys"):
                rkeys = acol.astype(np.uint64) * vv + arow.astype(np.uint64)
                union = np.union1d(keys, rkeys)
                u_row = (union // vv).astype(np.int64)
                u_col = (union % vv).astype(np.int64)
            with trace.span("fpm.lcc.compact.build.graph"):
                gsub = from_edges(u_row, u_col, num_vertices=self.graph.num_vertices)
                sub_meta = None
                if self._meta is not None:
                    # union is in CSR key order, so from_edges keeps it: sub
                    # edge e is union[e]
                    sub_meta = (
                        self._meta[1],
                        self._meta[2][np.searchsorted(self._edge_keys_cached(), union)],
                    )
            sub = BucketedLccEngine(
                gsub, self.labels, self.pattern, device=self.device,
                num_ranks=self.num_ranks, edge_meta=sub_meta,
                counting=self.counting,
            )
            with trace.span("fpm.lcc.compact.build.alive"):
                # per-slot aliveness = membership in the original set
                pos = np.minimum(np.searchsorted(keys, union), len(keys) - 1)
                alive_sub_eids = np.nonzero(keys[pos] == union)[0]
            with trace.span("fpm.lcc.compact.build.slot_map"):
                smap = self._slot_map(union, sub)
        self._sub_cache = (fp, keys, union, alive_sub_eids, sub, smap)
        return self._sub_cache[2:5]

    def _slot_map(self, union, sub) -> _SlotMap | None:
        """The slot map of the closure ``sub`` over the sorted keys ``union``
        (sub edge e is union[e]) into the full engine, for ``_mapped_call``;
        None where the full engine is not a bucketed one (a mesh's states
        are not one slot plane)."""
        full = self.lcc
        if not isinstance(full, BucketedLccEngine):
            return None
        vv = np.uint64(self.graph.num_vertices)
        ek = self._edge_keys_cached()
        pos = np.minimum(np.searchsorted(ek, union), len(ek) - 1)
        n = sub.num_slots + 1
        sub2full = np.full(n, full.num_slots, dtype=np.int32)
        row = np.zeros(n, dtype=np.int32)
        col = np.zeros(n, dtype=np.int32)
        at = sub._edge_to_slot
        sub2full[at] = np.where(ek[pos] == union, full._edge_to_slot[pos], full.num_slots)
        row[at] = union // vv
        col[at] = union % vv
        return _SlotMap(*(to_device(a, self.device) for a in (sub2full, row, col)))

    def _sync(self) -> None:
        """Wait for the LCC engine's devices before a clock read."""
        devices = self.lcc.mesh.devices if hasattr(self.lcc, "mesh") else [self.device]
        for dev in set(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _emit_lp_rows(self, rows, dt, itr, result):
        for s, (av, ae, msgs, per_rank) in enumerate(rows):
            result.rows.append(PhaseRow(itr, "LP", s, av, ae, msgs, dt, per_rank))
            result.traversed_edges += msgs

    def _state_from_pairs(self, tv, arow, acol, flag_ids=None):
        """Full-engine state with the alive set given as (row, col) pairs
        and TP success marks on the edge ids ``flag_ids``."""
        edge_keys = self._edge_keys_cached()
        keys = arow.astype(np.uint64) * np.uint64(
            self.graph.num_vertices
        ) + acol.astype(np.uint64)
        pos = np.searchsorted(edge_keys, keys)
        eids = pos[edge_keys[np.minimum(pos, len(edge_keys) - 1)] == keys]
        return self.lcc.state_from_edge_ids(tv, eids, flag_ids=flag_ids)

    def _with_updates(self, state, tv: np.ndarray, tp_marks):
        """``state`` with tv replaced and the TP success marks set: the
        compact continuation's on the host, any other by the engine."""
        if isinstance(state, _HostState):
            return state.with_updates(tv, tp_marks)
        return self.lcc.with_updates(state, tv, tp_marks)

    def _nlcc_on_device(
        self, acsr: AliveCsr, c: NonLocalConstraint, tv: np.ndarray,
        candidates: np.ndarray | None = None, *, active: np.ndarray | None = None,
    ) -> bool:
        """Place one constraint run: "auto" moves it to the device when the
        first token expansion is big enough to pay for the device run's
        fixed costs (launches and host reads per hop)."""
        if self._dev_nlcc is None or self.nlcc_mode == "host":
            return False
        if self._meta is not None and not hasattr(self._dev_nlcc, "mesh"):
            # the metadata hop filters run in the host or mesh NLCC engines
            return False
        if self.nlcc_mode == "device":
            return True
        sources = token_sources(c, self.labels, tv, candidates, active=active)
        work = self._dev_nlcc._first_expansion(acsr, sources)
        return work >= self.nlcc_device_min

    def _run_constraint(self, pl, c, acsr, tv, forwarded, act):
        """One NLCC constraint, on the device or the host engine; ``act``
        (ascending) holds every vertex with tv != 0."""
        g = self.graph
        cand = self._cands[pl]
        with trace.span("fpm.nlcc.place"):
            use_dev = self._nlcc_on_device(acsr, c, tv, cand, active=act)
        with trace.span("fpm.nlcc.walk.device" if use_dev else "fpm.nlcc.walk.host"):
            # metadata mode: the code each hop's edge must carry
            hopc = (
                np.searchsorted(self._meta[0], self.pattern.hop_edge_values(c.indices))
                if self._meta is not None
                else None
            )
            # driver-level forwarded-set clearing runs before EVERY constraint
            forwarded.reset_for(c, self.labels, tv, g.num_vertices)
            if use_dev:
                fn = self._dev_nlcc.run_tds if c.is_tds else self._dev_nlcc.run_nem
                kw = {}
                if hasattr(self._dev_nlcc, "mesh"):
                    kw = {"hopc": hopc, "source_batch": self.source_batch}
                return fn(
                    acsr, self.labels, tv, c, g.num_vertices,
                    forwarded=forwarded, candidates=cand, active=act, **kw,
                )
            if c.is_tds:
                return run_tds(
                    acsr, self.labels, tv, c, g.num_vertices,
                    source_batch=self.source_batch, num_ranks=self.num_ranks,
                    forwarded=forwarded, hopc=hopc, candidates=cand, active=act,
                )
            return run_nem(
                acsr, self.labels, tv, c, g.num_vertices,
                num_ranks=self.num_ranks, forwarded=forwarded, hopc=hopc,
                candidates=cand, active=act,
            )

    def _alive_csr(self, arow, acol, alive, tv, state) -> AliveCsr:
        """The pruned adjacency the NLCC walks expand: from the alive pairs
        (bucketed engine) or the E-sized alive flags (flat engine), with
        each edge's metadata code in metadata mode. From the pairs it
        touches only their rows (``AliveCsr.from_pairs``)."""
        g = self.graph
        if alive is not None:
            return AliveCsr.build(
                g, alive, tv != 0,
                meta=None if self._meta is None else self._meta[2],
            )
        pair_meta = None
        if self._meta is not None:
            if hasattr(self.lcc, "alive_edge_ids") and not isinstance(state, _HostState):
                # mesh engine's state: its edge ids are the pair order (a
                # lazily opened GraphDb has no E-sized key array; a host
                # state exists only over a Graph)
                pair_meta = self._meta[2][self.lcc.alive_edge_ids(state)]
            else:
                keys = arow.astype(np.uint64) * np.uint64(g.num_vertices) + acol.astype(
                    np.uint64
                )
                pair_meta = self._meta[2][np.searchsorted(self._edge_keys_cached(), keys)]
        return AliveCsr.from_pairs(arow, acol, tv, g.num_vertices, meta=pair_meta)

    def _host_state(self, state):
        """(tv, arow, acol, alive) on the host: the alive (row, col) pairs
        in CSR row-major order, and for the flat engine its E-sized alive
        flags (None for the bucketed and mesh engines)."""
        with trace.span("fpm.state"):
            if isinstance(state, _HostState):
                return state.tv.copy(), state.arow, state.acol, None
            if self._fast:
                arow, acol = self.lcc.alive_pairs(state)
                return self.lcc.tv_host(state).copy(), arow, acol, None
            tv, alive = self.lcc.state_to_global(state)
            alive = alive.copy()
            eids = np.nonzero(alive)[0]
            return tv.copy(), self.graph.edge_row[eids], self.graph.cols[eids], alive

    def run(self, max_iterations: int = 100) -> MatchResult:
        t_start = time.perf_counter()
        result = MatchResult()
        # the engine's first search, which builds the compact closure, is
        # recorded on the host clock where no profiler records
        first, self._unsearched = self._unsearched, False
        with trace.search(result, id(self) if first else None):
            self._search(result, max_iterations)
        result.total_seconds = time.perf_counter() - t_start
        return result

    def _search(self, result: MatchResult, max_iterations: int) -> None:
        result.pattern_found = [False] * len(self.constraints)
        g = self.graph
        fast = self._fast
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
                # bucketed: only the (small) alive edge set crosses to the
                # host; flat: the E-sized alive flags as well
                tv, arow, acol, alive = self._host_state(state)
                tp_marks: list = []
                tp_flag = None if fast else np.zeros(g.num_edges, dtype=bool)
                # the pruned adjacency changes only via LCC; reuse it across
                # constraints (deactivated vertices are filtered by the
                # arrival checks), and with it the active vertices: tv
                # only loses bits until the next host state, so ``act``
                # holds every vertex with tv != 0 until then
                acsr = act = None
                for pl, c in enumerate(self.constraints):
                    with trace.span("fpm.nlcc"):
                        t0 = time.perf_counter()
                        if acsr is None:
                            with trace.span("fpm.nlcc.csr"):
                                # numpy's nonzero on a bool mask is several
                                # times faster than on the uint32 words
                                act = np.flatnonzero(tv != 0)
                                acsr = self._alive_csr(arow, acol, alive, tv, state)
                        out = self._run_constraint(pl, c, acsr, tv, forwarded, act)
                        with trace.span("fpm.nlcc.marks"):
                            if c.is_tds:
                                subs = result.subgraphs.setdefault(pl, [])
                                if out.subgraphs is not None and len(out.subgraphs):
                                    subs.extend(map(tuple, out.subgraphs.tolist()))
                            if bool(out.validated.any()):
                                result.pattern_found[pl] = True
                            for v, p in out.edge_marks:
                                e = self._edge_index(v, p)
                                if e >= 0:
                                    if fast:
                                        tp_marks.append(e)
                                    else:
                                        tp_flag[e] = True
                            deleted = invalidate_sources(tv, c, out)
                            if deleted:
                                not_finished = True
                            live = act[tv[act] != 0]
                            ae_rows = arow[tv[arow] != 0]
                            per_rank = {
                                "av": np.bincount(
                                    live % self.num_ranks, minlength=self.num_ranks
                                ),
                                "ae": np.bincount(
                                    ae_rows % self.num_ranks, minlength=self.num_ranks
                                ),
                                "msg": out.msg_per_rank
                                if out.msg_per_rank is not None
                                else np.zeros(self.num_ranks, dtype=np.int64),
                            }
                            result.rows.append(
                                PhaseRow(
                                    itr, "TP", pl, len(live), len(ae_rows),
                                    out.messages, time.perf_counter() - t0, per_rank,
                                )
                            )
                            result.traversed_edges += out.messages
                        if deleted and c.interleave_lcc:
                            # the LCC phase a constraint causes runs inside
                            # the constraint's span
                            with trace.span("fpm.update"):
                                if fast:
                                    state = self._with_updates(state, tv, tp_marks)
                                else:
                                    state = self.lcc.state_from_global(tv, alive, tp_flag)
                            # tp success marks are carried into the compact
                            # subgraph's edge ids (tp_mark_eids)
                            state, died = self._lcc_phase(
                                state, False, itr, result,
                                tp_mark_eids=tp_marks if fast else None,
                            )
                            if died:
                                not_finished = True
                            tv, arow, acol, alive = self._host_state(state)
                            tp_marks = []
                            if not fast:
                                tp_flag = np.zeros(g.num_edges, dtype=bool)
                            acsr = act = None  # pruned adjacency changed
                with trace.span("fpm.update"):
                    if fast:
                        state = self._with_updates(state, tv, tp_marks)
                        pending_marks = list(tp_marks)
                    else:
                        state = self.lcc.state_from_global(tv, alive, tp_flag)
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
                    stacklevel=3,
                )
                break

        result.iterations = itr
        with trace.span("fpm.result"):
            tv, arow, acol, _ = self._host_state(state)
            keep = (tv != 0)[arow]
            result.active_edges = {
                (int(r), int(c)) for r, c in zip(arow[keep], acol[keep])
            }
            result.active_vertices = {int(v): int(tv[v]) for v in np.nonzero(tv)[0]}
