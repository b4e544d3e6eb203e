"""The kernels of the device NLCC token walk (K4), and their plain twins.

The JAX package's ``engine/nlcc_device.py`` computed these through XLA:
the ragged frontier expansion ``DeviceNlcc._expand`` with the hop filters
around it, and the per-(vertex, source) winner of a nem hop, a multi-key
sort. Here they are hand-written CUDA kernels for Hopper
(``csrc/nlcc_frontier.cu``), built with nvcc at first use
(``ops/_build.py``):

  * ``expand_frontier``: every alive neighbour of every token, less the
    lane back to the token's parent where asked, counted as messages per
    receiving rank; only the lanes that pass the hop's arrival bit are
    written, in CSR lane order, into an output sized exactly;
  * ``forward_winners``: which lanes of one nem hop forward their token:
    a key (``v * V + src``) not forwarded before, and the smallest parent
    among the lanes of that key.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain torch twin (``*_reference``), a CUDA tensor to the kernel. On the
card there is no fallback: a kernel that cannot be built or launched
raises. ``launches`` counts the calls that launched a kernel.

``ok_bits`` is int32 holding the JAX package's uint32 words: bit h set iff
the vertex passes the hop-h arrival test (bit 31, the map-key bit of the
cycle check, makes the word negative).

Routes of a CUDA call (``expand_route``, chosen from V and the lane count,
counted in ``routes`` and logged at debug level):

  * a filtered hop (``h_next >= 0``) of at least ``PLANE_MIN_LANES`` lanes
    builds the hop's 1-bit plane from ``ok_bits`` on the device, per call
    (``bit_plane``: one 8 MB read at R-MAT s21), and its summary
    (``plane_summary``: one bit per g vertices, the finest that fits one
    CTA's shared memory: g = 2 at s21). Each CTA stages the summary; a
    lane reads the exact bit from the plane (L2-resident) only where its
    summary bit is set;
  * a smaller filtered hop, and an unfiltered one (``h_next = -1``), take
    the first design of the kernel, which reads the ``ok_bits`` word.

``forward_winners`` of at least ``WINNER_PARTITION_MIN`` entries
partitions them by hash into ``winner_partitions(n)`` parts, each with a
table in one CTA's shared memory; a part that outgrows it takes a table in
global scratch memory. Fewer entries take the first design, one global
hash table. No route is a fallback: a launch that is refused raises.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple

import torch

from .lcc_superstep import _check_cuda, _on_cpu

_log = logging.getLogger(__name__)

launches = {"expand_frontier": 0, "forward_winners": 0}
# CUDA calls of each kernel by route (expand_route; "partition" /
# "global-table" for forward_winners).
routes: dict[str, int] = {}

# Lanes of the flattened expansion per chunk, a warp's unit of work in the
# kernels (csrc/nlcc_frontier.cu, kChunk).
EXPAND_CHUNK = 256
# Highest arrival bit a hop may test (bit 31 is the cycle map-key bit).
MAX_HOP_BIT = 30
# Most bytes of the plane's summary that the plane count kernel stages in
# one CTA's shared memory: 226 KB of the 227 KB a Hopper block may take
# (kSummaryBytes).
SUMMARY_BYTES = 231_424
# A filtered hop of fewer lanes takes the first design: below it the plane
# kernels' fixed cost (the plane and its summary built, the summary staged
# in every CTA of a persistent grid) can outweigh what they save. Where
# the two designs meet depends on the share of lanes the summary filters
# out, which the host does not know before the count pass. On the H100 at
# the R-MAT s21 cycle hops (chip_smoke.py [12]): hop 2, 1.14 M lanes, 73 %
# of them on a set summary bit: first design faster (0.070 against 0.091
# ms); cuts of hop 3 (3 % on a set bit): the summary faster from 1.17 M
# lanes on (0.061 against 0.069 ms; at 2.35 M 0.069 against 0.097).
PLANE_MIN_LANES = 1 << 21
# Most slots (16 bytes each: key and value) of one partition's
# shared-memory table in forward_winners: 224 KB.
WINNER_TABLE_SLOTS = 14_336
# Expected entries of one forward_winners partition, and the most
# partitions (kMaxPartitionsLog2 = 12).
WINNER_PART_ENTRIES = 1024
MAX_PARTITIONS = 4096
# forward_winners of fewer entries (earlier keys and lanes) takes the first
# design, the global hash table: below it the partitioned design's fixed
# cost (six device steps) outweighs its shared-memory tables. On the H100,
# on cuts of the R-MAT s21 cycle hop 2 (chip_smoke.py [12]): 442 K entries
# 0.042 ms (global table) against 0.043, 855 K 0.092 against 0.069; the two
# meet near 470 K.
WINNER_PARTITION_MIN = 1 << 19


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    routes.clear()


def _check_on_card(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, not {t.device}")


def _count_route(route: str) -> None:
    routes[route] = routes.get(route, 0) + 1


class Expansion(NamedTuple):
    """What ``expand_frontier`` returns: the surviving lanes in CSR lane
    order, each as its token's index into the frontier (``tok`` int32) and
    its neighbour (``nbr`` int32); the messages by receiving rank
    (``msg_per_rank`` int64 [R], ``nbr % R``); and the number of lanes of
    the whole expansion (``lanes``, before any filter)."""

    tok: torch.Tensor
    nbr: torch.Tensor
    msg_per_rank: torch.Tensor
    lanes: int


def _arrival(ok_bits: torch.Tensor, v: torch.Tensor, h: int) -> torch.Tensor:
    return ((ok_bits[v.long()] >> h) & 1) != 0


def _compact(mask: torch.Tensor, n: int, *tensors: torch.Tensor):
    """The entries of each 1-D tensor where ``mask`` holds, in order, given
    their count ``n``: a scatter, with no host read of the count."""
    idx = torch.where(mask, torch.cumsum(mask, 0) - 1, n)
    return tuple(t.new_empty(n + 1).scatter_(0, idx, t)[:n] for t in tensors)


def plane_words(num_vertices: int) -> int:
    """int32 words of the hop's bit plane of ``num_vertices`` vertices: one
    bit a vertex, rounded up to whole 16 bytes (the summary, which is the
    plane where it fits, is staged by a 16-byte bulk copy)."""
    return 4 * -(-num_vertices // 128)


def summary_layout(num_vertices: int) -> tuple[int, int]:
    """``(group_log2, words)`` of the plane's summary that one CTA holds:
    one bit per group of ``2 ** group_log2`` vertices, the finest whose
    ``words`` int32 words (a multiple of 4) fit ``SUMMARY_BYTES``.
    ``group_log2`` 0: the summary is the plane itself."""
    g = 0
    while 16 * -(-num_vertices // (128 << g)) > SUMMARY_BYTES:
        g += 1
    return g, 4 * -(-num_vertices // (128 << g))


def expand_route(num_vertices: int, h_next: int, lanes: int) -> str:
    """The route of a CUDA ``expand_frontier`` call: ``"unfiltered"``
    (``h_next = -1``: the first design, no arrival test), ``"first-design"``
    (fewer than ``PLANE_MIN_LANES`` lanes: the arrival bit read from the
    ``ok_bits`` word) or ``"summary-<g>"``: a summary of the hop's bit
    plane, one bit per g vertices, in each CTA's shared memory, and the
    exact bit read from the plane (device memory, L2-resident) only where
    the summary bit is set."""
    if h_next < 0:
        return "unfiltered"
    if lanes < PLANE_MIN_LANES:
        return "first-design"
    return f"summary-{1 << summary_layout(num_vertices)[0]}"


def bit_plane_reference(ok_bits: torch.Tensor, h: int, n_words: int) -> torch.Tensor:
    """Plain twin of :func:`bit_plane`."""
    v = ok_bits.shape[0]
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=ok_bits.device)
    bits[:v] = (ok_bits >> h) & 1
    shifts = torch.arange(32, device=ok_bits.device)
    words = (bits.view(n_words, 32) << shifts).sum(1)
    return (words - (words >> 31 << 32)).to(torch.int32)  # uint32 bits as int32


def bit_plane(ok_bits: torch.Tensor, h: int, n_words: int) -> torch.Tensor:
    """The hop's 1-bit plane (int32 [n_words]): bit v % 32 of word v // 32
    is bit ``h`` (0..31) of ``ok_bits[v]``; zero past V. Part of
    ``expand_frontier``'s filtered routes (``bit_plane_kernel``)."""
    if not 0 <= h <= 31 or n_words < -(-ok_bits.shape[0] // 32):
        raise ValueError("bit_plane: h must lie in 0..31 and n_words cover ok_bits")
    if _on_cpu("bit_plane", ok_bits):
        return bit_plane_reference(ok_bits, h, n_words)
    from . import _build

    _check_cuda("bit_plane", ok_bits)
    plane = torch.empty(n_words, dtype=torch.int32, device=ok_bits.device)
    status = _build.library("nlcc_frontier").fpm_bit_plane(
        ok_bits.data_ptr(), ok_bits.shape[0], h, plane.data_ptr(), n_words,
        torch.cuda.current_stream(ok_bits.device).cuda_stream,
    )
    _build.check(status, "bit_plane")
    return plane


def plane_summary_reference(plane: torch.Tensor, group_log2: int, n_words: int) -> torch.Tensor:
    """Plain twin of :func:`plane_summary`."""
    bits = ((plane.long().view(-1, 1) >> torch.arange(32, device=plane.device)) & 1).view(-1)
    g = 1 << group_log2
    groups = torch.zeros(n_words * 32 * g, dtype=torch.int64, device=plane.device)
    n = min(bits.shape[0], groups.shape[0])
    groups[:n] = bits[:n]
    any_set = groups.view(-1, g).amax(1).view(n_words, 32)
    words = (any_set << torch.arange(32, device=plane.device)).sum(1)
    return (words - (words >> 31 << 32)).to(torch.int32)


def plane_summary(plane: torch.Tensor, group_log2: int, n_words: int) -> torch.Tensor:
    """The summary of a bit plane (int32 [n_words]): bit q is set iff any
    plane bit of vertices ``[q * 2**group_log2, (q + 1) * 2**group_log2)``
    is. Part of ``expand_frontier``'s summary route."""
    if not 0 <= group_log2 <= 30:
        raise ValueError("plane_summary: group_log2 must lie in 0..30")
    if _on_cpu("plane_summary", plane):
        return plane_summary_reference(plane, group_log2, n_words)
    from . import _build

    _check_cuda("plane_summary", plane)
    summary = torch.empty(n_words, dtype=torch.int32, device=plane.device)
    status = _build.library("nlcc_frontier").fpm_plane_summary(
        plane.data_ptr(), plane.shape[0], group_log2, summary.data_ptr(), n_words,
        torch.cuda.current_stream(plane.device).cuda_stream,
    )
    _build.check(status, "plane_summary")
    return summary


def winner_route(n: int) -> str:
    """The route of a CUDA ``forward_winners`` call of ``n`` entries:
    ``"partition"`` (hash partitions with shared-memory tables) from
    ``WINNER_PARTITION_MIN`` entries on, ``"global-table"`` (the first
    design) below."""
    return "partition" if n >= WINNER_PARTITION_MIN else "global-table"


def winner_partitions(n: int) -> int:
    """Hash partitions of ``forward_winners`` for ``n`` entries (earlier
    keys and lanes): the fewest, a power of two up to ``MAX_PARTITIONS``,
    whose expected share ``n / P`` is at most ``WINNER_PART_ENTRIES``, so
    that the partitions' CTAs fill the card."""
    p = 1
    while p < MAX_PARTITIONS and n > p * WINNER_PART_ENTRIES:
        p *= 2
    return p


def winner_table_slots(n: int, parts: int) -> int:
    """Slots of each partition's shared-memory table: twice the expected
    share plus four standard deviations and 32, at most
    ``WINNER_TABLE_SLOTS``. A partition of more than half as many entries
    takes a table in global memory instead."""
    share = -(-n // parts)
    return min(WINNER_TABLE_SLOTS, 2 * (share + 4 * math.isqrt(share) + 32))


def _check_expand_args(ptr, col, cur, parent, ok_bits, h_next, num_ranks):
    if (
        ptr.dtype != torch.int64
        or col.dtype != torch.int32
        or cur.dtype != torch.int32
        or parent.dtype != torch.int32
        or ok_bits.dtype != torch.int32
    ):
        raise ValueError(
            "expand_frontier: expects int64 ptr, int32 col, cur, parent and ok_bits"
        )
    if cur.shape != parent.shape or cur.dim() != 1:
        raise ValueError("expand_frontier: cur and parent must be 1-D of one length")
    if not -1 <= h_next <= MAX_HOP_BIT:
        raise ValueError(f"expand_frontier: h_next must lie in -1..{MAX_HOP_BIT}")
    if num_ranks < 1:
        raise ValueError("expand_frontier: num_ranks must be at least 1")


def expand_frontier_reference(
    ptr: torch.Tensor,
    col: torch.Tensor,
    cur: torch.Tensor,
    parent: torch.Tensor,
    ok_bits: torch.Tensor,
    h_next: int,
    num_ranks: int,
    drop_parent_return: bool,
    sizes: tuple[int, int] | None = None,
) -> Expansion:
    """Plain twin of :func:`expand_frontier`: the whole expansion by
    ``repeat_interleave``, then the filters."""
    dev = cur.device
    c = cur.long()
    base = ptr[c]
    deg = ptr[c + 1] - base
    lanes = sizes[0] if sizes is not None else int(deg.sum())
    tok = torch.repeat_interleave(
        torch.arange(cur.shape[0], device=dev), deg, output_size=lanes
    )
    off = torch.arange(lanes, device=dev) - (torch.cumsum(deg, 0) - deg)[tok]
    nbr = col[base[tok] + off]
    if drop_parent_return:
        msg = nbr != parent[tok]
    else:
        msg = torch.ones(lanes, dtype=torch.bool, device=dev)
    msg_r = torch.zeros(num_ranks, dtype=torch.int64, device=dev).index_add_(
        0, (nbr % num_ranks).long(), msg.long()
    )
    keep = msg & _arrival(ok_bits, nbr, h_next) if h_next >= 0 else msg
    kept = sizes[1] if sizes is not None else int(keep.sum())
    tok_k, nbr_k = _compact(keep, kept, tok.int(), nbr)
    return Expansion(tok_k, nbr_k, msg_r, lanes)


def expand_frontier(
    ptr: torch.Tensor,
    col: torch.Tensor,
    cur: torch.Tensor,
    parent: torch.Tensor,
    ok_bits: torch.Tensor,
    h_next: int,
    num_ranks: int,
    drop_parent_return: bool,
    sizes: tuple[int, int] | None = None,
) -> Expansion:
    """One hop of token fan-out over the alive CSR (``ptr`` int64 [V + 1],
    ``col`` int32 [A]) from the frontier ``cur`` (int32 [F], token
    vertices; ``parent`` int32 [F], where each token came from).

    A lane is one (token, alive neighbour) pair. It is a message unless
    ``drop_parent_return`` is set and the neighbour is the token's parent;
    messages are counted by receiving rank. A message survives if bit
    ``h_next`` of ``ok_bits[nbr]`` is set; ``h_next = -1`` keeps every
    message. The output is sized exactly, from one host read of the lane
    total and one of the survivor total; ``sizes`` = (lanes, survivors),
    known from an earlier call on the same inputs, skips both reads (and
    so lets the call be captured in a CUDA graph)."""
    _check_expand_args(ptr, col, cur, parent, ok_bits, h_next, num_ranks)
    if _on_cpu("expand_frontier", cur):
        return expand_frontier_reference(
            ptr, col, cur, parent, ok_bits, h_next, num_ranks, drop_parent_return, sizes
        )
    return expand_frontier_cuda(
        ptr, col, cur, parent, ok_bits, h_next, num_ranks, drop_parent_return, sizes
    )


def expand_frontier_cuda(
    ptr: torch.Tensor,
    col: torch.Tensor,
    cur: torch.Tensor,
    parent: torch.Tensor,
    ok_bits: torch.Tensor,
    h_next: int,
    num_ranks: int,
    drop_parent_return: bool,
    sizes: tuple[int, int] | None = None,
    route: str | None = None,
) -> Expansion:
    """:func:`expand_frontier` on the card, by ``route``: by default
    ``expand_route(V, h_next, lanes)``. A filtered call can be forced onto
    ``"summary"`` or ``"first-design"`` whatever its lane count."""
    from . import _build

    _check_expand_args(ptr, col, cur, parent, ok_bits, h_next, num_ranks)
    _check_on_card("expand_frontier", cur)
    _check_cuda("expand_frontier", ptr, col, cur, parent, ok_bits)
    if route is not None and (h_next < 0 or route not in ("summary", "first-design")):
        raise ValueError(f"expand_frontier: route {route!r} for h_next {h_next}")
    dev = cur.device
    n_tok = cur.shape[0]
    msg_r = torch.zeros(num_ranks, dtype=torch.int64, device=dev)
    c = cur.long()
    row = ptr[c]
    deg = ptr[c + 1] - row
    lane_end = torch.cumsum(deg, 0)
    if sizes is not None:
        lanes = sizes[0]
    else:
        lanes = int(lane_end[-1]) if n_tok else 0
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    if lanes == 0:
        return Expansion(empty, empty, msg_r, 0)
    v = ok_bits.shape[0]
    if route is None:
        route = expand_route(v, h_next, lanes)
        _log.debug("expand_frontier: V=%d, h_next=%d, %d lanes: %s", v, h_next, lanes, route)
    n_chunks = -(-lanes // EXPAND_CHUNK)
    counts = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    lib = _build.library("nlcc_frontier")
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (ptr.data_ptr(), col.data_ptr(), cur.data_ptr(), parent.data_ptr(),
            lane_end.data_ptr())
    tail = (num_ranks, int(drop_parent_return))
    if route in ("unfiltered", "first-design"):
        args = (*head, n_tok, lanes, ok_bits.data_ptr(), h_next, *tail)
        count_args = (*args, counts.data_ptr(), msg_r.data_ptr(), stream)
        write_args = (*args, counts.data_ptr())
        count, write = lib.fpm_expand_count, lib.fpm_expand_write
    else:
        group_log2, summary_words = summary_layout(v)
        route = f"summary-{1 << group_log2}"
        plane = bit_plane(ok_bits, h_next, plane_words(v))
        summary = plane if group_log2 == 0 else plane_summary(plane, group_log2, summary_words)
        # col index of each token's lane l: tok_base + l
        tok_base = row - (lane_end - deg)
        # pass 1 leaves a keep bit per lane and each chunk's first token
        keep_bits = torch.empty(32 * n_chunks, dtype=torch.uint8, device=dev)
        chunk_t0 = torch.empty(n_chunks, dtype=torch.int32, device=dev)
        head = (*head, tok_base.data_ptr(), n_tok, lanes)
        args = (*head, h_next, *tail, plane.data_ptr(), summary.data_ptr(), group_log2,
                summary_words)
        count_args = (*args, counts.data_ptr(), keep_bits.data_ptr(), chunk_t0.data_ptr(),
                      msg_r.data_ptr(), stream)
        write_args = (*head, keep_bits.data_ptr(), chunk_t0.data_ptr(), counts.data_ptr())
        count, write = lib.fpm_plane_count, lib.fpm_plane_write
    _count_route(route)
    status = count(*count_args)
    _build.check(status, f"expand_frontier ({route}, count)")
    launches["expand_frontier"] += 1
    ends = torch.cumsum(counts, 0)
    kept = sizes[1] if sizes is not None else int(ends[-1])
    if kept == 0:
        return Expansion(empty, empty, msg_r, lanes)
    starts = ends - counts
    tok = torch.empty(kept, dtype=torch.int32, device=dev)
    nbr = torch.empty(kept, dtype=torch.int32, device=dev)
    status = write(
        *write_args, starts.data_ptr(), tok.data_ptr(), nbr.data_ptr(), stream,
    )
    _build.check(status, f"expand_frontier ({route}, write)")
    return Expansion(tok, nbr, msg_r, lanes)


def _check_winner_args(keys, parents, seen):
    if keys.dtype != torch.int64 or parents.dtype != torch.int32 or seen.dtype != torch.int64:
        raise ValueError("forward_winners: expects int64 keys, int32 parents, int64 seen")
    if keys.dim() != 1 or keys.shape != parents.shape or seen.dim() != 1:
        raise ValueError("forward_winners: keys and parents 1-D of one length, seen 1-D")


def in_sorted(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Membership of each ``q`` in the sorted 1-D tensor ``sorted_keys``."""
    if sorted_keys.numel() == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    pos = torch.searchsorted(sorted_keys, q).clamp_(max=sorted_keys.numel() - 1)
    return sorted_keys[pos] == q


def forward_winners_reference(
    keys: torch.Tensor, parents: torch.Tensor, seen: torch.Tensor
) -> torch.Tensor:
    """Plain twin of :func:`forward_winners`: membership by ``searchsorted``
    in the sorted ``seen``, then stable sorts by parent and by key, and the
    first lane of each key's run."""
    fresh = ~in_sorted(torch.sort(seen).values, keys)
    by_parent = torch.sort(parents, stable=True).indices
    order = by_parent[torch.sort(keys[by_parent], stable=True).indices]
    k = keys[order]
    first = torch.ones_like(k, dtype=torch.bool)
    first[1:] = k[1:] != k[:-1]
    return torch.zeros_like(first).scatter_(0, order, first & fresh[order])


def table_capacity(n: int) -> int:
    """Slots of the first design's global hash table for ``n`` keys: a
    power of two, at least 2 n."""
    return 1 << max(6, (2 * n).bit_length())


def forward_winners(
    keys: torch.Tensor, parents: torch.Tensor, seen: torch.Tensor
) -> torch.Tensor:
    """The winner flags (bool [L]) of one nem hop's relay lanes.

    ``keys`` int64 [L] are ``v * V + src`` of each lane, ``parents`` int32
    [L] the vertex it came from, ``seen`` int64 [n] every key forwarded
    before (any order). A lane wins iff its key is not in ``seen`` and no
    lane of the same key has a smaller parent (or the same parent and an
    earlier position): the sorted (key, parent) rule of the JAX package."""
    _check_winner_args(keys, parents, seen)
    if _on_cpu("forward_winners", keys):
        return forward_winners_reference(keys, parents, seen)
    return forward_winners_cuda(keys, parents, seen)


def forward_winners_cuda(
    keys: torch.Tensor,
    parents: torch.Tensor,
    seen: torch.Tensor,
    route: str | None = None,
    table_slots: int | None = None,
) -> torch.Tensor:
    """:func:`forward_winners` on the card, by ``route``: by default
    ``winner_route(n)``; ``"partition"``: hash partitions with
    shared-memory tables of ``winner_table_slots`` slots, or
    ``table_slots`` (a small value forces partitions onto their
    global-memory tables); ``"global-table"``: the first design."""
    from . import _build

    _check_winner_args(keys, parents, seen)
    _check_on_card("forward_winners", keys)
    _check_cuda("forward_winners", keys, parents, seen)
    dev = keys.device
    n_lanes, n_seen = keys.shape[0], seen.shape[0]
    win = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    if n_lanes == 0:
        return win
    lib = _build.library("nlcc_frontier")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = n_seen + n_lanes
    if route is None:
        route = winner_route(n)
        _log.debug("forward_winners: %d entries: %s", n, route)
    if route == "partition":
        parts = winner_partitions(n)
        if table_slots is None:
            table_slots = winner_table_slots(n, parts)
        # entries [2 n], overflow tables [4 n], partition counts, starts and
        # cursors [3 P] (int64); each lane's entry (int32) and entry flags
        wide = torch.empty(6 * n + 3 * parts, dtype=torch.int64, device=dev)
        narrow = torch.empty(4 * n_lanes + n, dtype=torch.uint8, device=dev)
        w0, b0 = wide.data_ptr(), narrow.data_ptr()
        status = lib.fpm_forward_winners_part(
            seen.data_ptr(), n_seen, keys.data_ptr(), parents.data_ptr(), n_lanes,
            parts.bit_length() - 1, table_slots, w0, w0 + 16 * n, w0 + 48 * n, b0,
            b0 + 4 * n_lanes, win.data_ptr(), stream,
        )
    elif route == "global-table":
        cap = table_capacity(n)
        t_keys = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        t_vals = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        status = lib.fpm_forward_winners(
            seen.data_ptr(), n_seen, keys.data_ptr(), parents.data_ptr(), n_lanes,
            t_keys.data_ptr(), t_vals.data_ptr(), cap, win.data_ptr(), stream,
        )
    else:
        raise ValueError(f"forward_winners: unknown route {route!r}")
    _build.check(status, f"forward_winners ({route})")
    _count_route(route)
    launches["forward_winners"] += 1
    return win
