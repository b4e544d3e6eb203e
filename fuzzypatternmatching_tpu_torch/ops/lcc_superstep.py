"""The kernels of the non-init LCC superstep, and their plain twins.

Counterpart of ``fuzzypatternmatching_tpu/ops/lcc_superstep.py``, whose
Pallas kernels wanted the lookup tables resident in VMEM. Here they are
hand-written CUDA kernels for Hopper (``csrc/lcc_superstep.cu``), built with
nvcc at first use (``ops/_build.py``):

  * ``alive_table`` (``pack_alive``): the packed alive words, plus a group
    summary with one bit per group of G slots, set where any flag of the
    group is set;
  * ``rev_alive_lookup``: the packed alive bit of each slot's reverse edge,
    read through the summary;
  * ``gather_accept_or``: tv-table gather, accept test against the row's
    pattern-adjacency mask, row OR and per-row send count, for one ELL
    bucket;
  * ``gather_accept_or_payload``: the multi-device superstep's counterpart,
    on payload tables that hold ``alive << 31 | tv`` per reverse-edge slot:
    ``sends_table`` (``pack_sends``) packs the words that send into an
    ``AliveTable``, and one gather over all of a shard's ELL buckets reads
    through it.
  * ``map_alive``: the compact route's cached closure's alive plane read
    off the full engine's plane through the closure's slot map, with the
    alive count, the vertices the alive slots touch and whether a live
    vertex is left untouched (no TPU kernel: the JAX driver does this on
    the host).

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain torch twin (``*_reference``), a CUDA tensor to the kernel. On the
card there is no fallback: a kernel that cannot be built or launched raises.
``launches`` counts the kernel launches of each wrapper.

Types: tv, the tv table and the row masks are int32 holding 16 bits (torch
on the CPU has no shifts or ``amax`` on uint32); the alive words and the
summary are int32 words whose bit pattern equals the JAX package's uint32
words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

launches = {
    "pack_alive": 0, "rev_alive_lookup": 0, "gather_accept_or": 0,
    "pack_sends": 0, "gather_accept_or_payload": 0, "map_alive": 0,
}

# The group summary must fit this many bytes of shared memory in the lookup
# kernel (csrc/lcc_superstep.cu, kMaxSummaryBytes).
SUMMARY_BUDGET_BYTES = 96 * 1024
# Buckets one payload gather takes (csrc/lcc_superstep.cu, kMaxBuckets).
MAX_BUCKETS = 32
INT32_MIN = -(1 << 31)  # bit 31 alone: an alive payload word with no candidates


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class AliveTable(NamedTuple):
    """What ``rev_alive_lookup`` reads: ``words`` int32 [ceil(n/32)], bit i
    of word j = flag 32 j + i; ``summary`` int32 [a multiple of 4, at least
    4], bit g set iff any flag of group g (flags g*G .. g*G + G - 1) is set,
    zero past the last group; ``group_log2`` = log2 G."""

    words: torch.Tensor
    summary: torch.Tensor
    group_log2: int


def summary_group_log2(n: int, budget: int = SUMMARY_BUDGET_BYTES) -> int:
    """log2 of the smallest power-of-two group size G >= 32 whose summary
    over ``n`` flags fits ``budget`` bytes."""
    if budget < 16:
        raise ValueError("summary budget below 16 bytes")
    g = 5
    while 4 * _summary_words(n, g) > budget:
        g += 1
    return g


def _summary_words(n: int, group_log2: int) -> int:
    """Summary length in words: one bit per group, padded to 16 bytes."""
    words = -(-n // (32 << group_log2))
    return max(4, -(-words // 4) * 4)


def _pack_bits(flags: torch.Tensor, n_words: int) -> torch.Tensor:
    """Bool [m] (m <= 32 n_words) -> int32 [n_words], LSB first."""
    a = torch.zeros(n_words * 32, dtype=torch.int64, device=flags.device)
    a[: flags.shape[0]] = flags
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    words = (a.view(-1, 32) << shifts).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32
    )


def alive_table_reference(
    alive: torch.Tensor, budget: int = SUMMARY_BUDGET_BYTES
) -> AliveTable:
    """Plain twin of :func:`alive_table`."""
    n = alive.shape[0]
    g = summary_group_log2(n, budget)
    groups = -(-n // (1 << g))
    flags = torch.zeros(groups << g, dtype=torch.bool, device=alive.device)
    flags[:n] = alive
    group_any = flags.view(groups, 1 << g).any(dim=1)
    return AliveTable(
        _pack_bits(alive, -(-n // 32)),
        _pack_bits(group_any, _summary_words(n, g)),
        g,
    )


def alive_table(
    alive: torch.Tensor, budget: int = SUMMARY_BUDGET_BYTES
) -> AliveTable:
    """The lookup table of a bool flag array [n]: packed words and group
    summary, in one pass over the flags. ``budget`` (at most
    ``SUMMARY_BUDGET_BYTES``) bounds the summary's size and so sets G."""
    if alive.dtype != torch.bool or alive.dim() != 1:
        raise ValueError("alive_table: alive must be a 1-D bool tensor")
    if not 16 <= budget <= SUMMARY_BUDGET_BYTES:
        raise ValueError(f"alive_table: budget must lie in 16..{SUMMARY_BUDGET_BYTES}")
    if _on_cpu("alive_table", alive):
        return alive_table_reference(alive, budget)
    return _pack_table("pack_alive", alive, budget)


def _pack_table(kernel: str, x: torch.Tensor, budget: int) -> AliveTable:
    """Launch ``kernel`` (``pack_alive`` or ``pack_sends``) over the n
    entries of ``x``: the packed words and the group summary of its flags."""
    from . import _build

    _check_cuda(kernel, x)
    n = x.shape[0]
    g = summary_group_log2(n, budget)
    n_words = -(-n // 32)
    words = torch.empty(n_words, dtype=torch.int32, device=x.device)
    summary = torch.empty(_summary_words(n, g), dtype=torch.int32, device=x.device)
    lib = _build.library("lcc_superstep")
    status = getattr(lib, f"fpm_{kernel}")(
        x.data_ptr(), n, words.data_ptr(), n_words, summary.data_ptr(),
        summary.shape[0], g, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, kernel)
    launches[kernel] += 1
    return AliveTable(words, summary, g)


def pack_alive(alive: torch.Tensor) -> torch.Tensor:
    """Bit-pack a bool flag array into int32 words, LSB first: bit i of
    word j is ``alive[32 j + i]`` (the JAX package's uint32 words, viewed as
    int32). The words of :func:`alive_table`."""
    return alive_table(alive).words


def row_or(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR along dim 1 of an int32 [n, w] tensor: a pairwise fold
    over the width, padded with zeros to a power of two."""
    n, w = x.shape
    wp = 1 << max(w - 1, 0).bit_length()
    if wp != w:
        x = torch.nn.functional.pad(x, (0, wp - w))
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] | x[:, h:]
    return x.reshape(n)


def _check_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def _on_cpu(what: str, t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def rev_alive_lookup_reference(rev: torch.Tensor, table: AliveTable) -> torch.Tensor:
    """Plain twin of :func:`rev_alive_lookup`: the word gather alone."""
    word = table.words[rev >> 5]
    return ((word >> (rev & 31)) & 1).bool()


def rev_alive_lookup(rev: torch.Tensor, table: AliveTable) -> torch.Tensor:
    """Alive flag of each slot's reverse edge: ``rev`` int32 slot indices
    (any shape; the engine passes all buckets as one flat tensor) into the
    flags of ``table`` -> bool of the same shape. Every index must be below
    the table's flag count; pad slots must index a zero flag."""
    if rev.dtype != torch.int32 or not isinstance(table, AliveTable):
        raise ValueError("rev_alive_lookup: needs int32 rev and an AliveTable")
    if _on_cpu("rev_alive_lookup", rev):
        return rev_alive_lookup_reference(rev, table)
    from . import _build

    _check_cuda("rev_alive_lookup", rev, table.words, table.summary)
    out = torch.empty(rev.shape, dtype=torch.bool, device=rev.device)
    if rev.numel() == 0:
        return out
    lib = _build.library("lcc_superstep")
    status = lib.fpm_rev_alive_lookup(
        rev.data_ptr(), table.words.data_ptr(), table.summary.data_ptr(),
        table.summary.shape[0], table.group_log2, out.data_ptr(), rev.numel(),
        torch.cuda.current_stream(rev.device).cuda_stream,
    )
    _build.check(status, "rev_alive_lookup")
    launches["rev_alive_lookup"] += 1
    return out


def gather_accept_or_reference(
    adj: torch.Tensor,
    alive_rev: torch.Tensor,
    adj_mask_rows: torch.Tensor,
    tv_table: torch.Tensor,
):
    """Plain twin of :func:`gather_accept_or`."""
    p = tv_table[adj]
    send_ok = (p != 0) & alive_rev
    p = torch.where(send_ok, p, 0)
    accept = (p & adj_mask_rows[:, None]) != 0
    tn = row_or(torch.where(accept, p, 0))
    return tn, accept, send_ok.sum(dim=1, dtype=torch.int32)


def gather_accept_or(
    adj: torch.Tensor,
    alive_rev: torch.Tensor,
    adj_mask_rows: torch.Tensor,
    tv_table: torch.Tensor,
):
    """Fused tv-gather + accept + row OR for one ELL bucket.

    adj [n, w] int32 (pad slots index tv_table's zero entry); alive_rev
    [n, w] bool; adj_mask_rows [n] int32 accept mask per row; tv_table
    [V + 1] int32 with ``tv_table[V] == 0``. Returns (tn [n] int32,
    accept [n, w] bool, sendok [n] int32)."""
    if (
        adj.dtype != torch.int32
        or alive_rev.dtype != torch.bool
        or adj_mask_rows.dtype != torch.int32
        or tv_table.dtype != torch.int32
    ):
        raise ValueError(
            "gather_accept_or: expects int32 adj, bool alive_rev, int32 "
            "adj_mask_rows and int32 tv_table"
        )
    n, w = adj.shape
    if alive_rev.shape != adj.shape or adj_mask_rows.shape != (n,):
        raise ValueError("gather_accept_or: shapes of adj, alive_rev, mask differ")
    if _on_cpu("gather_accept_or", adj):
        return gather_accept_or_reference(adj, alive_rev, adj_mask_rows, tv_table)
    from . import _build

    _check_cuda("gather_accept_or", adj, alive_rev, adj_mask_rows, tv_table)
    dev = adj.device
    tn = torch.empty(n, dtype=torch.int32, device=dev)
    accept = torch.empty((n, w), dtype=torch.bool, device=dev)
    sendok = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return tn, accept, sendok
    lib = _build.library("lcc_superstep")
    status = lib.fpm_gather_accept_or(
        adj.data_ptr(), alive_rev.data_ptr(), adj_mask_rows.data_ptr(),
        tv_table.data_ptr(), tn.data_ptr(), accept.data_ptr(),
        sendok.data_ptr(), n, w, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "gather_accept_or")
    launches["gather_accept_or"] += 1
    return tn, accept, sendok


# -- the multi-device superstep's gather, on payload words -------------------


def sends_table_reference(
    payload: torch.Tensor, budget: int = SUMMARY_BUDGET_BYTES
) -> AliveTable:
    """Plain twin of :func:`sends_table`."""
    return alive_table_reference((payload < 0) & (payload != INT32_MIN), budget)


def sends_table(payload: torch.Tensor, budget: int = SUMMARY_BUDGET_BYTES) -> AliveTable:
    """The sends table of a payload table, int32 words ``alive << 31 | tv``:
    the :class:`AliveTable` of the flags "word i sends" (bit 31 set and
    nonzero low bits: ``w < 0 and w != INT_MIN``), in one pass over the
    words. It gates the gather of :func:`gather_accept_or_payload`."""
    if payload.dtype != torch.int32 or payload.dim() != 1:
        raise ValueError("sends_table: payload must be a 1-D int32 tensor")
    if not 16 <= budget <= SUMMARY_BUDGET_BYTES:
        raise ValueError(f"sends_table: budget must lie in 16..{SUMMARY_BUDGET_BYTES}")
    if _on_cpu("sends_table", payload):
        return sends_table_reference(payload, budget)
    return _pack_table("pack_sends", payload, budget)


def _payload_bucket_reference(adj, adj_mask_rows, payload):
    """One bucket [n, w] of the JAX mesh superstep's formula
    (fuzzypatternmatching_tpu/parallel/sharded.py:900-941). Bit 31 of an
    int32 word is its sign bit: the alive test ``p_raw >= 0x80000000`` of
    the uint32 words is ``p_raw < 0``."""
    p_raw = payload[adj]
    p = p_raw & 0x7FFFFFFF
    send_ok = (p != 0) & (p_raw < 0)
    p = torch.where(send_ok, p, 0)
    accept = (p & adj_mask_rows[:, None]) != 0
    tn = row_or(torch.where(accept, p, 0))
    return tn, accept, send_ok.sum(dim=1, dtype=torch.int32)


def _bucket_totals(what, revmap, masks, buckets):
    """Check the bucket table against the planes."""
    if not 1 <= len(buckets) <= MAX_BUCKETS:
        raise ValueError(f"{what}: 1..{MAX_BUCKETS} buckets, got {len(buckets)}")
    if any(w < 1 or nb < 0 for w, nb in buckets):
        raise ValueError(f"{what}: bucket widths must be positive and rows not negative")
    slots = sum(w * nb for w, nb in buckets)
    rows = sum(nb for _, nb in buckets)
    if revmap.shape != (slots,) or masks.shape != (rows,):
        raise ValueError(
            f"{what}: revmap [{slots}] and masks [{rows}] expected for the buckets, "
            f"got {tuple(revmap.shape)} and {tuple(masks.shape)}"
        )
    return slots, rows


def gather_accept_or_payload_reference(
    revmap: torch.Tensor, masks: torch.Tensor, payload: torch.Tensor, buckets
):
    """Plain twin of :func:`gather_accept_or_payload`: the per-bucket
    formula, bucket by bucket, the results concatenated."""
    tns, accepts, counts = [], [], []
    slot = row = 0
    for w, nb in buckets:
        tn, accept, sendok = _payload_bucket_reference(
            revmap[slot : slot + nb * w].view(nb, w), masks[row : row + nb], payload
        )
        tns.append(tn)
        accepts.append(accept.reshape(-1))
        counts.append(sendok)
        slot += nb * w
        row += nb
    return torch.cat(tns), torch.cat(accepts), torch.cat(counts)


def _check_sends(payload: torch.Tensor, sends) -> None:
    """``sends`` must be an :class:`AliveTable` of ``payload``'s length:
    the kernel indexes its words and its summary by payload index."""
    if not isinstance(sends, AliveTable):
        raise ValueError("gather_accept_or_payload: sends must be the payload's sends_table")
    n = payload.numel()
    g = sends.group_log2
    if (
        sends.words.dtype != torch.int32
        or sends.summary.dtype != torch.int32
        or sends.words.shape != (-(-n // 32),)
        or not 5 <= g <= 30
        or sends.summary.shape != (_summary_words(n, g),)
        or 4 * sends.summary.numel() > SUMMARY_BUDGET_BYTES
    ):
        raise ValueError(
            f"gather_accept_or_payload: sends (words {tuple(sends.words.shape)}, summary "
            f"{tuple(sends.summary.shape)}, G 2^{g}) is not a sends_table of {n} words"
        )


def gather_accept_or_payload(
    revmap: torch.Tensor,
    masks: torch.Tensor,
    payload: torch.Tensor,
    buckets,
    sends: AliveTable | None = None,
):
    """Payload gather + accept + row OR over all ELL buckets of a shard: the
    multi-device superstep's counterpart of :func:`gather_accept_or`. On the
    card it is two launches, :func:`sends_table` over ``payload`` and one
    gather over every bucket through it.

    ``buckets``: (width, rows) per bucket, in slot order. ``revmap`` int32
    [S], the buckets' [rows, width] planes one after the other (S = the sum
    of rows x width): each slot's index into ``payload``, int32 words
    ``alive << 31 | tv`` (pad slots index a zero word); ``masks`` int32
    [rows of all buckets]: the accept mask of each row. ``sends``, where
    given, is ``sends_table(payload)`` already made, and the pack is not
    run again. A slot sends where its word has bit 31 and nonzero low bits,
    with p the low bits. Returns (tn [rows] int32, accept [S] bool, sendok
    [rows] int32)."""
    if revmap.dtype != torch.int32 or masks.dtype != torch.int32 or payload.dtype != torch.int32:
        raise ValueError("gather_accept_or_payload: expects int32 revmap, masks and payload")
    if payload.dim() != 1:
        raise ValueError("gather_accept_or_payload: payload must be 1-D")
    if sends is not None:
        _check_sends(payload, sends)
    slots, rows = _bucket_totals("gather_accept_or_payload", revmap, masks, buckets)
    if _on_cpu("gather_accept_or_payload", revmap):
        return gather_accept_or_payload_reference(revmap, masks, payload, buckets)
    from . import _build

    if sends is None:
        sends = sends_table(payload)
    _check_cuda(
        "gather_accept_or_payload", revmap, masks, payload, sends.words, sends.summary
    )
    dev = revmap.device
    tn = torch.empty(rows, dtype=torch.int32, device=dev)
    accept = torch.empty(slots, dtype=torch.bool, device=dev)
    sendok = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows == 0:
        return tn, accept, sendok
    table = np.ascontiguousarray(buckets, dtype=np.int64)
    lib = _build.library("lcc_superstep")
    status = lib.fpm_gather_payload(
        revmap.data_ptr(), masks.data_ptr(), payload.data_ptr(), sends.words.data_ptr(),
        sends.summary.data_ptr(), sends.summary.shape[0], sends.group_log2,
        tn.data_ptr(), accept.data_ptr(), sendok.data_ptr(), table.ctypes.data,
        len(buckets), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "gather_accept_or_payload")
    launches["gather_accept_or_payload"] += 1
    return tn, accept, sendok


# -- the compact route's first LCC phase -------------------------------------


def map_alive_reference(
    alive: torch.Tensor, sub2full: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
    tv: torch.Tensor,
):
    """Plain twin of :func:`map_alive`."""
    out = alive[sub2full]
    touched = torch.zeros(tv.shape[0], dtype=torch.bool, device=alive.device)
    touched[row[out]] = True
    touched[col[out]] = True
    lone = ((tv != 0) & ~touched).any()
    return out, touched, torch.stack([out.sum(dtype=torch.int64), lone.to(torch.int64)])


def map_alive(
    alive: torch.Tensor, sub2full: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
    tv: torch.Tensor,
):
    """A plane of flags read through a slot map, and the vertices its set
    flags touch: ``alive`` bool [S + 1], the full engine's alive plane;
    ``sub2full`` int32 [n], each closure slot's full-engine slot (below
    S + 1); ``row`` and ``col`` int32 [n], each closure slot's row and
    column vertex (below V wherever the slot maps to an alive one); ``tv``
    int32 [V]. Returns, on the device and read nothing back: out bool [n] =
    ``alive[sub2full]``; touched bool [V], the rows and columns of the slots
    ``out`` holds alive; stats int64 [2], the alive slots of ``out`` and 1
    where a vertex with ``tv != 0`` is not touched (else 0)."""
    if alive.dtype != torch.bool or alive.dim() != 1:
        raise ValueError("map_alive: alive must be a 1-D bool tensor")
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in (sub2full, row, col, tv)):
        raise ValueError("map_alive: sub2full, row, col and tv must be 1-D int32 tensors")
    if not sub2full.shape == row.shape == col.shape:
        raise ValueError("map_alive: sub2full, row and col differ in length")
    if tv.numel() == 0:
        raise ValueError("map_alive: tv is empty")
    if _on_cpu("map_alive", alive):
        return map_alive_reference(alive, sub2full, row, col, tv)
    from . import _build

    _check_cuda("map_alive", alive, sub2full, row, col, tv)
    dev = alive.device
    n = sub2full.numel()
    out = torch.empty(n, dtype=torch.bool, device=dev)
    touched = torch.zeros(tv.numel(), dtype=torch.bool, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = _build.library("lcc_superstep")
    status = lib.fpm_map_alive(
        alive.data_ptr(), sub2full.data_ptr(), row.data_ptr(), col.data_ptr(), n,
        tv.data_ptr(), tv.numel(), out.data_ptr(), touched.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "map_alive")
    launches["map_alive"] += 1
    return out, touched, stats
