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
    bucket.

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

import torch

launches = {"pack_alive": 0, "rev_alive_lookup": 0, "gather_accept_or": 0}

# The group summary must fit this many bytes of shared memory in the lookup
# kernel (csrc/lcc_superstep.cu, kMaxSummaryBytes).
SUMMARY_BUDGET_BYTES = 96 * 1024


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
    from . import _build

    _check_cuda("alive_table", alive)
    n = alive.shape[0]
    g = summary_group_log2(n, budget)
    n_words = -(-n // 32)
    words = torch.empty(n_words, dtype=torch.int32, device=alive.device)
    summary = torch.empty(_summary_words(n, g), dtype=torch.int32, device=alive.device)
    lib = _build.library("lcc_superstep")
    status = lib.fpm_pack_alive(
        alive.data_ptr(), n, words.data_ptr(), n_words, summary.data_ptr(),
        summary.shape[0], g, torch.cuda.current_stream(alive.device).cuda_stream,
    )
    _build.check(status, "pack_alive")
    launches["pack_alive"] += 1
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
