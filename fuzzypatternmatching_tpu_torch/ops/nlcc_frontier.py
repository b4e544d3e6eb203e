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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lcc_superstep import _check_cuda, _on_cpu

launches = {"expand_frontier": 0, "forward_winners": 0}

# Lanes of the flattened expansion per warp in the kernel
# (csrc/nlcc_frontier.cu, kChunk).
EXPAND_CHUNK = 256
# Highest arrival bit a hop may test (bit 31 is the cycle map-key bit).
MAX_HOP_BIT = 30


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    from . import _build

    _check_cuda("expand_frontier", ptr, col, cur, parent, ok_bits)
    dev = cur.device
    n_tok = cur.shape[0]
    msg_r = torch.zeros(num_ranks, dtype=torch.int64, device=dev)
    c = cur.long()
    lane_end = torch.cumsum(ptr[c + 1] - ptr[c], 0)
    if sizes is not None:
        lanes = sizes[0]
    else:
        lanes = int(lane_end[-1]) if n_tok else 0
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    if lanes == 0:
        return Expansion(empty, empty, msg_r, 0)
    n_chunks = -(-lanes // EXPAND_CHUNK)
    counts = torch.empty(n_chunks, dtype=torch.int32, device=dev)
    lib = _build.library("nlcc_frontier")
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        ptr.data_ptr(), col.data_ptr(), cur.data_ptr(), parent.data_ptr(),
        lane_end.data_ptr(), n_tok, lanes, ok_bits.data_ptr(), h_next,
        num_ranks, int(drop_parent_return),
    )
    status = lib.fpm_expand_count(*args, counts.data_ptr(), msg_r.data_ptr(), stream)
    _build.check(status, "expand_frontier (count)")
    launches["expand_frontier"] += 1
    ends = torch.cumsum(counts, 0)
    kept = sizes[1] if sizes is not None else int(ends[-1])
    if kept == 0:
        return Expansion(empty, empty, msg_r, lanes)
    starts = ends - counts
    tok = torch.empty(kept, dtype=torch.int32, device=dev)
    nbr = torch.empty(kept, dtype=torch.int32, device=dev)
    status = lib.fpm_expand_write(
        *args, counts.data_ptr(), starts.data_ptr(), tok.data_ptr(),
        nbr.data_ptr(), stream,
    )
    _build.check(status, "expand_frontier (write)")
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
    """Hash-table slots for ``n`` keys: a power of two, at least 2 n."""
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
    from . import _build

    _check_cuda("forward_winners", keys, parents, seen)
    dev = keys.device
    n_lanes, n_seen = keys.shape[0], seen.shape[0]
    win = torch.empty(n_lanes, dtype=torch.bool, device=dev)
    if n_lanes == 0:
        return win
    cap = table_capacity(n_seen + n_lanes)
    t_keys = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    t_vals = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    lib = _build.library("nlcc_frontier")
    status = lib.fpm_forward_winners(
        seen.data_ptr(), n_seen, keys.data_ptr(), parents.data_ptr(), n_lanes,
        t_keys.data_ptr(), t_vals.data_ptr(), cap, win.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "forward_winners")
    launches["forward_winners"] += 1
    return win
