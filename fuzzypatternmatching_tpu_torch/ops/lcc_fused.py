"""The bucketed LCC superstep of the default mode, fused: K1 and K2.

The JAX package runs a whole LCC call as one jitted program
(``fuzzypatternmatching_tpu/engine/lcc_bucketed.py`` ``_call_impl``
:813-874, ``_call_init1_seg`` :782-811), and XLA fuses each superstep's
per-bucket arithmetic (``_superstep`` :529-767). Here that arithmetic is
two hand-written CUDA kernels for Hopper (``csrc/lcc_fused.cu``), each one
launch a superstep over every bucket:

  * ``init_superstep`` (K1): the global init superstep. Each slot's
    candidates come from its neighbour's label code; accept test against
    the row's pattern-adjacency mask, OR along the row and over a split
    hub's rows (K3, ``_segment_or`` :520), keep mask, the init gate, the
    alive update and the per-rank counters;
  * ``continuation_superstep`` (K2): a later superstep. The tv gather of
    ``gather_accept_or`` gated by the reverse edge's alive bit (the
    ``alive_rev`` plane of ``rev_alive_lookup``), then the same epilogue
    with the continuation's rules.

Both also run under the counting rule (the JAX package's ``_superstep``
:671-700), where the planes carry each slot's sender class (``cls``) and
the template its requirement table (``required``): candidate i keeps its
bit only if it heard ``required[i, j]`` accepted senders of each label
class j. With both present the wrappers launch the kernels' counting
instantiations, still one launch a superstep, and count a
``lcc_count_fused`` (``utils/trace.py``); the twin counts its per-bucket
class-count reductions as ``lcc_count_passes``.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the plain torch twin (``*_reference``, the per-bucket code the engine ran
before), a CUDA tensor to the kernel, with no fallback: a kernel that
cannot be built or launched raises. ``launches`` counts the kernel
launches of each wrapper.

The engine hands both its planes in one :class:`SuperstepPlanes`: flat
tensors over all buckets (each bucket's ``[n, w]`` plane a view of them)
and a table with one row ``(n, w, slot_base, seg_base, split)`` per
bucket. Types: tv is int32 holding 16 bits; alive, the token-passing flags
and ``alive_rev`` are bool; stats are int64 ``[av per rank | ae per rank |
msg per rank | died]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
from .lcc_superstep import _check_cuda, _on_cpu, gather_accept_or_reference, row_or

MAX_TEMPLATE_VERTICES = 16  # tv and the kernels' tables hold 16 bits
# Counting: label classes the kernels take, and the largest requirement
# (the largest template degree).
MAX_CLASSES = 16
MAX_REQUIRED = 15
# Buckets one launch takes (csrc/lcc_fused.cu, kMaxBuckets).
MAX_BUCKETS = 32
# Columns of SuperstepPlanes.table.
N, W, SLOT_BASE, SEG_BASE, SPLIT = range(5)

launches = {"init_superstep": 0, "continuation_superstep": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def or_over_bits(tv: torch.Tensor, adj_all) -> torch.Tensor:
    """OR of the pattern adjacency sets ``adj_all[i]`` over each candidate
    bit i of ``tv``: the mask an incoming message must meet."""
    m = torch.zeros_like(tv)
    for i, bits in enumerate(adj_all):
        m = m | (((tv >> i) & 1) * bits)
    return m


def keep_mask_per_i(tn_list: list, mand, opt, opt_min):
    """Acceptance of each template vertex i against its own tn
    (``tn_list[i]``: metadata mode hears per receiver bit, the default mode
    passes one tn for every bit), packed into a keep mask: the mandatory
    neighbour classes all heard, and the optional ones heard together with
    at least ``opt_min[i]`` of them (the fuzzy rule)."""
    keep = torch.zeros_like(tn_list[0])
    for i, tn in enumerate(tn_list):
        ok = (mand[i] & ~tn) == 0
        if opt_min[i] > 0:
            t = opt[i] & tn
            count = torch.zeros_like(t)
            for bit in range(MAX_TEMPLATE_VERTICES):
                count = count + ((t >> bit) & 1)
            ok = ok & (t == opt[i]) & (count >= opt_min[i])
        keep = keep | (ok.to(torch.int32) << i)
    return keep


def count_mask(acc: list, cls: torch.Tensor, required, seg_id: torch.Tensor, n_seg: int):
    """Counting mode: bit i set where candidate i heard at least
    ``required[i, j]`` accepted senders of each label class j.
    ``acc[i]`` is the bool [n, w] plane of slots accepted toward i and
    ``cls`` the [n, w] senders' classes (1..L, 0 none); counts are row
    sums, summed per segment for split hubs: one reduction (a
    ``lcc_count_passes``) per (i, j) with a requirement."""
    required = np.asarray(required)
    split = n_seg != cls.shape[0]
    trace.count("lcc_count_passes", int((required > 0).sum()))
    keep = torch.zeros(n_seg, dtype=torch.int32, device=cls.device)
    of_class = {j: cls == j + 1 for j in np.nonzero(required.any(axis=0))[0]}
    for i in range(required.shape[0]):
        ok = torch.ones(n_seg, dtype=torch.bool, device=cls.device)
        for j in range(required.shape[1]):
            req = int(required[i, j])
            if req <= 0:
                continue
            cnt = (acc[i] & of_class[j]).sum(dim=1)
            if split:
                cnt = torch.zeros(
                    n_seg, dtype=cnt.dtype, device=cnt.device
                ).index_add_(0, seg_id, cnt)
            ok = ok & (cnt >= req)
        keep = keep | (ok.to(torch.int32) << i)
    return keep


def segment_or(values: torch.Tensor, seg_id: torch.Tensor, n_seg: int):
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


class Template(NamedTuple):
    """The pattern's constants, one entry per template vertex (k <= 16):
    its adjacency set, mandatory and optional neighbour sets and the least
    number of optional neighbours it must hear. Counting:
    ``required[i][j]``, the accepted senders of label class j + 1 that
    vertex i must hear (a row per vertex, at most 16 classes, each 0..15);
    None in the default mode."""

    adj_all: tuple
    mand: tuple
    opt: tuple
    opt_min: tuple
    required: tuple | None = None


class SuperstepPlanes(NamedTuple):
    """What both supersteps read of the engine's layout.

    ``table`` int64 ``[buckets, 5]``: ``(n, w, slot_base, seg_base,
    split)`` per bucket in slot order, n rows of width w from flat slot
    ``slot_base``, its segments from ``seg_base`` of the segment planes,
    ``split`` 1 where the bucket has fewer segments than rows (split hubs,
    whose rows are consecutive). The flat planes: ``adj`` int32 [S] (pad slots hold V), ``code`` uint8 or
    int32 [S] (the label code of each slot's neighbour, 0 for padding),
    ``code_tv`` int32 (code -> candidate set, entry 0 zero), ``seg_id``
    int64 [rows] (row -> segment of its bucket), ``seg_rows`` int64
    [segments] (segment -> vertex), ``seg_start`` int64 (for each split
    bucket in order, the first row of each of its segments and then n),
    ``own_rows`` / ``own_seg`` int64 (output rank of each row / segment).
    Counting: ``cls`` uint8 [S], the label class of each slot's sender (1..L,
    0 none and for padding); None in the default mode.
    """

    table: np.ndarray
    adj: torch.Tensor
    code: torch.Tensor
    code_tv: torch.Tensor
    seg_id: torch.Tensor
    seg_rows: torch.Tensor
    seg_start: torch.Tensor
    own_rows: torch.Tensor
    own_seg: torch.Tensor
    num_vertices: int
    num_ranks: int
    cls: torch.Tensor | None = None

    @property
    def num_slots(self) -> int:
        return int(self.adj.shape[0])


class _BucketViews(NamedTuple):
    n: int
    w: int
    lo: int  # first flat slot
    adj: torch.Tensor  # [n, w]
    code: torch.Tensor  # [n, w]
    seg_id: torch.Tensor  # [n]
    seg_rows: torch.Tensor  # [n_seg]
    own_rows: torch.Tensor  # [n]
    own_seg: torch.Tensor  # [n_seg]
    cls: torch.Tensor | None  # [n, w], counting


def bucket_views(planes: SuperstepPlanes):
    """Each bucket's planes, as views of the flat ones."""
    table = planes.table
    n_segs = np.diff(np.append(table[:, SEG_BASE], planes.seg_rows.shape[0]))
    row = 0
    for (n, w, lo, seg_base, _), n_seg in zip(table.tolist(), n_segs.tolist()):
        hi, seg_hi = lo + n * w, seg_base + n_seg
        yield _BucketViews(
            n, w, lo,
            planes.adj[lo:hi].view(n, w), planes.code[lo:hi].view(n, w),
            planes.seg_id[row : row + n], planes.seg_rows[seg_base:seg_hi],
            planes.own_rows[row : row + n], planes.own_seg[seg_base:seg_hi],
            None if planes.cls is None else planes.cls[lo:hi].view(n, w),
        )
        row += n


def build_planes(
    widths, rows, seg_id, seg_rows, adj, code, code_tv, num_vertices: int,
    num_ranks: int, device, cls=None,
) -> SuperstepPlanes:
    """The planes of an engine's buckets, from its host arrays: per bucket
    its width, its rows' vertex ids [n], segment ids [n], segment vertices
    [n_seg], neighbour ids [n, w], label codes [n, w] and, counting, sender
    classes [n, w] (``cls``), in slot order.
    A bucket with fewer segments than rows splits hubs over consecutive
    rows (``split``); the segments of every bucket are checked to be
    non-empty runs of consecutive rows, numbered in row order."""
    table, starts = [], []
    slot = seg = 0
    for w, r, sid, sv in zip(widths, rows, seg_id, seg_rows):
        n, n_seg = len(r), len(sv)
        runs = np.bincount(sid, minlength=n_seg) if n else np.zeros(n_seg, np.int64)
        if (n and (np.any(np.diff(sid) < 0) or sid[-1] >= n_seg)) or np.any(runs == 0):
            raise ValueError("build_planes: segments must be runs of rows in order")
        split = int(n_seg != n)
        if split:
            starts.append(np.concatenate([[0], np.cumsum(runs)]))
        table.append((n, w, slot, seg, split))
        slot += n * w
        seg += n_seg
    dev = torch.device(device)

    def flat(parts, dtype):
        parts = [np.asarray(p, dtype=dtype).reshape(-1) for p in parts]
        return torch.from_numpy(np.concatenate(parts + [np.empty(0, dtype)])).to(dev)

    seg_rows_t = flat(seg_rows, np.int64)
    rows_t = flat(rows, np.int64)
    return SuperstepPlanes(
        table=np.asarray(table, dtype=np.int64).reshape(-1, 5),
        adj=flat(adj, np.int32),
        code=flat(code, code[0].dtype if len(code) else np.uint8),
        code_tv=torch.from_numpy(np.asarray(code_tv, dtype=np.int32)).to(dev),
        seg_id=flat(seg_id, np.int64),
        seg_rows=seg_rows_t,
        seg_start=flat(starts, np.int64),
        own_rows=rows_t % num_ranks,
        own_seg=seg_rows_t % num_ranks,
        num_vertices=int(num_vertices),
        num_ranks=int(num_ranks),
        cls=None if cls is None else flat(cls, np.uint8),
    )


# -- the plain twins -----------------------------------------------------------


def _superstep_reference(planes, tv, tmpl, *, init, alive=None, tp_flag=None,
                         alive_rev=None):
    """The superstep bucket by bucket in plain torch: the arithmetic of
    ``_superstep`` (the JAX package's ``:529-767``), with its counting rule
    (``:671-700``) where the planes carry ``cls``."""
    dev = tv.device
    r = planes.num_ranks
    k = len(tmpl.adj_all)
    av = torch.zeros(r, dtype=torch.int64, device=dev)
    ae = torch.zeros(r, dtype=torch.int64, device=dev)
    msg = torch.zeros(r, dtype=torch.int64, device=dev)
    died = torch.zeros((), dtype=torch.bool, device=dev)
    new_tv = torch.zeros(planes.num_vertices, dtype=torch.int32, device=dev)
    new_alive = torch.zeros(planes.num_slots + 1, dtype=torch.bool, device=dev)
    if not init:
        tv_table = torch.cat([tv, tv.new_zeros(1)])

    for d in bucket_views(planes):
        n, w = d.n, d.w
        n_seg = d.seg_rows.shape[0]
        lo, hi = d.lo, d.lo + n * w
        tv_seg = tv[d.seg_rows]
        adj_mask_rows = or_over_bits(tv_seg, tmpl.adj_all)[d.seg_id]
        if init:
            # tv == label_tv: the neighbour's candidates from its label
            p = planes.code_tv[d.code.to(torch.int32)]
            sendok_rows = (p != 0).sum(dim=1, dtype=torch.int32)
            accept = (p & adj_mask_rows[:, None]) != 0
            pa = torch.where(accept, p, 0)
            tn_rows = row_or(pa)
        else:
            tn_rows, accept, sendok_rows = gather_accept_or_reference(
                d.adj, alive_rev[lo:hi].view(n, w), adj_mask_rows, tv_table
            )
            if d.cls is not None:
                pa = torch.where(accept, tv_table[d.adj], 0)
        tn = segment_or(tn_rows, d.seg_id, n_seg) if n_seg != n else tn_rows
        new_tv_seg = tv_seg & keep_mask_per_i([tn] * k, tmpl.mand, tmpl.opt, tmpl.opt_min)
        if d.cls is not None:
            acc = [(pa & tmpl.adj_all[i]) != 0 for i in range(k)]
            new_tv_seg = new_tv_seg & count_mask(acc, d.cls, tmpl.required, d.seg_id, n_seg)
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


def init_superstep_reference(planes: SuperstepPlanes, label_tv: torch.Tensor,
                             tmpl: Template):
    """Plain twin of :func:`init_superstep`."""
    return _superstep_reference(planes, label_tv, tmpl, init=True)


def continuation_superstep_reference(
    planes: SuperstepPlanes, tv: torch.Tensor, alive: torch.Tensor,
    tp_flag: torch.Tensor, alive_rev: torch.Tensor, tmpl: Template,
):
    """Plain twin of :func:`continuation_superstep`."""
    return _superstep_reference(
        planes, tv, tmpl, init=False, alive=alive, tp_flag=tp_flag, alive_rev=alive_rev
    )


# -- the wrappers ----------------------------------------------------------------


def _check(what, planes, tmpl, tv, flags=()):
    """Argument checks shared by both wrappers."""
    if not isinstance(planes, SuperstepPlanes) or not isinstance(tmpl, Template):
        raise ValueError(f"{what}: needs SuperstepPlanes and a Template")
    k = len(tmpl.adj_all)
    if not 1 <= k <= MAX_TEMPLATE_VERTICES or any(
        len(x) != k for x in (tmpl.mand, tmpl.opt, tmpl.opt_min)
    ):
        raise ValueError(f"{what}: a template of 1..{MAX_TEMPLATE_VERTICES} vertices")
    table = planes.table
    if table.dtype != np.int64 or table.ndim != 2 or table.shape[1] != 5:
        raise ValueError(f"{what}: the bucket table is int64 [buckets, 5]")
    if len(table) > MAX_BUCKETS:
        raise ValueError(f"{what}: at most {MAX_BUCKETS} buckets, got {len(table)}")
    n, w = table[:, N], table[:, W]
    if len(table) and (np.any(n < 0) or np.any(w < 1)):
        raise ValueError(f"{what}: bucket rows must not be negative, widths positive")
    slots = int((n * w).sum())
    if not np.array_equal(table[:, SLOT_BASE], np.cumsum(n * w) - n * w):
        raise ValueError(f"{what}: slot bases must follow the buckets in order")
    if planes.adj.dtype != torch.int32 or planes.adj.shape != (slots,):
        raise ValueError(f"{what}: adj must be int32 [{slots}]")
    if planes.code.dtype not in (torch.uint8, torch.int32) or planes.code.shape != (slots,):
        raise ValueError(f"{what}: code must be uint8 or int32 [{slots}]")
    n_seg = np.diff(np.append(table[:, SEG_BASE], planes.seg_rows.shape[0]))
    split = table[:, SPLIT] != 0
    if len(table) and (
        table[0, SEG_BASE] != 0 or np.any(n_seg < 0) or np.any(n_seg[~split] != n[~split])
    ):
        raise ValueError(f"{what}: segment bases do not fit the bucket table")
    n_starts = int((n_seg[split] + 1).sum())
    if planes.seg_start.shape != (n_starts,) or planes.seg_id.shape != (int(n.sum()),):
        raise ValueError(f"{what}: seg_start and seg_id do not fit the bucket table")
    if planes.own_seg.shape != planes.seg_rows.shape or planes.code_tv.dtype != torch.int32:
        raise ValueError(f"{what}: own_seg must match seg_rows and code_tv be int32")
    if planes.num_ranks < 1:
        raise ValueError(f"{what}: num_ranks must be at least 1")
    if tv.dtype != torch.int32 or tv.shape != (planes.num_vertices,):
        raise ValueError(f"{what}: tv must be int32 [{planes.num_vertices}]")
    if (planes.cls is None) != (tmpl.required is None):
        raise ValueError(f"{what}: the counting rule needs both cls and required")
    if planes.cls is not None:
        if planes.cls.dtype != torch.uint8 or planes.cls.shape != (slots,):
            raise ValueError(f"{what}: cls must be uint8 [{slots}]")
        req = np.asarray(tmpl.required)
        if (req.ndim != 2 or req.shape[0] != k or req.shape[1] > MAX_CLASSES
                or np.any(req < 0) or np.any(req > MAX_REQUIRED)):
            raise ValueError(
                f"{what}: required must be [{k}, at most {MAX_CLASSES}] of 0..{MAX_REQUIRED}"
            )
    for name, t, size in flags:
        if t.dtype != torch.bool or t.shape != (size,):
            raise ValueError(f"{what}: {name} must be bool [{size}]")


def init_superstep(planes: SuperstepPlanes, label_tv: torch.Tensor, tmpl: Template):
    """The global init superstep over every bucket (K1). ``label_tv``
    int32 [V]: each vertex's candidates from its label, the tv at init.
    Returns (new_tv int32 [V] (zero where no segment writes), new_alive
    bool [S+1] (pad slot S False), the cleared tp_flag bool [S+1], stats
    int64 [3 num_ranks + 1])."""
    _check("init_superstep", planes, tmpl, label_tv)
    if _on_cpu("init_superstep", label_tv):
        return init_superstep_reference(planes, label_tv, tmpl)
    return _launch("init_superstep", planes, tmpl, label_tv)


def continuation_superstep(
    planes: SuperstepPlanes, tv: torch.Tensor, alive: torch.Tensor,
    tp_flag: torch.Tensor, alive_rev: torch.Tensor, tmpl: Template,
):
    """A non-init superstep over every bucket (K2): tv int32 [V], alive and
    tp_flag bool [S+1], ``alive_rev`` bool [S] (``rev_alive_lookup`` over
    the engine's flat ``rev``). Returns what :func:`init_superstep`
    returns."""
    s = planes.num_slots
    _check("continuation_superstep", planes, tmpl, tv,
           (("alive", alive, s + 1), ("tp_flag", tp_flag, s + 1), ("alive_rev", alive_rev, s)))
    if _on_cpu("continuation_superstep", tv):
        return continuation_superstep_reference(planes, tv, alive, tp_flag, alive_rev, tmpl)
    return _launch("continuation_superstep", planes, tmpl, tv, alive, tp_flag, alive_rev)


def _template_words(tmpl: Template) -> np.ndarray:
    """k, then adj_all, mand, opt and opt_min padded to 16 entries each,
    and with a counting rule ``required`` padded to 16 x 16: the layout the
    C entry points read."""
    k, n = len(tmpl.adj_all), 1 + 4 * MAX_TEMPLATE_VERTICES
    counting = tmpl.required is not None
    words = np.zeros(n + (MAX_TEMPLATE_VERTICES * MAX_CLASSES if counting else 0), dtype=np.int64)
    words[0] = k
    for j, xs in enumerate((tmpl.adj_all, tmpl.mand, tmpl.opt, tmpl.opt_min)):
        words[1 + j * MAX_TEMPLATE_VERTICES : 1 + j * MAX_TEMPLATE_VERTICES + len(xs)] = xs
    if counting:
        req = np.asarray(tmpl.required, dtype=np.int64)
        table = words[n:].reshape(MAX_TEMPLATE_VERTICES, MAX_CLASSES)
        table[:k, : req.shape[1]] = req
    return words


def _launch(kernel, planes, tmpl, tv, alive=None, tp_flag=None, alive_rev=None):
    from . import _build

    init = kernel == "init_superstep"
    counting = planes.cls is not None
    flags = () if init else (alive, tp_flag, alive_rev)
    tensors = [planes.adj, planes.code, planes.code_tv, planes.seg_rows,
               planes.seg_start, planes.own_seg, tv, *flags]
    if counting:
        tensors.append(planes.cls)
    _check_cuda(kernel, *tensors)
    dev = tv.device
    s, r = planes.num_slots, planes.num_ranks
    new_tv = torch.zeros(planes.num_vertices, dtype=torch.int32, device=dev)
    flag_out = torch.zeros(s + 1, dtype=torch.bool, device=dev)
    stats = torch.zeros(3 * r + 1, dtype=torch.int64, device=dev)
    table = np.ascontiguousarray(planes.table)
    if not len(table) or not int(table[:, N].sum()):
        return new_tv, torch.zeros(s + 1, dtype=torch.bool, device=dev), flag_out, stats
    new_alive = torch.empty(s + 1, dtype=torch.bool, device=dev)  # every slot written
    words = _template_words(tmpl)
    lib = _build.library("lcc_fused")
    common = (
        table.ctypes.data, len(table), planes.seg_rows.shape[0],
        planes.seg_rows.data_ptr(), planes.seg_start.data_ptr(), planes.own_seg.data_ptr(),
        tv.data_ptr(), planes.num_vertices, words.ctypes.data, r,
        new_tv.data_ptr(), new_alive.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    cls = (planes.cls.data_ptr(),) if counting else ()
    if init:
        entry = lib.fpm_init_superstep_counting if counting else lib.fpm_init_superstep
        status = entry(
            planes.code.data_ptr(), planes.code.element_size(), planes.code_tv.data_ptr(),
            planes.code_tv.shape[0], *cls, *common,
        )
    else:
        entry = (lib.fpm_continuation_superstep_counting if counting
                 else lib.fpm_continuation_superstep)
        status = entry(
            planes.adj.data_ptr(), alive_rev.data_ptr(), alive.data_ptr(),
            tp_flag.data_ptr(), *cls, *common,
        )
    _build.check(status, kernel)
    launches[kernel] += 1
    if counting:
        trace.count("lcc_count_fused")
    return new_tv, new_alive, flag_out, stats
