"""The torch DeviceNlcc (fuzzypatternmatching_tpu_torch/engine/nlcc_device.py)
and its kernels (ops/nlcc_frontier.py) on the CPU.

* DeviceNlcc with ``device="cpu"`` (the kernels' plain twins) against the
  JAX package's DeviceNlcc (jit on the CPU) and its host engine, on the
  fixtures of tests/test_nlcc_device.py: the same sources, validated
  flags, messages (total and per rank), edge marks, subgraphs and
  forwarded keys;
* the twins of expand_frontier and forward_winners against numpy written
  out here (``np.repeat`` expansion, ``lexsort`` winners), with empty
  frontiers, zero-degree tokens, a hub row, 1 and 4 ranks, every lane
  filtered and none, and keys repeating within and across hops;
* the host side of the kernels' routes against numpy: the bit plane and
  its summary (V not a multiple of 32; bits 0, 30 and 31), the plane and
  summary layouts and the route chosen from V and the lane count, the
  winners' partition count, table size and route;
* the torch MatchEngine in each NLCC placement, at 1 and 4 output ranks,
  against the JAX MatchEngine on the golden configurations, two
  selected-vertices corpora and the tree corpus with edge metadata.

The kernels themselves are held against the twins by the tests marked
``cuda`` in tests/test_torch_ops.py, which skip where there is no card.
Every value compared is an integer or a flag: exact equality.
"""

import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu.engine import nlcc as jax_nlcc
from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.engine.nlcc_device import DeviceNlcc as JaxDeviceNlcc
from fuzzypatternmatching_tpu.graph.csr import degree_labels
from fuzzypatternmatching_tpu.graph.csr import from_edges
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine import nlcc
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.nlcc_device import DeviceNlcc
from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf
from fuzzypatternmatching_tpu_torch.pattern import builtin
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
    NonLocalConstraint,
)

from test_engine_vs_oracle import (
    _random_graph,
    _uni_pattern,
    selected_constraint,
    tds_selected_constraint,
    uniform_path_nem,
)
from test_nlcc_device import _assert_outcome_equal, _full_acsr, _tv_for
from test_oracle import (
    PATH_PATTERN,
    cycle_constraint,
    path_constraint,
    tds_constraint,
    undirected,
)
from test_torch_counting import port_graph, port_pattern
from test_torch_lcc_bucketed import _rmat_edges
from test_torch_ops import (
    EXPAND_CASES,
    WINNER_CASES,
    _as_torch,
    _expand_inputs,
    _winner_inputs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from make_golden import build_config as jax_build_config  # noqa: E402

CPU = torch.device("cpu")


def _port_constraint(cj) -> NonLocalConstraint:
    return NonLocalConstraint(
        labels=cj.labels.copy(), indices=cj.indices.copy(),
        cycle_length=cj.cycle_length, valid_cycle=cj.valid_cycle,
        interleave_lcc=cj.interleave_lcc,
        selected_vertices=cj.selected_vertices,
        enumeration=cj.enumeration.copy(), aggregation=cj.aggregation.copy(),
        is_tds=cj.is_tds,
    )


def _port_acsr(acsr_j) -> nlcc.AliveCsr:
    return nlcc.AliveCsr(ptr=acsr_j.ptr.copy(), col=acsr_j.col.copy())


def _three_runs(kind, acsr_j, labels, tv, cj, v, nr, fws=None, **kw):
    """(JAX host, JAX DeviceNlcc, port DeviceNlcc) outcomes of one
    constraint; ``fws`` = their three forwarded sets."""
    fh, fj, fp = fws or (None, None, None)
    c = _port_constraint(cj)
    if kind == "nem":
        host = jax_nlcc.run_nem(acsr_j, labels, tv, cj, v, num_ranks=nr, forwarded=fh, **kw)
        jdev = JaxDeviceNlcc(v, num_ranks=nr).run_nem(acsr_j, labels, tv, cj, v, forwarded=fj, **kw)
        port = DeviceNlcc(v, num_ranks=nr, device=CPU).run_nem(
            _port_acsr(acsr_j), labels, tv, c, v, forwarded=fp, **kw
        )
    else:
        host = jax_nlcc.run_tds(acsr_j, labels, tv, cj, v, num_ranks=nr, forwarded=fh, **kw)
        jdev = JaxDeviceNlcc(v, num_ranks=nr).run_tds(acsr_j, labels, tv, cj, v, forwarded=fj, **kw)
        port = DeviceNlcc(v, num_ranks=nr, device=CPU).run_tds(
            _port_acsr(acsr_j), labels, tv, c, v, forwarded=fp, **kw
        )
    _assert_outcome_equal(host, port)
    _assert_outcome_equal(jdev, port)
    return host, port


def _forwarded_sets():
    return (jax_nlcc.ForwardedSets.empty(), jax_nlcc.ForwardedSets.empty(),
            nlcc.ForwardedSets.empty())


def _same_keys(fws):
    fh, fj, fp = fws
    assert np.array_equal(fh.keys, fp.keys)
    assert np.array_equal(fj.keys, fp.keys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nem_cycle_matches_jax(seed):
    g = _random_graph(seed, v=48, e=160)
    labels = np.random.RandomState(seed + 7).randint(1, 4, size=48).astype(np.uint64)
    c = cycle_constraint()
    fws = _forwarded_sets()
    host, _ = _three_runs("nem", _full_acsr(g), labels, _tv_for(labels, [c], 48), c, 48, 4, fws)
    _same_keys(fws)
    assert host.messages > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_nem_path_matches_jax(seed):
    g = _random_graph(seed, v=48, e=160)
    labels = np.random.RandomState(seed + 7).randint(1, 3, size=48).astype(np.uint64)
    c = path_constraint()
    fws = _forwarded_sets()
    _three_runs("nem", _full_acsr(g), labels, _tv_for(labels, [c], 48), c, 48, 4, fws)
    _same_keys(fws)
    assert len(fws[2].keys) > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_tds_matches_jax(seed):
    g = _random_graph(seed, v=48, e=160)
    labels = np.random.RandomState(seed + 7).randint(1, 3, size=48).astype(np.uint64)
    c = tds_constraint()
    host, _ = _three_runs("tds", _full_acsr(g), labels, _tv_for(labels, [c], 48), c, 48, 4)
    assert len(host.subgraphs) > 0


def test_selected_vertices_aggregation_matches_jax():
    """The path run fills the forwarded sets; the selected run reads them,
    one ForwardedSets object per engine across both."""
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0)])
    g = from_edges(src, dst, num_vertices=4)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    cs = [path_constraint(), selected_constraint()]
    tv = _tv_for(labels, cs, 4)
    acsr = _full_acsr(g)
    fws = _forwarded_sets()
    for cj in cs:
        for f in fws:
            f.reset_for(cj, labels, tv, 4)
        _three_runs("nem", acsr, labels, tv, cj, 4, 2, fws)
        _same_keys(fws)


@pytest.mark.parametrize("seed", [7, 8])
def test_tds_selected_matches_jax(seed):
    g = _random_graph(seed, v=32, e=96)
    labels = np.ones(32, dtype=np.uint64)
    c0, c1 = uniform_path_nem(), tds_selected_constraint()
    tv = _tv_for(labels, [c0], 32)
    acsr = _full_acsr(g)
    fws = _forwarded_sets()
    _three_runs("nem", acsr, labels, tv, c0, 32, 2, fws)
    for f in fws:
        f.reset_for(c1, labels, tv, 32)
    host, _ = _three_runs("tds", acsr, labels, tv, c1, 32, 2, fws)
    assert host.validated.any()


def test_shared_forwarded_sets_sequence_matches_host():
    """A nem path run, a selected nem run and a selected TDS run in one
    sequence on one forwarded set per engine, with 3 ranks; tv is the
    same for all three, as in a MatchEngine iteration without deletions."""
    g = _random_graph(21, v=40, e=140)
    labels = np.ones(40, dtype=np.uint64)
    cs = [uniform_path_nem(), selected_constraint(), tds_selected_constraint()]
    cs[1].labels[:] = 1
    tv = _tv_for(labels, cs, 40)
    acsr = _full_acsr(g)
    fws = _forwarded_sets()
    for cj in cs:
        for f in fws:
            f.reset_for(cj, labels, tv, 40)
        _three_runs("tds" if cj.is_tds else "nem", acsr, labels, tv, cj, 40, 3, fws)
        _same_keys(fws)


def test_metadata_hop_filters_are_refused():
    g = _random_graph(0, v=16, e=40)
    labels = np.ones(16, dtype=np.uint64)
    c = _port_constraint(uniform_path_nem())
    dn = DeviceNlcc(16, device=CPU)
    acsr = _port_acsr(_full_acsr(g))
    tv = _tv_for(labels, [c], 16)
    with pytest.raises(NotImplementedError):
        dn.run_nem(acsr, labels, tv, c, 16, hopc=np.zeros(3, dtype=np.int64))
    with pytest.raises(NotImplementedError):
        dn.run_tds(acsr, labels, tv, c, 16, hopc=np.zeros(3, dtype=np.int64))


def test_device_nlcc_refusals():
    with pytest.raises(ValueError):
        DeviceNlcc(1 << 31, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DeviceNlcc(16)  # the card is the default device


# -- the twins against numpy --------------------------------------------------


def _expand_numpy(ptr, col, cur, parent, ok_bits, h, r, drop):
    deg = ptr[cur + 1] - ptr[cur]
    tok = np.repeat(np.arange(len(cur)), deg)
    off = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
    nbr = col[ptr[cur][tok] + off]
    msg = nbr != parent[tok] if drop else np.ones(len(nbr), dtype=bool)
    msg_r = np.bincount(nbr[msg] % r, minlength=r).astype(np.int64)
    keep = msg & (((ok_bits.view(np.uint32)[nbr] >> h) & 1) != 0) if h >= 0 else msg
    return tok[keep], nbr[keep], msg_r, len(nbr)


@pytest.mark.parametrize("case", range(len(EXPAND_CASES)))
def test_expand_frontier_twin_matches_numpy(case):
    n, hub, density, h, r, drop = EXPAND_CASES[case]
    ptr, col, cur, parent, ok_bits = _expand_inputs(case, n, hub, density)
    want_tok, want_nbr, want_msg, lanes = _expand_numpy(ptr, col, cur, parent, ok_bits, h, r, drop)
    before = dict(nf.launches)
    got = nf.expand_frontier(*_as_torch(ptr, col, cur, parent, ok_bits), h, r, drop)
    assert nf.launches == before  # the twin launches nothing
    assert got.tok.dtype == got.nbr.dtype == torch.int32
    assert np.array_equal(got.tok.numpy(), want_tok)
    assert np.array_equal(got.nbr.numpy(), want_nbr)
    assert np.array_equal(got.msg_per_rank.numpy(), want_msg)
    assert got.lanes == lanes
    if hub and n:
        assert lanes >= 10000
    sized = nf.expand_frontier(
        *_as_torch(ptr, col, cur, parent, ok_bits), h, r, drop, sizes=(lanes, len(want_tok))
    )
    assert torch.equal(sized.tok, got.tok) and torch.equal(sized.nbr, got.nbr)


def _winners_numpy(keys, parents, seen):
    prior = np.isin(keys, seen)
    order = np.lexsort((np.arange(len(keys)), parents, keys))
    k = keys[order]
    first = np.ones(len(k), dtype=bool)
    first[1:] = k[1:] != k[:-1]
    win = np.zeros(len(keys), dtype=bool)
    win[order] = first & ~prior[order]
    return win


@pytest.mark.parametrize("case", range(len(WINNER_CASES)))
def test_forward_winners_twin_matches_numpy(case):
    keys, parents, seen = _winner_inputs(case, *WINNER_CASES[case])
    want = _winners_numpy(keys, parents, seen)
    got = nf.forward_winners(*_as_torch(keys, parents, seen))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    if case >= 3:
        assert 0 < want.sum() < len(set(keys.tolist()))  # prior keys lose


def test_forward_winners_twin_across_hops():
    """Two hops: the first hop's winners join the earlier keys, and the
    second hop's lanes of those keys lose."""
    rng = np.random.RandomState(9)
    k1 = rng.randint(0, 200, size=600).astype(np.int64)
    p1 = rng.randint(0, 9, size=600).astype(np.int32)
    fwd_in = np.arange(0, 200, 7, dtype=np.int64)
    w1 = nf.forward_winners(*_as_torch(k1, p1, fwd_in)).numpy()
    assert np.array_equal(w1, _winners_numpy(k1, p1, fwd_in))
    seen = np.concatenate([fwd_in, k1[w1]])
    k2 = rng.randint(0, 400, size=900).astype(np.int64)
    p2 = rng.randint(0, 9, size=900).astype(np.int32)
    w2 = nf.forward_winners(*_as_torch(k2, p2, seen)).numpy()
    assert np.array_equal(w2, _winners_numpy(k2, p2, seen))
    assert not np.isin(k2[w2], seen).any()


# The hop's bit plane: one bit a vertex in int32 words, whole 16 bytes.
PLANE_WORDS = {
    1: 4, 32: 4, 128: 4, 129: 8, 300: 12, 1_851_392: 57_856, 1_851_393: 57_860,
    1 << 21: 65_536, (1 << 21) + 7: 65_540, 1 << 24: 524_288, 14_811_137: 462_852,
}


@pytest.mark.parametrize("v", list(PLANE_WORDS))
def test_plane_words(v):
    words = nf.plane_words(v)
    assert words == PLANE_WORDS[v]
    assert words % 4 == 0 and 32 * words >= v > 32 * (words - 4)


# The summary that each CTA holds: one bit per 2**g vertices, the finest
# that fits SUMMARY_BYTES (V = 1,851,392: the plane itself).
SUMMARY_GROUPS = {
    1: 0, 300: 0, 1_851_392: 0, 1_851_393: 1, (1 << 21) + 7: 1, 1 << 22: 2,
    1 << 23: 3, 14_811_136: 3, 14_811_137: 4, 1 << 24: 4, (1 << 31) - 1: 11,
}


@pytest.mark.parametrize("v", list(SUMMARY_GROUPS))
def test_summary_layout_and_route(v):
    g, words = nf.summary_layout(v)
    assert g == SUMMARY_GROUPS[v]
    assert words % 4 == 0 and 32 * words >= -(-v // (1 << g))
    assert 4 * words <= nf.SUMMARY_BYTES
    assert g == 0 or 16 * -(-v // (128 << (g - 1))) > nf.SUMMARY_BYTES  # finest that fits
    assert g > 0 or words == nf.plane_words(v)
    big = nf.PLANE_MIN_LANES
    assert nf.expand_route(v, 0, big) == nf.expand_route(v, 30, big) == f"summary-{1 << g}"
    assert nf.expand_route(v, 0, big - 1) == nf.expand_route(v, 30, 1) == "first-design"
    assert nf.expand_route(v, -1, big) == nf.expand_route(v, -1, 1) == "unfiltered"


@pytest.mark.parametrize("g", [0, 1, 2, 5, 6])
@pytest.mark.parametrize("v", [33, 1000, 4099])
def test_plane_summary_twin_matches_numpy(v, g):
    rng = np.random.RandomState(v + g)
    bits = rng.rand(v) < 0.05
    n_words = 4 * -(-v // 128)
    padded = np.zeros(n_words * 32, dtype=np.uint64)
    padded[:v] = bits
    plane = (padded.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    s_words = 4 * -(-v // (128 << g))
    groups = np.zeros(s_words * 32 << g, dtype=bool)
    groups[:v] = bits
    want_bits = groups.reshape(-1, 1 << g).any(1).astype(np.uint64)
    want = (want_bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    got = nf.plane_summary(torch.from_numpy(plane.view(np.int32)), g, s_words)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("h", [0, 30, 31])
@pytest.mark.parametrize("v", [1, 31, 32, 33, 1000, 4099])
def test_bit_plane_twin_matches_numpy(v, h):
    """The hop's bit plane, for V not a multiple of 32 too, and bit 31
    (which makes the int32 words negative)."""
    rng = np.random.RandomState(v * 3 + h)
    ok = rng.randint(0, 1 << 32, size=v, dtype=np.uint64).astype(np.uint32)
    n_words = nf.plane_words(v)
    bits = np.zeros(n_words * 32, dtype=np.uint64)
    bits[:v] = (ok >> h) & 1
    want = (bits.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)
    got = nf.bit_plane(torch.from_numpy(ok.view(np.int32)), h, n_words)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(ValueError):
        nf.bit_plane(torch.from_numpy(ok.view(np.int32)), 32, n_words)


@pytest.mark.parametrize(
    "n, parts",
    [(0, 1), (1, 1), (1024, 1), (1025, 2), (28_347, 32), (855_213, 1024), (10**9, 4096)],
)
def test_winner_partitions_and_tables(n, parts):
    """About 1,024 entries a partition (855,213 entries: the s21 cycle hop
    2), and tables of twice the share with a margin, within a CTA's 227 KB
    and at most half full where the share is as expected."""
    assert nf.winner_partitions(n) == parts
    share = -(-n // parts)
    assert parts == nf.MAX_PARTITIONS or share <= nf.WINNER_PART_ENTRIES
    assert parts == 1 or n > (parts // 2) * nf.WINNER_PART_ENTRIES
    slots = nf.winner_table_slots(n, parts)
    assert 16 * slots <= 227 * 1024
    assert slots == nf.WINNER_TABLE_SLOTS or slots >= 2 * share + 64


@pytest.mark.parametrize("n", [0, 1, nf.WINNER_PARTITION_MIN - 1, nf.WINNER_PARTITION_MIN, 10**8])
def test_winner_route(n):
    want = "partition" if n >= nf.WINNER_PARTITION_MIN else "global-table"
    assert nf.winner_route(n) == want


def test_card_entry_points_refuse_cpu_tensors():
    """The kernels' own entry points take CUDA tensors only: a CPU tensor
    reaches the twin through the wrapper, never a kernel."""
    expand_args = _as_torch(*_expand_inputs(0, 10, False, 0.5))
    with pytest.raises(ValueError, match="CUDA tensors"):
        nf.expand_frontier_cuda(*expand_args, 1, 1, True)
    keys, parents, seen = _as_torch(*_winner_inputs(2, 40, 40, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        nf.forward_winners_cuda(keys, parents, seen)
    nf.reset_launches()
    nf.expand_frontier(*expand_args, 1, 1, True)
    nf.forward_winners(keys, parents, seen)
    assert nf.routes == {} and nf.launches == {"expand_frontier": 0, "forward_winners": 0}


def test_wrappers_reject_wrong_inputs():
    ptr, col, cur, parent, ok_bits = _as_torch(*_expand_inputs(0, 10, False, 0.5))
    with pytest.raises(ValueError):
        nf.expand_frontier(ptr, col, cur.long(), parent, ok_bits, 1, 1, True)
    with pytest.raises(ValueError):
        nf.expand_frontier(ptr, col, cur, parent, ok_bits, 31, 1, True)
    with pytest.raises(ValueError):
        nf.expand_frontier(ptr, col, cur, parent, ok_bits, 1, 0, True)
    keys = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        nf.forward_winners(keys, keys, keys)
    with pytest.raises(ValueError):
        nf.forward_winners(keys, keys[:3].int(), keys)


# -- MatchEngine in each placement against the JAX MatchEngine --------------


@pytest.fixture(scope="module")
def golden_meta():
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        return json.load(f)


def _search_case(golden_meta, name):
    """(JAX engine's arguments, port engine's arguments, keywords) of one
    search: a golden configuration, a selected-vertices corpus on a
    random graph (``selected_path``: a path then the aggregation
    constraint; ``selected_tds``: a uniform path then a selected TDS walk),
    or ``meta_tree_s11``, the tree corpus with its pattern edge data over
    R-MAT s11 with symmetric random metadata (55, or 56 on one edge in
    ten, a value no pattern edge takes)."""
    if name in golden_meta["configs"]:
        cfg = golden_meta["configs"][name]
        prefix = os.path.join(REPO, cfg["corpus"])
        return jax_build_config(cfg["scale"], prefix), golden.build_config(cfg["scale"], prefix), {}
    if name == "meta_tree_s11":
        gj = from_edges(*_rmat_edges(11), num_vertices=1 << 11)
        with tempfile.TemporaryDirectory() as tmp:
            pj, cjs = jax_builtin.load_tree_pattern(tmp + "/jax")
            pt, cs = builtin.load_tree_pattern(tmp + "/port")
        rng = np.random.RandomState(11)
        vals = rng.choice([55, 56], p=[0.9, 0.1], size=gj.num_edges)
        ed = np.where(gj.edge_row < gj.cols, vals, vals[np.maximum(gj.rev_edge, 0)])
        labels = degree_labels(gj)
        return (gj, labels, pj, cjs), (port_graph(gj), labels, pt, cs), {"edge_data": ed}
    rng = np.random.RandomState(5)
    if name == "selected_path":
        gj = _random_graph(5, v=160, e=480)
        labels = rng.randint(1, 3, size=160).astype(np.uint64)
        pj, cjs = PATH_PATTERN, [path_constraint(), selected_constraint()]
    else:
        gj = _random_graph(6, v=96, e=200)
        labels = np.ones(96, dtype=np.uint64)
        pj, cjs = _uni_pattern(), [uniform_path_nem(), tds_selected_constraint()]
    port = (port_graph(gj), labels, port_pattern(pj), [_port_constraint(c) for c in cjs])
    return (gj, labels, pj, cjs), port, {}


@pytest.fixture(scope="module")
def jax_results(golden_meta):
    """The JAX MatchEngine's result per search case and rank count,
    computed once."""
    cache = {}

    def get(name, ranks):
        if (name, ranks) not in cache:
            jx, _, kw = _search_case(golden_meta, name)
            cache[name, ranks] = JaxMatchEngine(*jx, num_ranks=ranks, **kw).run()
        return cache[name, ranks]

    return get


def _rows(result):
    return [
        (r.itr, r.phase, r.step, r.active_vertices, r.active_edges, r.messages,
         {k: np.asarray(x).tolist() for k, x in (r.per_rank or {}).items()})
        for r in result.rows
    ]


@pytest.mark.parametrize("ranks", [1, 4])
@pytest.mark.parametrize("mode", ["device", "host", "auto"])
@pytest.mark.parametrize(
    "config",
    ["tree_s11", "tree_s13", "cycle_s13", "selected_path", "selected_tds", "meta_tree_s11"],
)
def test_driver_modes_match_jax(golden_meta, jax_results, config, mode, ranks):
    _, port, kw = _search_case(golden_meta, config)
    eng = MatchEngine(
        *port, num_ranks=ranks, nlcc_mode=mode, nlcc_device_min=1 << 10,
        device="cpu", **kw,
    )
    assert (eng._dev_nlcc is None) == (mode == "host")
    assert (eng._meta is not None) == ("edge_data" in kw)
    rt, rj = eng.run(), jax_results(config, ranks)
    assert _rows(rt) == _rows(rj)
    assert any(r.phase == "TP" for r in rt.rows)
    if config in golden_meta["configs"]:
        assert rt.iterations == golden_meta["configs"][config]["iterations"]
    assert rt.iterations == rj.iterations
    assert rt.traversed_edges == rj.traversed_edges
    assert rt.pattern_found == rj.pattern_found
    assert rt.active_vertices == rj.active_vertices
    assert rt.active_edges == rj.active_edges
    assert rt.subgraphs == rj.subgraphs
    assert eng.nlcc_fallbacks == 0


def test_driver_defaults():
    import inspect

    params = inspect.signature(MatchEngine.__init__).parameters
    assert params["nlcc_mode"].default == "auto"
    assert params["device"].default == "cuda"
    assert params["nlcc_device_min"].default > 0


def test_auto_mode_gates_on_first_expansion(golden_meta):
    cfg = golden_meta["configs"]["cycle_s13"]
    g, labels, pattern, constraints = golden.build_config(
        cfg["scale"], os.path.join(REPO, cfg["corpus"])
    )
    eng = MatchEngine(
        g, labels, pattern, constraints, nlcc_mode="auto",
        nlcc_device_min=1 << 30, device="cpu",
    )
    c = constraints[0]
    tv = _tv_for(labels, [c], g.num_vertices)
    acsr = nlcc.AliveCsr(ptr=g.row_ptr.astype(np.int64), col=g.cols.astype(np.int64))
    cand = np.nonzero(labels == c.labels[0])[0].astype(np.int64)
    work = eng._dev_nlcc._first_expansion(acsr, nlcc.token_sources(c, labels, tv, cand))
    assert 0 < work < 1 << 30
    assert not eng._nlcc_on_device(acsr, c, tv, cand)
    eng.nlcc_device_min = work
    assert eng._nlcc_on_device(acsr, c, tv, cand)
    eng.nlcc_device_min = work + 1
    assert not eng._nlcc_on_device(acsr, c, tv)
    eng.nlcc_mode = "device"
    assert eng._nlcc_on_device(acsr, c, tv)
    eng.nlcc_mode = "host"
    assert not eng._nlcc_on_device(acsr, c, tv)


def test_ok_bits_equal_jax():
    """The arrival bitmask, built on the device, against the JAX package's
    numpy words (bit 31 = map keys)."""
    rng = np.random.RandomState(4)
    v = 500
    labels = rng.randint(1, 4, size=v).astype(np.uint64)
    c = cycle_constraint()
    tv = _tv_for(labels, [c], v)
    tv[rng.rand(v) < 0.3] = 0
    keys = np.nonzero(tv)[0][::2].astype(np.int64)
    for mk in (None, keys):
        got = DeviceNlcc(v, device=CPU)._ok_bits(labels, tv, _port_constraint(c), mk)
        want = JaxDeviceNlcc(v)._ok_bits(labels, tv, c, mk)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy().view(np.uint32), want)
