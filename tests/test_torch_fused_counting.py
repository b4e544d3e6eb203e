"""The fused supersteps under the counting rule (fuzzypatternmatching_tpu_torch/
ops/lcc_fused.py): K1 and K2's counting instantiations, where the planes
carry each slot's sender class (``cls``) and the template its requirement
table (``required``).

On the CPU the wrappers run the plain twin. Its count is held here against
a count written out in numpy (per segment, per requirement (i, j): the
accepted slots of class j + 1 whose candidates meet ``adj_all[i]``), and
the wrappers' argument checks, the kernels' template words and the
engine's counting planes are checked. The counting engine's searches
against the JAX package are tests/test_torch_counting.py's.

The CUDA kernels are held against the twin by the tests marked ``cuda``
(they skip where there is no card), exactly: tv, alive, flags and stats.
This file imports no JAX, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_counting.py
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine import lcc_bucketed
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.ops import lcc_fused as lf
from fuzzypatternmatching_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO_SEVENS = os.path.join(
    REPO, "benchmark", "templates", "rmat_log2_tree_pattern_0_two_sevens", "pattern"
)
CPU = torch.device("cpu")
# small cases: every engine width, the widest split, and a split width-16
# bucket (the engine's max_width=16)
BUCKETS = [(9, 8, False), (33, 16, False), (7, 64, False), (5, 512, False), (3, 8192, True)]
SPLIT16 = [(50, 8, False), (120, 16, True)]
TABLES = {f"k{k}_L{n}_p{p}_top{t}": (k, n, p, t) for k, n, p, t in chip_smoke.COUNTING_TABLES}


def case(name, buckets, ranks=1, code8=True, seed=0, density=0.6):
    k, n_cls, pairs, top = TABLES[name]
    req = chip_smoke.required_table(seed, k, n_cls, pairs, top)
    return chip_smoke.fused_case(700 + seed, buckets, CPU, ranks, code8, k=k, density=density,
                                 required=req)


def unmet_case(ranks=1):
    """Every class in every row, every requirement 15: none is met."""
    return chip_smoke.fused_case(900 + ranks, [(40, 8, False), (30, 16, False), (60, 16, True)],
                                 CPU, ranks, k=16, density=1.0,
                                 required=np.full((16, 16), 15, dtype=np.int64),
                                 cycle_classes=True)


def numpy_keep(planes, tmpl, tv, init, alive_rev=None):
    """Each segment's count mask, counted in numpy: bit i where every
    requirement (i, j) met its count."""
    req = np.asarray(tmpl.required)
    v = planes.num_vertices
    tv = tv.numpy().astype(np.int64)
    tv_ext = np.append(tv, 0)
    keep = []
    for d in lf.bucket_views(planes):
        n_seg = d.seg_rows.shape[0]
        seg_id = d.seg_id.numpy()
        tv_seg = tv[d.seg_rows.numpy()]
        m = np.zeros_like(tv_seg)
        for i, a in enumerate(tmpl.adj_all):
            m |= ((tv_seg >> i) & 1) * a
        if init:
            p = planes.code_tv.numpy().astype(np.int64)[d.code.numpy().astype(np.int64)]
        else:
            adj = d.adj.numpy().astype(np.int64)
            rev = alive_rev[d.lo : d.lo + d.n * d.w].numpy().reshape(d.n, d.w)
            p = np.where(rev, tv_ext[np.minimum(adj, v)], 0)
        accepted = (p & m[seg_id][:, None]) != 0
        cls = d.cls.numpy()
        k_seg = np.zeros(n_seg, dtype=np.int64)
        for i in range(req.shape[0]):
            ok = np.ones(n_seg, dtype=bool)
            for j in range(req.shape[1]):
                if req[i, j] == 0:
                    continue
                rows = (accepted & (cls == j + 1) & ((p & tmpl.adj_all[i]) != 0)).sum(axis=1)
                ok &= np.bincount(seg_id, weights=rows, minlength=n_seg) >= req[i, j]
            k_seg |= ok.astype(np.int64) << i
        keep.append((d, k_seg))
    return keep


def held_to_numpy(planes, tmpl, state):
    """The twin under the counting rule equals the default twin's tv and
    alive with the numpy count mask applied; returns how many segments the
    count emptied and how many it left live."""
    label_tv, tv, alive, flag, alive_rev = state
    plain = planes._replace(cls=None), tmpl._replace(required=None)
    emptied = live = 0
    for init, args in ((True, (label_tv,)), (False, (tv, alive, flag, alive_rev))):
        run = lf.init_superstep if init else lf.continuation_superstep
        got_tv, got_alive, _, _ = run(planes, *args, tmpl)
        base_tv, base_alive, _, _ = run(plain[0], *args, plain[1])
        want_tv, want_alive = base_tv.numpy().copy(), base_alive.numpy().copy()
        for d, k_seg in numpy_keep(planes, tmpl, args[0], init, None if init else alive_rev):
            rows = d.seg_rows.numpy()
            before = want_tv[rows]
            want_tv[rows] = before & k_seg
            emptied += int(((before != 0) & (want_tv[rows] == 0)).sum())
            live += int((want_tv[rows] != 0).sum())
            row_live = (want_tv[rows] != 0)[d.seg_id.numpy()]
            sl = slice(d.lo, d.lo + d.n * d.w)
            want_alive[sl] &= np.repeat(row_live, d.w)
        assert np.array_equal(got_tv.numpy(), want_tv)
        assert np.array_equal(got_alive.numpy(), want_alive)
    return emptied, live


@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("ranks", [1, 4])
def test_twin_counts_as_numpy(name, ranks):
    """Tables of 0 to 256 requirement pairs (1 to 16 register groups of the
    kernels), counts up to 15; the count empties some segments and leaves
    others live, except where there is no requirement."""
    emptied, live = held_to_numpy(*case(name, BUCKETS, ranks, seed=ranks))
    assert live > 0
    assert (emptied > 0) == (TABLES[name][2] > 0)


def test_twin_counts_split_hubs_as_numpy():
    emptied, live = held_to_numpy(*case("k16_L16_p40_top3", SPLIT16, ranks=4, density=1.0))
    assert emptied > 0 and live > 0


def test_no_requirement_met_empties_every_segment():
    planes, tmpl, state = unmet_case()
    cls = planes.cls.numpy()
    assert set(np.unique(cls[cls > 0])) == set(range(1, 17))
    emptied, live = held_to_numpy(planes, tmpl, state)
    assert emptied > 0 and live == 0


def test_wrappers_check_the_counting_rule():
    planes, tmpl, (label_tv, tv, alive, flag, alive_rev) = case("k7_L4_p11_top2", SPLIT16)
    k = len(tmpl.adj_all)
    req = np.asarray(tmpl.required)
    bad = [
        (planes._replace(cls=None), tmpl),
        (planes, tmpl._replace(required=None)),
        (planes._replace(cls=planes.cls.to(torch.int32)), tmpl),
        (planes._replace(cls=planes.cls[:-1]), tmpl),
        (planes, tmpl._replace(required=tuple(map(tuple, req[:-1].tolist())))),
        (planes, tmpl._replace(required=((1,) * 17,) * k)),
        (planes, tmpl._replace(required=tuple(map(tuple, (req * 0 + 16).tolist())))),
        (planes, tmpl._replace(required=tuple(map(tuple, (req * 0 - 1).tolist())))),
    ]
    for p, t in bad:
        with pytest.raises(ValueError):
            lf.init_superstep(p, label_tv, t)
        with pytest.raises(ValueError):
            lf.continuation_superstep(p, tv, alive, flag, alive_rev, t)


def test_template_words_carry_the_requirement_table():
    _, tmpl, _ = case("k7_L4_p11_top2", SPLIT16)
    words = lf._template_words(tmpl)
    n = 1 + 4 * lf.MAX_TEMPLATE_VERTICES
    assert words.shape == (n + lf.MAX_TEMPLATE_VERTICES * lf.MAX_CLASSES,)
    assert np.array_equal(words[:n], lf._template_words(tmpl._replace(required=None)))
    table = words[n:].reshape(lf.MAX_TEMPLATE_VERTICES, lf.MAX_CLASSES)
    req = np.asarray(tmpl.required)
    assert np.array_equal(table[: req.shape[0], : req.shape[1]], req)
    assert table.sum() == req.sum()


@pytest.fixture(scope="module")
def two_sevens():
    return golden.build_config(13, TWO_SEVENS)


def test_counting_engine_planes(two_sevens):
    """The counting engine's sender classes are one flat uint8 plane, each
    bucket's a view of it, and its template carries its table."""
    g, labels, pattern, _ = two_sevens
    eng = BucketedLccEngine(g, labels, pattern, device="cpu", counting=True, max_width=16)
    pl = eng._planes
    assert pl.cls.dtype == torch.uint8 and pl.cls.shape == (eng.num_slots,)
    for b, d in zip(eng.buckets, eng._dev):
        n, w = b.adj.shape
        assert d.cls.data_ptr() == pl.cls[b.slot_base :].data_ptr() and d.cls.shape == (n, w)
    assert np.array_equal(np.asarray(eng._tmpl.required), eng.required)
    plain = BucketedLccEngine(g, labels, pattern, device="cpu", max_width=16)
    assert plain._planes.cls is None and plain._tmpl.required is None


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TABLES))
@pytest.mark.parametrize("ranks", [1, 4, 2000])
@pytest.mark.parametrize("code8", [True, False], ids=["code8", "code32"])
def test_counting_kernels_match_twins_on_cuda(cuda_device, name, ranks, code8):
    """Every engine width with a split widest bucket, and split hubs in a
    width-16 bucket (block mode), rows 0/1/33/257."""
    k, n_cls, pairs, top = TABLES[name]
    errs = dict.fromkeys(lf.launches, 0)
    widths = chip_smoke.FUSED_WIDTHS
    for seed in range(2):
        rng = np.random.RandomState(seed)
        n_rows = rng.choice([0, 1, 33, 257], size=len(widths))
        n_rows[-1] = 40
        req = chip_smoke.required_table(seed, k, n_cls, pairs, top)
        for buckets in ([(int(n), w, w == widths[-1]) for n, w in zip(n_rows, widths)], SPLIT16):
            lf.reset_launches()
            chip_smoke.fused_errs(*chip_smoke.fused_case(
                seed, buckets, cuda_device, ranks, code8, k=k, density=(0.005, 0.6)[seed],
                required=req), errs)
            assert lf.launches == {"init_superstep": 1, "continuation_superstep": 1}
    assert errs == {"init_superstep": 0, "continuation_superstep": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 4])
def test_counting_kernels_no_requirement_met_on_cuda(cuda_device, ranks):
    errs = dict.fromkeys(lf.launches, 0)
    planes, tmpl, state = chip_smoke.fused_case(
        900 + ranks, [(40, 8, False), (30, 16, False), (60, 16, True)], cuda_device, ranks, k=16,
        density=1.0, required=np.full((16, 16), 15, dtype=np.int64), cycle_classes=True)
    chip_smoke.fused_errs(planes, tmpl, state, errs)
    assert errs == {"init_superstep": 0, "continuation_superstep": 0}
    assert not lf.init_superstep(planes, state[0], tmpl)[0].any()


def _rows_equal(a, b):
    assert [x[:3] for x in a] == [x[:3] for x in b]
    for x, y in zip(a, b):
        assert all(np.array_equal(x[3][k], y[3][k]) for k in ("av", "ae", "msg"))


@pytest.mark.cuda
@pytest.mark.parametrize("max_width", [16, 8192])
@pytest.mark.parametrize("ranks", [1, 4])
def test_counting_engine_on_cuda_equals_cpu(cuda_device, two_sevens, max_width, ranks):
    """The counting engine's lcc_call on the card (the kernels) and on the
    CPU (the twin): the s13 two_sevens configuration, split hubs at
    max_width 16; a continuation with token-passing marks."""
    g, labels, pattern, _ = two_sevens
    engines = [BucketedLccEngine(g, labels, pattern, device=d, num_ranks=ranks,
                                 max_width=max_width, counting=True)
               for d in (cuda_device, CPU)]
    lf.reset_launches()
    outs = []
    for eng in engines:
        st, rows, died = eng.lcc_call(eng.init_state(), True, n_steps=1)
        tv, alive = eng.state_to_global(st)
        flag = np.zeros_like(alive)
        flag[np.nonzero(alive)[0][::5]] = True
        st2, rows2, died2 = eng.lcc_call(eng.state_from_global(tv, alive, flag), False)
        outs.append((rows, died, tv, alive, rows2, died2, *eng.state_to_global(st2)))
    assert lf.launches == {"init_superstep": 1, "continuation_superstep": pattern.diameter}
    for a, b in zip(*outs):
        if isinstance(a, list):
            _rows_equal(a, b)
        else:
            assert np.array_equal(a, b)


def _plain(r):
    return (
        [(x.itr, x.phase, x.step, x.active_vertices, x.active_edges, x.messages)
         for x in r.rows],
        list(r.pattern_found), r.iterations, dict(r.active_vertices),
        set(r.active_edges), {k: sorted(map(tuple, np.asarray(v).tolist()))
                              for k, v in r.subgraphs.items()},
        r.traversed_edges,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("compact", [True, False])
def test_counting_search_on_cuda_equals_cpu(cuda_device, two_sevens, compact):
    """A whole counting search on the card and on the CPU: the same rows,
    vertices, edges and subgraphs; on the card every superstep one fused
    launch (``lcc_count_fused``) and no Python-side class count."""
    results = {}
    for dev in (cuda_device, CPU):
        eng = MatchEngine(*two_sevens, num_ranks=4, counting=True, compact=compact, device=dev)
        eng.run()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            results[dev.type] = eng.run()
    card, cpu = results["cuda"], results["cpu"]
    assert _plain(card) == _plain(cpu)
    steps = card.counters["lcc_count_supersteps"]
    assert steps == sum(x.phase == "LP" for x in card.rows) > 0
    assert card.counters["lcc_count_fused"] == steps and card.counters["lcc_count_passes"] == 0
    assert cpu.counters["lcc_count_fused"] == 0 and cpu.counters["lcc_count_passes"] > 0
    assert trace._current.get() is None
    assert lcc_bucketed.init_superstep is lf.init_superstep
