"""The fused default-mode supersteps (fuzzypatternmatching_tpu_torch/ops/
lcc_fused.py): K1, ``init_superstep``, and K2, ``continuation_superstep``.

On the CPU the wrappers run their plain twins, held here against the JAX
package's ``BucketedLccEngine._superstep`` (one superstep of its
``lcc_call``) in both of its modes (XLA, and the Pallas kernels in
interpret mode) on the configurations of tests/test_torch_lcc_bucketed.py,
on the fuzzy optional-edge template, and on the compact path's sub-engines
of the golden tree at s13. Everything compared is an integer bitset, flag
or count, so the tolerance is exact equality.

The CUDA kernels are held against their twins by the tests marked
``cuda``; they skip where there is no card. JAX is imported only by the
tests that compare with it, so the ``cuda`` tests also run where JAX is
not installed, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_fused_superstep.py
"""

import json
import os

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine import driver, lcc_bucketed
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import (
    BucketedLccEngine,
    BucketedState,
)
from fuzzypatternmatching_tpu_torch.graph.csr import from_edges
from fuzzypatternmatching_tpu_torch.ops import lcc_fused as lf
from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops

CONFIG_NAMES = ["ranks4", "s10", "split_hubs"]  # tests/test_torch_lcc_bucketed.CONFIGS
JAX_MODE_NAMES = ["pallas", "xla"]


@pytest.fixture(scope="module")
def tlb():
    """tests/test_torch_lcc_bucketed.py, which imports JAX: its graph and
    pattern helpers and its configurations."""
    import test_torch_lcc_bucketed

    assert sorted(test_torch_lcc_bucketed.CONFIGS) == CONFIG_NAMES
    assert sorted(test_torch_lcc_bucketed.JAX_MODES) == JAX_MODE_NAMES
    return test_torch_lcc_bucketed


@pytest.fixture(scope="module")
def graph(tlb):
    """(JAX graph, labels, port graph) of R-MAT s10."""
    from fuzzypatternmatching_tpu.graph.csr import degree_labels
    from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges

    src, dst = tlb._rmat_edges(10)
    g = jax_from_edges(src, dst, num_vertices=1 << 10)
    return g, degree_labels(g), from_edges(src, dst, num_vertices=1 << 10)


@pytest.fixture(scope="module")
def tree(tlb, tmp_path_factory):
    from test_pattern import write_tree_pattern

    return tlb._patterns(write_tree_pattern(tmp_path_factory.mktemp("t")))


def _rows(stats: torch.Tensor, r: int):
    """A superstep's stats as lcc_call's row: (av, ae, msgs, per rank)."""
    row = stats.cpu().numpy()
    per = {"av": row[0:r], "ae": row[r : 2 * r], "msg": row[2 * r : 3 * r]}
    return (int(per["av"].sum()), int(per["ae"].sum()), int(per["msg"].sum()), per)


def _same_as_jax(tlb, jx, st_j, rows_j, died_j, pt, out):
    """One JAX superstep (its lcc_call of n_steps=1) against the twin's
    outputs: the row with its per-rank counters, died, tv and the alive
    set."""
    new_tv, new_alive, flag, stats = out
    assert not flag.any() and not new_alive[-1]
    tlb._same_rows(rows_j, [_rows(stats, pt.num_ranks)])
    assert died_j == bool(stats[-1])
    st_t = BucketedState(new_tv, new_alive, flag)
    assert np.array_equal(np.asarray(jx.tv_host(st_j)), pt.tv_host(st_t))
    for a, b in zip(jx.alive_pairs(st_j), pt.alive_pairs(st_t)):
        assert np.array_equal(a, b)


def _continuation_inputs(pt, tv, alive, flag):
    """The port's state from the JAX arrays, and the alive_rev plane."""
    st = pt.state_from_jax(tv, alive, flag)
    alive_rev = ops.rev_alive_lookup_reference(
        pt._rev_flat, ops.alive_table_reference(st.alive)
    )
    return st, alive_rev


def _jax_continuation(jx, pt, n_init_steps, flag_every=3):
    """A JAX state after ``n_init_steps`` supersteps from the init state,
    with token-passing marks on every ``flag_every``-th alive slot and on
    one dead slot; one more JAX superstep from it; the port's inputs of
    the same state."""
    st_j, _, _ = jx.lcc_call(jx.init_state(), True, n_steps=n_init_steps)
    tv = np.asarray(st_j.tv)
    alive = np.asarray(st_j.alive)
    flag = np.zeros_like(alive)
    flag[np.nonzero(alive)[0][::flag_every]] = True
    flag[np.nonzero(~alive[:-1])[0][:1]] = True  # a mark on a dead slot is a no-op
    tv_g, alive_g = jx.state_to_global(st_j)
    st_j = jx.state_from_global(tv_g, alive_g, flag[jx._edge_to_slot])
    out_j = jx.lcc_call(st_j, False, n_steps=1)
    return out_j, _continuation_inputs(pt, tv, alive, flag)


@pytest.mark.parametrize("jax_mode", JAX_MODE_NAMES)
@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_init_twin_matches_jax(tlb, graph, tree, config, jax_mode):
    jx, pt = tlb._engines(graph, tree, jax_mode, **tlb.CONFIGS[config])
    st_j, rows_j, died_j = jx.lcc_call(jx.init_state(), True, n_steps=1)
    out = lf.init_superstep_reference(pt._planes, pt.label_tv, pt._tmpl)
    _same_as_jax(tlb, jx, st_j, rows_j, died_j, pt, out)
    if config == "split_hubs":
        assert (pt._planes.table[:, lf.SPLIT] == 1).any()
        assert bool(out[3][-1])  # a segment heard something and died


@pytest.mark.parametrize("jax_mode", JAX_MODE_NAMES)
@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_continuation_twin_matches_jax(tlb, graph, tree, config, jax_mode):
    """From a JAX state two supersteps in, with token-passing marks set."""
    jx, pt = tlb._engines(graph, tree, jax_mode, **tlb.CONFIGS[config])
    (st_j, rows_j, died_j), (st, alive_rev) = _jax_continuation(jx, pt, 2)
    assert st.tp_flag.any() and alive_rev.any()
    out = lf.continuation_superstep_reference(
        pt._planes, st.tv, st.alive, st.tp_flag, alive_rev, pt._tmpl
    )
    _same_as_jax(tlb, jx, st_j, rows_j, died_j, pt, out)
    # the engine's own superstep is the wrapper: the twin on the CPU
    got = pt._superstep(st.tv, st.alive, st.tp_flag, init=False)
    for a, b in zip(got, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("jax_mode", JAX_MODE_NAMES)
def test_fuzzy_template_twins_match_jax(tlb, graph, tmp_path, jax_mode):
    """Optional edges with a minimum count: the keep mask's popcount rule,
    at init and in a continuation."""
    from test_fuzzy import write_fuzzy_pattern

    g, labels, gt = graph
    fuzzy = tlb._patterns(write_fuzzy_pattern(tmp_path, require_optional=True))
    assert (fuzzy[1].min_optional_edge_count > 0).any()
    jx, pt = tlb._engines((g, np.minimum(labels, 3), gt), fuzzy, jax_mode, num_ranks=2)
    assert any(pt._tmpl.opt_min)
    st_j, rows_j, died_j = jx.lcc_call(jx.init_state(), True, n_steps=1)
    _same_as_jax(tlb, jx, st_j, rows_j, died_j, pt,
                 lf.init_superstep_reference(pt._planes, pt.label_tv, pt._tmpl))
    (st_j, rows_j, died_j), (st, alive_rev) = _jax_continuation(jx, pt, 2, flag_every=2)
    _same_as_jax(tlb, jx, st_j, rows_j, died_j, pt, lf.continuation_superstep_reference(
        pt._planes, st.tv, st.alive, st.tp_flag, alive_rev, pt._tmpl))


def _golden_tree_s13():
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        meta = json.load(f)
    cfg = meta["configs"]["tree_s13"]
    return cfg, meta["num_ranks"], golden.build_config(
        cfg["scale"], os.path.join(golden.REPO, cfg["corpus"])
    )


def test_compact_sub_engines_match_jax(tlb, monkeypatch):
    """Every lcc_call of the compact path's sub-engines (driver._compact_call:
    an engine rebuilt over the alive closure, small buckets) in the golden
    tree_s13 search, against the JAX engine built over the same subgraph
    and continued from the same state."""
    from fuzzypatternmatching_tpu.engine.lcc_bucketed import BucketedLccEngine as JaxEngine
    from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges

    cfg, num_ranks, (g, labels, pattern, constraints) = _golden_tree_s13()
    calls = []
    real = BucketedLccEngine.lcc_call

    def recording(self, state, global_init_step, n_steps=None):
        if self.graph is not g:  # a sub-engine of _compact_call
            tv, alive = self.state_to_global(state)
            flag = state.tp_flag.numpy()[self._edge_to_slot]
            out = real(self, state, global_init_step, n_steps)
            calls.append((self, (tv, alive, flag), global_init_step, n_steps, out))
            return out
        return real(self, state, global_init_step, n_steps)

    monkeypatch.setattr(BucketedLccEngine, "lcc_call", recording)
    r = MatchEngine(g, labels, pattern, constraints, num_ranks=num_ranks, device="cpu").run()
    assert (len(r.active_vertices), len(r.active_edges)) == (
        cfg["active_vertices"], cfg["active_edges"])
    assert calls
    jax_pattern = tlb._patterns(os.path.join(golden.REPO, cfg["corpus"]))[0]
    for sub, (tv, alive, flag), init, n_steps, (st_t, rows_t, died_t) in calls:
        assert not init and sub.num_ranks == num_ranks
        gj = jax_from_edges(sub.graph.edge_row, sub.graph.cols,
                            num_vertices=sub.graph.num_vertices)
        assert np.array_equal(gj.cols, sub.graph.cols)
        jx = JaxEngine(gj, labels, jax_pattern, num_ranks=num_ranks)
        st_j, rows_j, died_j = jx.lcc_call(jx.state_from_global(tv, alive, flag), False, n_steps)
        tlb._same_rows(rows_j, rows_t)
        assert died_j == died_t
        tlb._same_state(jx, st_j, sub, st_t)
        assert sub.graph.num_edges < g.num_edges // 4  # the closure of the alive set


def _tiny_planes(buckets, ranks=1, code8=True, seed=0):
    import chip_smoke

    return chip_smoke.fused_case(seed, buckets, torch.device("cpu"), ranks, code8)


def test_empty_buckets_and_no_buckets():
    """A bucket with no rows adds nothing (the twin with and without it
    agree); no buckets at all give zeros and a dead pad slot."""
    planes, tmpl, state = _tiny_planes([(9, 8, False), (0, 32, False), (7, 64, False), (5, 16, True)])
    # the same planes with the empty bucket left out of the table
    dropped = planes._replace(table=planes.table[planes.table[:, lf.N] > 0])
    assert len(dropped.table) == 3
    label_tv, tv, alive, flag, alive_rev = state
    for a, b in (
        (lf.init_superstep(planes, label_tv, tmpl), lf.init_superstep(dropped, label_tv, tmpl)),
        (lf.continuation_superstep(planes, tv, alive, flag, alive_rev, tmpl),
         lf.continuation_superstep(dropped, tv, alive, flag, alive_rev, tmpl)),
    ):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # a superstep where no segment stays live: every tv zero
    out = lf.continuation_superstep(planes, torch.zeros_like(tv), alive, flag, alive_rev, tmpl)
    assert not out[0].any() and not out[1].any() and not out[3].any()
    planes, tmpl, (label_tv, *_) = _tiny_planes([], ranks=4)
    new_tv, new_alive, flag, stats = lf.init_superstep(planes, label_tv, tmpl)
    assert new_alive.shape == (1,) and not new_alive.any() and not new_tv.any()
    assert stats.shape == (13,) and not stats.any()


def test_wrappers_check_their_arguments():
    planes, tmpl, (label_tv, tv, alive, flag, alive_rev) = _tiny_planes(
        [(9, 8, False), (20, 16, True)], ranks=4
    )
    assert planes.table[1, lf.SPLIT] == 1 and planes.seg_start.numel() > 0
    s = planes.num_slots
    bad_init = [
        (planes, label_tv.to(torch.int64), tmpl),
        (planes, label_tv[:-1], tmpl),
        (planes, label_tv, tmpl._replace(mand=tmpl.mand[:-1])),
        (planes, label_tv, lf.Template(*([(1,) * 17] * 4))),
        (planes._replace(table=planes.table.astype(np.int32)), label_tv, tmpl),
        (planes._replace(adj=planes.adj[:-1]), label_tv, tmpl),
        (planes._replace(code=planes.code.to(torch.int64)), label_tv, tmpl),
        (planes._replace(seg_start=planes.seg_start[:-1]), label_tv, tmpl),
        (planes._replace(num_ranks=0), label_tv, tmpl),
        (planes._replace(own_seg=planes.own_seg[:-1]), label_tv, tmpl),
        (planes._replace(code_tv=planes.code_tv.to(torch.int64)), label_tv, tmpl),
        (tuple(planes), label_tv, tmpl),
    ]
    for args in bad_init:
        with pytest.raises(ValueError):
            lf.init_superstep(*args)
    table = planes.table.copy()
    table[1, lf.SLOT_BASE] += 8
    with pytest.raises(ValueError):
        lf.init_superstep(planes._replace(table=table), label_tv, tmpl)
    bad_cont = [
        (tv, alive[:-1], flag, alive_rev),
        (tv, alive, flag.to(torch.uint8), alive_rev),
        (tv, alive, flag, alive_rev[:s - 1]),
        (tv.to(torch.int64), alive, flag, alive_rev),
    ]
    for t, a, f, ar in bad_cont:
        with pytest.raises(ValueError):
            lf.continuation_superstep(planes, t, a, f, ar, tmpl)
    with pytest.raises(ValueError):
        lf.init_superstep(planes, label_tv.to("meta"), tmpl)
    with pytest.raises(ValueError):  # segments out of row order
        lf.build_planes([8], [np.arange(3)], [np.array([0, 2, 1])], [np.arange(3)],
                        [np.zeros((3, 8), np.int32)], [np.zeros((3, 8), np.uint8)],
                        np.zeros(2, np.int32), 10, 1, "cpu")


def test_twins_count_no_launches_on_cpu(graph, tree, tlb):
    _, pt = tlb._engines(graph, tree, "xla", num_ranks=4, max_width=16)
    lf.reset_launches()
    st, _, _ = pt.lcc_call(pt.init_state(), True)
    assert lf.launches == {"init_superstep": 0, "continuation_superstep": 0}
    assert st.alive.device.type == "cpu"


@pytest.mark.parametrize("mode", ["default", "counting", "metadata", "counting_metadata"])
def test_engine_superstep_goes_through_the_wrappers(graph, tree, tlb, monkeypatch, mode):
    """The default and the counting mode's lcc_call make one init_superstep
    and one continuation_superstep a later superstep; edge metadata, with
    the counting rule or without, keeps its own per-bucket supersteps."""
    _, labels, gt = graph
    kw = {}
    if "counting" in mode:
        kw["counting"] = True
    if "metadata" in mode:
        allow = np.full((2, tree[1].vertex_count), 0xFFFF, dtype=np.uint32)
        kw["edge_meta"] = (allow, np.zeros(gt.num_edges, dtype=np.int64))
    pt = BucketedLccEngine(gt, labels, tree[1], device="cpu", max_width=16, **kw)
    calls = {"init_superstep": 0, "continuation_superstep": 0}
    for name in calls:
        real = getattr(lcc_bucketed, name)

        def counted(*args, _name=name, _real=real):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(lcc_bucketed, name, counted)
    pt.lcc_call(pt.init_state(), True)
    d = tree[1].diameter
    want = (0, 0) if "metadata" in mode else (1, d - 1)
    assert (calls["init_superstep"], calls["continuation_superstep"]) == want


def test_compact_sub_engine_goes_through_the_wrappers(monkeypatch):
    """driver._compact_call's sub-engine is a BucketedLccEngine: its
    supersteps are continuation_superstep calls too."""
    cfg, num_ranks, (g, labels, pattern, constraints) = _golden_tree_s13()
    engines = []
    real = lf.continuation_superstep

    def recording(planes, *args):
        engines.append(planes.num_slots)
        return real(planes, *args)

    monkeypatch.setattr(lcc_bucketed, "continuation_superstep", recording)
    eng = MatchEngine(g, labels, pattern, constraints, num_ranks=num_ranks, device="cpu")
    assert isinstance(eng.lcc, driver.BucketedLccEngine)
    eng.run()
    assert engines and max(engines) < eng.lcc.num_slots  # all on sub-engines


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 4, 2000])
@pytest.mark.parametrize("code8", [True, False], ids=["code8", "code32"])
def test_fused_kernels_match_twins_on_cuda(cuda_device, ranks, code8):
    """Every engine width with a split widest bucket, rows 0/1/33/257."""
    import chip_smoke

    errs = dict.fromkeys(lf.launches, 0)
    widths = chip_smoke.FUSED_WIDTHS
    for seed in range(3):
        rng = np.random.RandomState(seed)
        n_rows = rng.choice([0, 1, 33, 257], size=len(widths))
        n_rows[-1] = 40
        buckets = [(int(n), w, w == widths[-1]) for n, w in zip(n_rows, widths)]
        lf.reset_launches()
        chip_smoke.fused_errs(*chip_smoke.fused_case(
            seed, buckets, cuda_device, ranks, code8, k=(5, 16, 1)[seed],
            density=(0.005, 0.6, 1.0)[seed]), errs)
        assert lf.launches == {"init_superstep": 1, "continuation_superstep": 1}
    assert errs == {"init_superstep": 0, "continuation_superstep": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("max_width", [16, 8192])
def test_fused_engine_on_cuda_equals_cpu(cuda_device, max_width):
    """The engine's default-mode lcc_call on the card (the kernels) and on
    the CPU (the twins): R-MAT s12, 4 ranks, split hubs; a continuation
    with token-passing marks."""
    g, labels, pattern, _ = golden.build_config(
        12, os.path.join(golden.REPO, "examples", "patterns", "0", "pattern"))
    engines = [BucketedLccEngine(g, labels, pattern, device=d, num_ranks=4, max_width=max_width)
               for d in (cuda_device, torch.device("cpu"))]
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
            assert [x[:3] for x in a] == [x[:3] for x in b]
            for x, y in zip(a, b):
                assert all(np.array_equal(x[3][k], y[3][k]) for k in ("av", "ae", "msg"))
        else:
            assert np.array_equal(a, b)
