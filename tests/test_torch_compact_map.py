"""A search's first compact LCC phase mapped on the device
(``MatchEngine._mapped_call``), on the CPU through ``map_alive``'s twin.

Once the closure cache holds an entry, a search's first LCC phase reads the
init superstep's alive plane into the cached closure through the entry's
slot map (``ops.map_alive``): nothing is downloaded, looked up or built on
the host (counter ``compact_device_maps``). It must give what the host
route (``_host_call``: download, ``_closure``, ``state_from_edge_ids``)
gives:

* tree_s13 and cycle_s13 on every route the closure-cache tests run: the
  sub-engine's input state equal to the host route's, and the search's
  rows, active sets and subgraphs equal to the host route's and the golden
  anchors; the warm-up search maps nothing, each later one maps once;
* a cache seeded with a smaller closure: the map's count differs from the
  init superstep's, the host route runs and builds, with the same result;
* the mesh engine, ``compact=False`` and ``superstep_timing`` never map;
* a live vertex that touches no alive slot, with a row in the cached
  closure and without one: ``died`` from the kernel's touched plane as from
  the host route's mask, and as on the full engine.

The kernel against its twin on the card: the tests marked ``cuda``, which
skip here (``python -m pytest --noconftest -m cuda
tests/test_torch_compact_map.py`` on the card).
"""

import json
import os

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult
from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops
from fuzzypatternmatching_tpu_torch.utils import trace
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_torch_compact_carry import engine as route_engine
from test_torch_trace import plain, profiled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (golden configuration, route of test_torch_compact_carry.engine)
CASES = [
    ("tree_s13", "auto"), ("tree_s13", "counting"), ("cycle_s13", "host"),
    ("cycle_s13", "device"), ("cycle_s13", "auto"), ("cycle_s13", "counting"),
    ("cycle_s13", "metadata"), ("cycle_s13", "mesh"),
]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden_meta():
    with open(os.path.join(golden.GOLDEN_BASE, "golden_meta.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def configs(golden_meta):
    out = {}
    for name in ("tree_s13", "cycle_s13"):
        cfg = golden_meta["configs"][name]
        out[name] = golden.build_config(cfg["scale"], os.path.join(REPO, cfg["corpus"]))
    return out


def host_only(eng):
    """``eng`` with the mapped route off: every first phase takes the host
    route, as before the map."""
    eng._mapped_call = lambda *a: None
    return eng


def maps(r):
    return r.counters["compact_device_maps"]


def host_pairs(eng, st):
    tv, arow, acol, _ = eng._host_state(st)
    return tv.tolist(), arow.tolist(), acol.tolist()


@pytest.mark.parametrize("name,route", CASES, ids=[f"{n}-{r}" for n, r in CASES])
def test_mapped_first_phase_equals_the_host_route(
    golden_meta, configs, name, route, tmp_path, monkeypatch
):
    nr = golden_meta["num_ranks"]
    eng = route_engine(route, configs[name], nr, tmp_path)
    ref = host_only(route_engine(route, configs[name], nr, tmp_path / "ref"))
    inputs = []  # the sub-engines' input states, in order
    real_call = BucketedLccEngine.lcc_call

    def lcc_call(self, state, global_init_step, n_steps=None):
        if self is not eng.lcc and self is not ref.lcc:
            inputs.append(state)
        return real_call(self, state, global_init_step, n_steps)

    monkeypatch.setattr(BucketedLccEngine, "lcc_call", lcc_call)
    with profiled():
        first, second, third = eng.run(), eng.run(), eng.run()
        ref_first, ref_second = ref.run(), ref.run()
    mesh = route == "mesh"
    assert [maps(r) for r in (first, second, third)] == ([0, 0, 0] if mesh else [0, 1, 1])
    assert maps(ref_first) == maps(ref_second) == 0
    for r in (second, third):
        assert r.counters["compact_builds"] == r.counters["compact_subset_hits"] == 0
    assert plain(first) == plain(second) == plain(third) == plain(ref_first) == plain(ref_second)
    cfg = golden_meta["configs"][name]
    if route != "counting" or name == "cycle_s13":
        assert third.iterations == cfg["iterations"]
        assert len(third.active_vertices) == cfg["active_vertices"]
        assert len(third.active_edges) == cfg["active_edges"]
        assert sum(len(v) for v in third.subgraphs.values()) == cfg["subgraphs"]

    # one LCC phase from the init state, mapped and on the host route, and
    # the sub-engine's input against the one the host route builds
    if mesh:
        return
    lcc = eng.lcc
    init, rows1, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    tv, arow, acol, _ = eng._host_state(init)
    union, eids, sub = eng._closure(arow, acol)
    want = sub.state_from_edge_ids(tv, eids)
    assert rows1[0][1] == len(arow)  # the init superstep's ae: its alive slots
    outs = []
    for e in (eng, ref):
        inputs.clear()
        res = MatchResult()
        with profiled(), trace.search(res):
            st, died = e._lcc_calls(e.lcc.init_state(), True, 0, res, None)
        got = inputs[0]
        assert torch.equal(got.tv, want.tv) and torch.equal(got.alive, want.alive)
        assert torch.equal(got.tp_flag, want.tp_flag)
        outs.append((plain(res)["rows"], died, host_pairs(e, st), maps(res)))
    assert outs[0][:3] == outs[1][:3]
    assert (outs[0][3], outs[1][3]) == (1, 0)
    assert eng._sub_cache[4] is sub


@pytest.mark.parametrize("name", ["tree_s13", "cycle_s13"])
def test_smaller_cached_closure_takes_the_host_route(golden_meta, configs, name):
    """A cache seeded with the closure of every other post-init alive pair:
    the map writes fewer alive slots than the init superstep counted, the
    phase takes the host route and builds the whole closure, and the search
    gives the fresh engine's result; the next search maps."""
    nr = golden_meta["num_ranks"]
    eng = MatchEngine(*configs[name], num_ranks=nr, device="cpu")
    lcc = eng.lcc
    init, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    _, arow, acol, _ = eng._host_state(init)
    eng._closure(arow[::2], acol[::2])
    small = eng._sub_cache
    assert small[5] is not None
    with profiled():
        seeded, after = eng.run(), eng.run()
    assert eng._sub_cache is not small
    assert (maps(seeded), seeded.counters["compact_builds"]) == (0, 1)
    assert (maps(after), after.counters["compact_builds"]) == (1, 0)
    fresh = MatchEngine(*configs[name], num_ranks=nr, device="cpu").run()
    assert plain(seeded) == plain(after) == plain(fresh)


@pytest.mark.parametrize("route", ["full_plane", "superstep_timing", "mesh"])
def test_routes_without_a_map_never_map(golden_meta, configs, route):
    """The full plane has no closure, ``superstep_timing`` runs one LCC call
    a superstep on the full engine, and a mesh engine's closure keeps no
    slot map: none of them counts a map, and each gives the default
    engine's result."""
    nr = golden_meta["num_ranks"]
    kw = {
        "full_plane": {"compact": False, "device": "cpu"},
        "superstep_timing": {"superstep_timing": True, "device": "cpu"},
        "mesh": {"mesh": build_mesh(shards=2, device="cpu")},
    }[route]
    eng = MatchEngine(*configs["cycle_s13"], num_ranks=nr, **kw)
    with profiled():
        runs = [eng.run(), eng.run()]
    assert [maps(r) for r in runs] == [0, 0]
    if route == "mesh":
        assert eng._sub_cache is not None and eng._sub_cache[5] is None
    else:
        assert eng._sub_cache is None
    want = MatchEngine(*configs["cycle_s13"], num_ranks=nr, device="cpu").run()
    assert plain(runs[0]) == plain(runs[1]) == plain(want)


@pytest.mark.parametrize("row", ["in_closure", "no_row"])
def test_lone_live_vertex_died_from_the_touched_plane(golden_meta, configs, row):
    """A state inside the cached closure in which no vertex dies, and then a
    dead vertex x that touches no alive pair given a template bit, x with a
    row in the cached closure or with none. The mapped phase, the host route
    and the full engine return the same tv, alive pairs, LP rows and
    ``died``: raised by x alone, which the sub-engine never sees where it
    has no row, so there the flag comes from the touched plane."""
    eng = MatchEngine(*configs["cycle_s13"], num_ranks=golden_meta["num_ranks"],
                      device="cpu")
    lcc = eng.lcc
    steps = eng.pattern.diameter - 1
    state, _, _ = lcc.lcc_call(lcc.init_state(), True, n_steps=1)
    for _ in range(20):
        tv, arow, acol, _ = eng._host_state(state)
        state, _, died = eng._compact_call(tv, arow, acol, steps, None)
        if not died:
            break
    assert not died
    tv, arow, acol, _ = eng._host_state(state)
    v = np.uint64(len(tv))
    in_closure = np.zeros(len(tv), dtype=bool)
    in_closure[(eng._sub_cache[2] // v).astype(np.int64)] = True
    touched = np.zeros(len(tv), dtype=bool)
    touched[arow] = touched[acol] = True
    assert (tv[~touched] == 0).all()

    def phases(tv_in):
        out = []
        for route in ("mapped", "host", "full"):
            st = eng._state_from_pairs(tv_in, arow, acol)
            if route == "mapped":
                res = eng._mapped_call(st, [(0, len(arow), 0, None)], steps)
                assert res is not None
            elif route == "host":
                res = eng._host_call(st, steps, None)
            else:
                res = lcc.lcc_call(st, False, n_steps=steps)
            st2, rows, died = res
            out.append((host_pairs(eng, st2), [r[:3] for r in rows], bool(died)))
        return out

    calm = phases(tv)
    assert calm[0] == calm[1] == calm[2] and calm[0][2] is False
    pick = in_closure if row == "in_closure" else ~in_closure
    x = int(np.flatnonzero((tv == 0) & ~touched & pick)[0])
    tv_x = tv.copy()
    tv_x[x] = 1
    lone = phases(tv_x)
    assert lone[0] == lone[1] == lone[2]
    assert lone[0][2] is True and lone[0][0][0][x] == 0
    assert lone[0][:2] == calm[0][:2]


# -- the kernel against its twin, on the card ----------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "pad_heavy", "all_dead", "outside"])
@pytest.mark.parametrize("n", [1, 3, 4, 10_001, 300_000])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
def test_map_alive_matches_twin_on_cuda(cuda_device, kind, n, offset):
    """chip_smoke's seeded cases (a map one element in is off 16 bytes),
    the written plane, touched and both stats exact."""
    import chip_smoke

    seed = n + len(kind)
    dev = chip_smoke.map_case(seed, kind, n, offset, cuda_device)
    cpu = chip_smoke.map_case(seed, kind, n, offset, torch.device("cpu"))
    got = ops.map_alive(*dev)
    torch.cuda.synchronize()
    want = ops.map_alive_reference(*cpu)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    alive, tv = cpu[0], cpu[4]
    if kind == "all_dead":
        assert got[2].tolist() == [0, int((tv != 0).any())] and not got[1].any()
    if kind == "outside":
        assert int(got[2][0]) < int(alive.sum())
    # every live vertex touched: lone reads 0
    dev = (*dev[:4], want[1].to(torch.int32).to(cuda_device))
    assert ops.map_alive(*dev)[2].tolist() == [int(want[2][0]), 0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tree_s13", "cycle_s13"])
def test_mapped_search_on_cuda_equals_cpu(cuda_device, golden_meta, configs, name):
    """Three searches on the card, the later two mapped (one launch each),
    equal to the CPU's."""
    nr = golden_meta["num_ranks"]
    cpu = MatchEngine(*configs[name], num_ranks=nr, device="cpu").run()
    eng = MatchEngine(*configs[name], num_ranks=nr, device=cuda_device)
    eng.run()
    before = ops.launches["map_alive"]
    with profiled():
        runs = [eng.run(), eng.run()]
    assert ops.launches["map_alive"] == before + 2
    assert [maps(r) for r in runs] == [1, 1]
    assert plain(runs[0]) == plain(runs[1]) == plain(cpu)
