"""The port's mesh LCC engine (fuzzypatternmatching_tpu_torch/parallel/
sharded.py) on CPU meshes of 1, 2, 3 and 8 shards, against the JAX
package's ShardedLccEngine on the same number of virtual CPU devices
(tests/conftest.py): the mirror of tests/test_sharded.py.

Each case runs a global init call of two supersteps on both engines, then
continues both from the same flat state with token-passing marks on every
fifth alive edge for one more (JAX compiles one program per call length); after each call every PhaseRow (av, ae, messages,
the per-rank counters), the died flag, ``tv_host`` and ``alive_pairs`` are
compared. Modes: the default, ``num_ranks=4``, counting and edge metadata
(both with 4 ranks; against the JAX engine on 8 devices, ``JAX_N_FIXED``). Also: hub rows split across chunks, an edge-free
lowest vertex, and a per-shard working set that shrinks with n. Every
value is an integer or a flag: exact equality. The JAX side of each case is
computed once per module.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fuzzypatternmatching_tpu.graph.csr import degree_labels
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.parallel.sharded import ShardedLccEngine as JaxSharded
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine, _HostState
from fuzzypatternmatching_tpu_torch.parallel.mesh import Mesh
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_torch_counting import port_graph, port_pattern
from test_torch_lcc_bucketed import _rmat_edges

MESH_SIZES = [1, 2, 3, 8]
MODES = {
    "default": {"num_ranks": 1},
    "ranks4": {"num_ranks": 4},
    "counting": {"num_ranks": 4, "counting": True},
    "meta": {"num_ranks": 4, "meta": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_mesh(n):
    devs = jax.devices()[:n]
    assert len(devs) == n, "tests/conftest.py must provide 8 virtual devices"
    return JaxMesh(np.array(devs), ("x",))


def cpu_mesh(n):
    return build_mesh(shards=n, device="cpu")


@pytest.fixture(scope="module")
def s10(tmp_path_factory):
    """R-MAT s10 (split hubs at every n), degree labels, the tree corpus,
    and symmetric edge metadata over {55, 56} (56 is no pattern edge's)."""
    src, dst = _rmat_edges(10)
    gj = jax_from_edges(src, dst, num_vertices=1 << 10)
    labels = degree_labels(gj)
    pj, _ = jax_builtin.load_tree_pattern(str(tmp_path_factory.mktemp("tree")))
    rng = np.random.RandomState(7)
    vals = rng.choice([55, 56], p=[0.9, 0.1], size=gj.num_edges)
    ed = np.where(gj.edge_row < gj.cols, vals, vals[np.maximum(gj.rev_edge, 0)])
    vv, allow = pj.edge_meta_tables()
    code = np.where(ed == 55, 0, len(vv)).astype(np.int64)
    return gj, labels, pj, (allow, code)


def _kw(s10, mode):
    kw = dict(MODES[mode])
    em = s10[3] if kw.pop("meta", False) else None
    return {**kw, "edge_meta": em}


def _calls(eng, steps=(2, 1)):
    """Init call, then a continuation from the flat state (with TP marks)
    of the init call, of ``steps`` supersteps each: per call (rows, died,
    tv, alive pairs)."""
    st, rows, died = eng.lcc_call(eng.init_state(), True, n_steps=steps[0])
    out = [(rows, died, eng.tv_host(st).copy(), [a.copy() for a in eng.alive_pairs(st)])]
    tv, alive = eng.state_to_global(st)
    flag = np.zeros_like(alive)
    flag[np.nonzero(alive)[0][::5]] = True
    st2, rows2, died2 = eng.lcc_call(
        eng.state_from_global(tv, alive, flag), False, n_steps=steps[1]
    )
    out.append((rows2, died2, eng.tv_host(st2).copy(), [a.copy() for a in eng.alive_pairs(st2)]))
    return out


# The modes whose JAX programs take longest to compile (10-17 s a mesh size
# on the CPU) are compared at every n with the JAX engine on 8 devices; the
# JAX engine's result does not depend on n (tests/test_sharded.py).
JAX_N_FIXED = {"counting": 8, "meta": 8}

_jax_cache: dict = {}


def _jax_calls(s10, n, mode):
    n = JAX_N_FIXED.get(mode, n)
    key = (n, mode)
    if key not in _jax_cache:
        gj, labels, pj, _ = s10
        _jax_cache[key] = _calls(JaxSharded(gj, labels, pj, mesh=jax_mesh(n), **_kw(s10, mode)))
    return _jax_cache[key]


def assert_calls_equal(got, want):
    for (rows, died, tv, pairs), (rows_j, died_j, tv_j, pairs_j) in zip(got, want):
        assert [r[:3] for r in rows] == [r[:3] for r in rows_j]
        for r, rj in zip(rows, rows_j):
            for key in ("av", "ae", "msg"):
                assert np.array_equal(r[3][key], rj[3][key]), key
        assert died == died_j
        assert tv.dtype == tv_j.dtype == np.uint32 and np.array_equal(tv, tv_j)
        for a, aj in zip(pairs, pairs_j):
            assert np.array_equal(a, aj)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", MESH_SIZES)
def test_supersteps_equal_jax_sharded(s10, n, mode):
    gj, labels, pj, _ = s10
    eng = ShardedLccEngine(
        port_graph(gj), labels, port_pattern(pj), mesh=cpu_mesh(n), **_kw(s10, mode)
    )
    assert eng.n == n
    got = _calls(eng)
    assert got[0][0][0][1] > 0, "the init superstep must keep edges alive"
    assert_calls_equal(got, _jax_calls(s10, n, mode))


def test_hub_rows_split_across_chunks(s10):
    """A star: the hub's row (63 of 126 edges) spans several of the 16-edge
    chunks of an 8-shard mesh and is combined at its owner."""
    _, _, pj, _ = s10
    v = 64
    src = np.concatenate([np.zeros(v - 1), np.arange(1, v)]).astype(np.int64)
    dst = np.concatenate([np.arange(1, v), np.zeros(v - 1)]).astype(np.int64)
    gj = jax_from_edges(src, dst, num_vertices=v)
    labels = degree_labels(gj)
    eng = ShardedLccEngine(port_graph(gj), labels, port_pattern(pj), mesh=cpu_mesh(8))
    assert gj.row_ptr[1] > eng.ec
    want = _calls(JaxSharded(gj, labels, pj, mesh=jax_mesh(8)))
    assert_calls_equal(_calls(eng), want)


@pytest.mark.parametrize("n", [1, 2])
def test_isolated_lowest_vertex(s10, n):
    """Vertex 0 without edges (rowstart[0] != 0): the n = 1 row-tv exchange
    is not the identity then."""
    _, _, pj, _ = s10
    src, dst = _rmat_edges(10)
    gj = jax_from_edges(src + 1, dst + 1, num_vertices=(1 << 10) + 1)
    assert gj.row_ptr[1] == 0
    labels = degree_labels(gj)
    eng = ShardedLccEngine(port_graph(gj), labels, port_pattern(pj), mesh=cpu_mesh(n))
    assert not eng._tv_identity
    got = _calls(eng)
    assert got[0][0][0][1] > 0
    assert_calls_equal(got, _calls(JaxSharded(gj, labels, pj, mesh=jax_mesh(n))))


def test_empty_trailing_chunks(s10):
    """Fewer edges than shards: the trailing chunks are empty."""
    _, _, pj, _ = s10
    src, dst = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    gj = jax_from_edges(src, dst, num_vertices=3)
    labels = degree_labels(gj)
    eng = ShardedLccEngine(port_graph(gj), labels, port_pattern(pj), mesh=cpu_mesh(8))
    assert_calls_equal(_calls(eng), _calls(JaxSharded(gj, labels, pj, mesh=jax_mesh(8))))


def test_per_device_elems_shrinks_with_n(s10):
    """The halo plane holds O((V + E)/n + cut) per shard, not O(V + E)."""
    gj, labels, pj, _ = s10
    g, p = port_graph(gj), port_pattern(pj)
    e1 = ShardedLccEngine(g, labels, p, mesh=cpu_mesh(1))
    e8 = ShardedLccEngine(g, labels, p, mesh=cpu_mesh(8))
    assert e8.per_device_elems() < 0.3 * e1.per_device_elems()
    assert e8.ec <= -(-e1.ec // 8) + 1


def test_lazy_state_and_updates_roundtrip(s10):
    """The driver's host state (the alive pairs) with with_updates marks,
    made a mesh state (``_state_from_pairs``), gives the same continuation
    as the device state it stands for."""
    gj, labels, pj, _ = s10
    drv = MatchEngine(port_graph(gj), labels, port_pattern(pj), [], mesh=cpu_mesh(3),
                      nlcc_mode="host")
    eng = drv.lcc
    st, _, _ = eng.lcc_call(eng.init_state(), True, n_steps=2)
    tv = eng.tv_host(st).copy()
    ids = eng.alive_edge_ids(st)
    marks = list(ids[::7])
    arow, acol = eng.alive_pairs(st)
    host = drv._with_updates(_HostState(tv, arow, acol, np.empty(0, np.int64)), tv, marks)
    assert isinstance(host, _HostState) and np.array_equal(host.marks, np.unique(marks))
    dense = drv._with_updates(eng.state_from_edge_ids(tv, ids), tv, marks)
    lazy = drv._state_from_pairs(host.tv, host.arow, host.acol, host.marks)
    out = [eng.lcc_call(s, False) for s in (lazy, dense)]
    assert [r[:3] for r in out[0][1]] == [r[:3] for r in out[1][1]]
    assert np.array_equal(eng.tv_host(out[0][0]), eng.tv_host(out[1][0]))
    assert np.array_equal(eng.alive_edge_ids(out[0][0]), eng.alive_edge_ids(out[1][0]))


def test_default_device_needs_a_card(s10):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gj, labels, pj, _ = s10
    with pytest.raises(RuntimeError):
        ShardedLccEngine(port_graph(gj), labels, port_pattern(pj))
    with pytest.raises(RuntimeError):
        build_mesh()
    with pytest.raises(RuntimeError):
        Mesh(["cuda"])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [1, 3])
def test_superstep_gathers_each_shard_in_one_call(s10, n, mode, monkeypatch):
    """The default branch of a non-init superstep makes one payload-gather
    call per shard, over all of the shard's buckets (the same rows as the
    per-bucket formula: test_supersteps_equal_jax_sharded); the init
    superstep, counting and metadata make no such call."""
    from fuzzypatternmatching_tpu_torch.parallel import sharded

    gj, labels, pj, _ = s10
    eng = ShardedLccEngine(
        port_graph(gj), labels, port_pattern(pj), mesh=cpu_mesh(n), **_kw(s10, mode)
    )
    calls = {"gather_accept_or_payload": 0}
    real = sharded.gather_accept_or_payload

    def call(*args):
        calls["gather_accept_or_payload"] += 1
        assert len(args) == 4, "the engine leaves the pack to the wrapper"
        assert args[3] == eng.bucket_dims and len(args[3]) == len(eng.ell_buckets)
        assert args[0].shape == (eng.S,) and args[1].shape == (eng.n_ellrows,)
        return real(*args)

    monkeypatch.setattr(sharded, "gather_accept_or_payload", call)
    st, rows, _ = eng.lcc_call(eng.init_state(), True, n_steps=3)
    assert len(rows) == 3
    plain = mode in ("default", "ranks4")
    assert calls == {k: 2 * n if plain else 0 for k in calls}
