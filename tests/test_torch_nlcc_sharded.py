"""The port's mesh NLCC (fuzzypatternmatching_tpu_torch/parallel/
nlcc_sharded.py) on CPU meshes of 2 and 8 shards, against the JAX
package's host engine and its ShardedNlcc on as many virtual CPU devices:
the mirror of tests/test_nlcc_sharded.py.

Cases: nem cycle and path, TDS, selected-vertices aggregation (a path then
a selected constraint sharing the forwarded keys; a nem then a selected
TDS), token-source batches of 1 and 3, and metadata hop filters. Compared:
the sources, validated flags, messages (total and per rank), edge marks,
subgraphs and forwarded keys. Source batching and the hop filters are held
against the host engine only (the JAX ShardedNlcc compiles a program per
batch capacity; tests/test_nlcc_sharded.py holds it to the host engine).
Every value is an integer or a flag: exact equality.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fuzzypatternmatching_tpu.engine import nlcc as jax_nlcc
from fuzzypatternmatching_tpu.graph.csr import from_edges
from fuzzypatternmatching_tpu.parallel.nlcc_sharded import ShardedNlcc as JaxShardedNlcc
from fuzzypatternmatching_tpu_torch.engine import nlcc
from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf
from fuzzypatternmatching_tpu_torch.parallel.nlcc_sharded import ShardedNlcc
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_engine_vs_oracle import (
    _random_graph,
    selected_constraint,
    tds_selected_constraint,
    uniform_path_nem,
)
from test_nlcc_device import _assert_outcome_equal, _full_acsr, _tv_for
from test_oracle import cycle_constraint, path_constraint, tds_constraint, undirected
from test_torch_nlcc_device import _port_acsr, _port_constraint

MESH_SIZES = [2, 8]


@pytest.fixture(autouse=True)
def _jax_mesh_nlcc_without_host_fallback(monkeypatch):
    # the JAX ShardedNlcc doubles its frontier capacity up to this many
    # times before it gives up; the port sizes frontiers exactly
    monkeypatch.setenv("FPM_NLCC_MAX_DOUBLINGS", "16")


def _jax_mesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("x",))


def _runs(kind, n, acsr_j, labels, tv, cj, v, nr, fws=None, jax_mesh=True, **kw):
    """(JAX host, port mesh) outcomes of one constraint, each also held
    against the JAX ShardedNlcc when ``jax_mesh``; ``fws`` = the forwarded
    sets of (JAX host, JAX mesh, port)."""
    fh, fj, fp = fws or (None, None, None)
    c = _port_constraint(cj)
    port_eng = ShardedNlcc(v, build_mesh(shards=n, device="cpu"), num_ranks=nr)
    acsr = _port_acsr(acsr_j)
    if kind == "nem":
        host = jax_nlcc.run_nem(acsr_j, labels, tv, cj, v, num_ranks=nr, forwarded=fh)
        port = port_eng.run_nem(acsr, labels, tv, c, v, forwarded=fp, **kw)
    else:
        host = jax_nlcc.run_tds(acsr_j, labels, tv, cj, v, num_ranks=nr, forwarded=fh)
        port = port_eng.run_tds(acsr, labels, tv, c, v, forwarded=fp, **kw)
    _assert_outcome_equal(host, port)
    if jax_mesh:
        jm = JaxShardedNlcc(v, _jax_mesh(n), num_ranks=nr)
        fn = jm.run_nem if kind == "nem" else jm.run_tds
        _assert_outcome_equal(fn(acsr_j, labels, tv, cj, v, forwarded=fj, **kw), port)
    return host, port


def _forwarded_sets():
    return (jax_nlcc.ForwardedSets.empty(), jax_nlcc.ForwardedSets.empty(),
            nlcc.ForwardedSets.empty())


def _same_keys(fws, jax_mesh=True):
    fh, fj, fp = fws
    assert np.array_equal(fh.keys, fp.keys)
    if jax_mesh:
        assert np.array_equal(fj.keys, fp.keys)


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("seed", [0, 2])
def test_nem_cycle(seed, n):
    g = _random_graph(seed, v=48, e=160)
    labels = np.random.RandomState(seed + 7).randint(1, 4, size=48).astype(np.uint64)
    c = cycle_constraint()
    fws = _forwarded_sets()
    host, port = _runs("nem", n, _full_acsr(g), labels, _tv_for(labels, [c], 48), c, 48, 4, fws)
    _same_keys(fws)
    assert host.messages > 0 and len(port.edge_marks) > 0


@pytest.mark.parametrize("n", MESH_SIZES)
def test_nem_path(n):
    g = _random_graph(3, v=48, e=160)
    labels = np.random.RandomState(10).randint(1, 3, size=48).astype(np.uint64)
    c = path_constraint()
    fws = _forwarded_sets()
    _runs("nem", n, _full_acsr(g), labels, _tv_for(labels, [c], 48), c, 48, 4, fws)
    _same_keys(fws)
    assert len(fws[2].keys) > 0


@pytest.mark.parametrize("n", MESH_SIZES)
def test_tds(n):
    g = _random_graph(5, v=48, e=160)
    labels = np.random.RandomState(12).randint(1, 3, size=48).astype(np.uint64)
    c = tds_constraint()
    host, _ = _runs("tds", n, _full_acsr(g), labels, _tv_for(labels, [c], 48), c, 48, 4)
    assert len(host.subgraphs) > 0


@pytest.mark.parametrize("n", MESH_SIZES)
def test_selected_vertices_aggregation(n):
    src, dst = undirected([(0, 1), (1, 2), (2, 3), (3, 0)])
    g = from_edges(src, dst, num_vertices=4)
    labels = np.array([1, 2, 1, 2], dtype=np.uint64)
    cs = [path_constraint(), selected_constraint()]
    tv = _tv_for(labels, cs, 4)
    fws = _forwarded_sets()
    for c in cs:
        for f in fws:
            f.reset_for(c, labels, tv, 4)
        _runs("nem", n, _full_acsr(g), labels, tv, c, 4, 2, fws)
        _same_keys(fws)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_tds_selected(n):
    g = _random_graph(7, v=32, e=96)
    labels = np.ones(32, dtype=np.uint64)
    c0, c1 = uniform_path_nem(), tds_selected_constraint()
    tv = _tv_for(labels, [c0], 32)
    acsr = _full_acsr(g)
    fws = _forwarded_sets()
    _runs("nem", n, acsr, labels, tv, c0, 32, 2, fws)
    for f in fws:
        f.reset_for(c1, labels, tv, 32)
    host, _ = _runs("tds", n, acsr, labels, tv, c1, 32, 2, fws)
    assert host.validated.any()


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", MESH_SIZES)
def test_source_batching(n, batch):
    """Batches of the token sources (the -x machinery) give the unbatched
    outcome: TDS, and a nem cycle with its forwarded keys."""
    g = _random_graph(5, v=48, e=160)
    labels = np.random.RandomState(12).randint(1, 3, size=48).astype(np.uint64)
    acsr = _full_acsr(g)
    c = tds_constraint()
    _runs("tds", n, acsr, labels, _tv_for(labels, [c], 48), c, 48, 4,
          jax_mesh=False, source_batch=batch)
    c2 = cycle_constraint()
    fws = _forwarded_sets()
    _runs("nem", n, acsr, labels, _tv_for(labels, [c2], 48), c2, 48, 4, fws,
          jax_mesh=False, source_batch=batch)
    _same_keys(fws, jax_mesh=False)


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", ["nem", "tds"])
def test_metadata_hop_filters(kind, n):
    """Per-hop edge-metadata codes (``hopc``): every traversed edge must
    carry its hop's code; random symmetric codes over {0, 1}."""
    g = _random_graph(5, v=48, e=160)
    labels = np.random.RandomState(12).randint(1, 3, size=48).astype(np.uint64)
    vals = np.random.RandomState(3).randint(0, 2, size=g.num_edges)
    code = np.where(g.edge_row < g.cols, vals, vals[np.maximum(g.rev_edge, 0)]).astype(np.int64)
    c = tds_constraint() if kind == "tds" else cycle_constraint()
    tv = _tv_for(labels, [c], 48)
    hopc = np.zeros(c.cycle_length + 1, dtype=np.int64)
    acsr_j = jax_nlcc.AliveCsr.build(g, np.ones(g.num_edges, bool), np.ones(48, bool), meta=code)
    acsr = nlcc.AliveCsr(ptr=acsr_j.ptr.copy(), col=acsr_j.col.copy(), meta=acsr_j.meta.copy())
    port_eng = ShardedNlcc(48, build_mesh(shards=n, device="cpu"), num_ranks=4)
    fn_h = jax_nlcc.run_tds if kind == "tds" else jax_nlcc.run_nem
    fn_p = port_eng.run_tds if kind == "tds" else port_eng.run_nem
    host = fn_h(acsr_j, labels, tv, c, 48, num_ranks=4, hopc=hopc)
    port = fn_p(acsr, labels, tv, _port_constraint(c), 48, hopc=hopc)
    _assert_outcome_equal(host, port)
    unfiltered = fn_h(acsr_j, labels, tv, c, 48, num_ranks=4)
    assert host.messages < unfiltered.messages  # the filter removed hops


def test_walk_kernels_carry_the_walk():
    """The walk runs through the wrappers of ops/nlcc_frontier.py (their
    plain twins on the CPU, which count no launch)."""
    calls = {"expand_frontier": 0, "forward_winners": 0}
    real = {k: getattr(nf, k) for k in calls}

    def counted(name):
        def call(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return call

    g = _random_graph(0, v=48, e=160)
    labels = np.random.RandomState(7).randint(1, 4, size=48).astype(np.uint64)
    c = cycle_constraint()
    mp = pytest.MonkeyPatch()
    try:
        for k in calls:
            mp.setattr(nf, k, counted(k))
        eng = ShardedNlcc(48, build_mesh(shards=2, device="cpu"), num_ranks=4)
        eng.run_nem(_port_acsr(_full_acsr(g)), labels, _tv_for(labels, [c], 48),
                    _port_constraint(c), 48)
    finally:
        mp.undo()
    assert calls["expand_frontier"] > 0 and calls["forward_winners"] > 0


def test_large_vertex_ids_refused():
    with pytest.raises(ValueError):
        ShardedNlcc(1 << 31, build_mesh(shards=2, device="cpu"))


def test_mesh_on_a_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        build_mesh(shards=2)
