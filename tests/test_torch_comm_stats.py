"""``ShardedLccEngine.comm_stats`` of the port against the JAX engine's.

R-MAT s12 (4-rank unscrambled stream, degree labels, the tree corpus) on
meshes of 1, 2, 3 and 4 shards: CPU shards for the port, virtual CPU
devices for the JAX engine (tests/conftest.py). Both engines build their
exchange lists at construction, so nothing is compiled or run. The useful
entries of each exchange (cross and intra, per shard), the cut edges and
the local reverse edges are equal exactly; the port's wire sizes are exact
and never larger than the JAX engine's power-of-two ones; the entry sizes
are the JAX engine's except the alive halo, which carries the port's
4-byte payload word.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from fuzzypatternmatching_tpu.graph.csr import degree_labels
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.parallel.sharded import ShardedLccEngine as JaxSharded
from fuzzypatternmatching_tpu.pattern import builtin as jax_builtin
from fuzzypatternmatching_tpu_torch.parallel.sharded import ShardedLccEngine
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

from test_torch_counting import port_graph, port_pattern
from test_torch_lcc_bucketed import _rmat_edges

EXCHANGES = ("tv_halo", "alive_halo", "partial_or")
ENTRY_BYTES = {"tv_halo": 4, "alive_halo": 4, "partial_or": 4}


@pytest.fixture(scope="module")
def s12(tmp_path_factory):
    src, dst = _rmat_edges(12)
    gj = jax_from_edges(src, dst, num_vertices=1 << 12)
    pj, _ = jax_builtin.load_tree_pattern(str(tmp_path_factory.mktemp("tree")))
    return gj, degree_labels(gj), pj


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_comm_stats_equal_the_jax_engines(s12, n):
    gj, labels, pj = s12
    jax_eng = JaxSharded(gj, labels, pj, mesh=JaxMesh(np.array(jax.devices()[:n]), ("x",)))
    eng = ShardedLccEngine(
        port_graph(gj), labels, port_pattern(pj), mesh=build_mesh(shards=n, device="cpu")
    )
    got, want = eng.comm_stats, jax_eng.comm_stats
    assert set(got) == set(want)
    for key in ("cut_edges", "local_rev_edges"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].shape == (n,)
    # every slot with a reverse edge is counted once, local or cut
    assert int(got["cut_edges"].sum() + got["local_rev_edges"].sum()) == gj.num_edges
    if n == 1:
        assert int(got["cut_edges"].sum()) == 0
    for name in EXCHANGES:
        g, w = got[name], want[name]
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["useful_cross"], w["useful_cross"])
        np.testing.assert_array_equal(g["useful_intra"], w["useful_intra"])
        assert g.get("directions", 1) == w.get("directions", 1)
        assert g["entry_bytes"] == ENTRY_BYTES[name]
        assert g["wire_entries_per_device"] <= w["wire_entries_per_device"]
        # the wire carries every useful entry of the busiest shard
        assert g["wire_entries_per_device"] >= int(np.max(g["useful_cross"] + g["useful_intra"]))
    assert got["tv_halo"]["wire_entries_per_device"] == n * eng.halo_h
    assert got["alive_halo"]["wire_entries_per_device"] == n * eng.halo_hrev
    assert got["partial_or"]["wire_entries_per_device"] == n * eng.halo_k
