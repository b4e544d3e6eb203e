"""The harness's graph builder against the port's ``graph.csr.from_edges``
and ``degree_labels``, field for field, on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import graphgen
from fuzzypatternmatching_tpu_torch.graph.csr import degree_labels, from_edges

CPU = torch.device("cpu")


def gen(scale):
    return dict(scale=scale, edge_factor=16, a=0.57, b=0.19, c=0.19, d=0.05, stream_seed=5489)


@pytest.mark.parametrize("scale,seed", [(8, 1), (9, 2**31 + 7), (10, 3), (11, 12345), (12, 2**33 + 1)])
def test_csr_equals_from_edges(scale, seed):
    src, dst = graphgen.permuted_stream(gen(scale), seed, CPU)
    want = from_edges(src.numpy(), dst.numpy(), num_vertices=1 << scale)
    got = graphgen.build_graph(gen(scale), seed, CPU)
    for f in ("row_ptr", "cols", "rev_edge", "raw_degree", "edge_row"):
        a, b = got[f], getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(got["labels"], degree_labels(want))
    assert got["labels"].dtype == degree_labels(want).dtype
    assert got["num_vertices"] == want.num_vertices


def test_stream_follows_the_configuration():
    g = gen(10)
    u, v = graphgen.rmat_stream(g, CPU)
    assert len(u) == len(v) == 16 << 10
    assert int(u.min()) >= 0 and int(max(u.max(), v.max())) < 1 << 10
    # the top level picks its quadrant from (a, b, c, d) before any noise
    lo_u, lo_v = u < 512, v < 512
    for share, want in (
        (lo_u & lo_v, 0.57), (lo_u & ~lo_v, 0.19), (~lo_u & lo_v, 0.19), (~lo_u & ~lo_v, 0.05),
    ):
        assert abs(float(share.double().mean()) - want) < 0.015
    u2, v2 = graphgen.rmat_stream(g, CPU)
    assert torch.equal(u, u2) and torch.equal(v, v2)


def test_seeds_give_isomorphic_graphs():
    a = graphgen.build_graph(gen(10), 1, CPU)
    b = graphgen.build_graph(gen(10), 2, CPU)
    again = graphgen.build_graph(gen(10), 1, CPU)
    np.testing.assert_array_equal(a["cols"], again["cols"])
    assert len(a["cols"]) == len(b["cols"])
    assert not np.array_equal(a["cols"], b["cols"])
    np.testing.assert_array_equal(np.sort(a["raw_degree"]), np.sort(b["raw_degree"]))
