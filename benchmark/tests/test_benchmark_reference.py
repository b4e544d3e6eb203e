"""The plain reference against the port run with ``device="cpu"`` on small
seeded R-MAT graphs, under the default and the counting LCC, on the
benchmark's tree template and on the upstream's cycle template (whose cycle
constraints mark edges), and on a tree whose labels make the counting rule
prune what the default keeps; and against the port's oracle on tiny ones."""

import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import compare, graphgen
from benchmark.reference import search, template
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.oracle import MatchOracle
from fuzzypatternmatching_tpu_torch.graph.csr import Graph
from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import load_nonlocal_constraints
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import load_pattern_graph

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
TREE = os.path.join(REPO, "benchmark", "templates", "rmat_log2_tree_pattern_0")
CYCLE = os.path.join(REPO, "examples", "patterns_cycle", "0")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def graph(scale, seed):
    g = graphgen.build_graph(
        dict(scale=scale, edge_factor=16, a=0.57, b=0.19, c=0.19, d=0.05, stream_seed=5489),
        seed, torch.device("cpu"),
    )
    port = Graph(g["num_vertices"], g["row_ptr"], g["cols"], g["rev_edge"], g["raw_degree"], g["edge_row"])
    return g, port


def port_inputs(tdir):
    p = os.path.join(tdir, "pattern")
    return load_pattern_graph(p), load_nonlocal_constraints(p)


def reference(g, tdir, counting, **kw):
    return search.ReferenceSearch(g, g["labels"], template.load(tdir), counting, "cpu", **kw).run()


@pytest.mark.parametrize("counting", [False, True], ids=["default", "counting"])
@pytest.mark.parametrize(
    "tdir,scale,seed",
    [(TREE, 12, 7), (TREE, 16, 7), (TREE, 16, 2**31 + 5), (CYCLE, 13, 3), (CYCLE, 15, 3)],
    ids=["tree12", "tree16", "tree16b", "cycle13", "cycle15"],
)
def test_reference_equals_port(tdir, scale, seed, counting):
    g, port = graph(scale, seed)
    pattern, cons = port_inputs(tdir)
    got = MatchEngine(port, g["labels"], pattern, cons, counting=counting, device="cpu").run()
    ref = reference(g, tdir, counting)
    assert compare.differences(compare.plain(got), ref) == dict.fromkeys(compare.LIMITS, 0)
    assert ref["traversed_edges"] > 0


@pytest.mark.parametrize("counting", [False, True], ids=["default", "counting"])
@pytest.mark.parametrize("tdir,scale", [(TREE, 9), (CYCLE, 10)], ids=["tree", "cycle"])
def test_reference_equals_oracle(tdir, scale, counting):
    g, port = graph(scale, 11)
    pattern, cons = port_inputs(tdir)
    oracle = MatchOracle(port, g["labels"], pattern, cons, counting=counting).run()
    ref = reference(g, tdir, counting)
    got = compare.plain(oracle)
    # the oracle sums no traversed edges: its rows' messages are the count
    got["traversed_edges"] = sum(r[-1] for r in got["rows"])
    assert compare.differences(got, ref) == dict.fromkeys(compare.LIMITS, 0)


def test_counting_requirements_of_the_tree_template():
    # every template neighbour of the tree has its own label, so the counting
    # mode asks for one parent of a class where the default asks for one bit
    classes, req = template.load(TREE).label_counts()
    assert classes == [2, 3, 4, 5, 7]
    assert req.max() == 1
    np.testing.assert_array_equal(req.sum(1), [1, 3, 1, 2, 1, 3, 1])


def counting_template(tmp_path):
    """The tree with template vertex 2 relabelled 3, as vertex 0 is: vertex 1
    then needs two distinct label-3 parents under the counting LCC, where the
    default LCC asks for one. No path constraints: the LCC alone decides."""
    d = tmp_path / "tree_two_threes"
    shutil.copytree(TREE, d)
    vdata = (d / "pattern_vertex_data").read_text().replace("2 7\n", "2 3\n", 1)
    (d / "pattern_vertex_data").write_text(vdata)
    (d / "pattern_nlc").write_text("")
    (d / "pattern_non_local_constraint").write_text("")
    return str(d)


def test_counting_reference_bites_and_equals_port(tmp_path):
    tdir = counting_template(tmp_path)
    classes, req = template.load(tdir).label_counts()
    assert req[1, classes.index(3)] == 2
    g, port = graph(16, 7)
    base, cnt = reference(g, tdir, False), reference(g, tdir, True)
    # the counting rule prunes what the default rule keeps
    d = compare.differences(cnt, base)
    assert d["vertices"] > 0 and d["lp_rows"] > 0, d
    assert set(cnt["vertices"]) < set(base["vertices"])
    pattern, cons = port_inputs(tdir)
    for counting, ref in ((False, base), (True, cnt)):
        got = MatchEngine(port, g["labels"], pattern, cons, counting=counting, device="cpu").run()
        assert compare.differences(compare.plain(got), ref) == dict.fromkeys(compare.LIMITS, 0)


def test_control_fails_the_comparison():
    """The control: the reference in the program's place with every LCC call
    one superstep short breaks the fixpoint and fails the comparison."""
    g, _ = graph(16, 7)
    ref = reference(g, TREE, False)
    tmpl = template.load(TREE)
    ctl = reference(g, TREE, False, supersteps=tmpl.diameter - 1)
    d = compare.differences(ctl, ref)
    assert any(d[k] > lim for k, lim in compare.LIMITS.items()), d
    assert d["lp_rows"] >= 1 and d["traversed"] > 0
