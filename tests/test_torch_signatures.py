"""The port binds positional arguments as the JAX package does.

* The 1-2-1 case: the path template 0-1-2 labelled 1-2-1 over the single
  edge 0-1 labelled 1, 2, with the positional arguments ``(1, "bucketed",
  None, 1 << 16, "auto", 1 << 12, True)`` after the constraints. The 11th
  argument is ``superstep_timing`` in both packages, so both keep the same
  vertices (the JAX engine keeps 0 and 1; a port that read it as
  ``counting`` kept none).
* ``build_mesh(4, True)`` is a 2-D mesh of 4 shards in both packages.
* Every public function and class that a module of both packages defines
  (found by scanning the sources' top-level ``def`` and ``class``
  statements) has parameter lists where one package's positional names are
  a prefix of the other's. Exempt: ``rev_alive_lookup`` (its packed table
  is the port's design) and the internal containers ``Bucket`` and
  ``ShardedState``, whose fields the port changed by design.
"""

import ast
import importlib
import inspect
import os

import numpy as np
import pytest

from fuzzypatternmatching_tpu.engine.driver import MatchEngine as JaxMatchEngine
from fuzzypatternmatching_tpu.graph.csr import from_edges as jax_from_edges
from fuzzypatternmatching_tpu.pattern.pattern_graph import PatternGraph as JaxPatternGraph
from fuzzypatternmatching_tpu.utils.dist import build_mesh as jax_build_mesh
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.graph.csr import from_edges
from fuzzypatternmatching_tpu_torch.pattern.pattern_graph import PatternGraph
from fuzzypatternmatching_tpu_torch.utils.dist import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "fuzzypatternmatching_tpu", "fuzzypatternmatching_tpu_torch"
EXEMPT = {"rev_alive_lookup", "Bucket", "ShardedState"}


def _public_defs(pkg):
    """{module path relative to the package: public top-level def/class
    names}, from the sources."""
    root = os.path.join(REPO, pkg)
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
            out[rel] = {
                n.name for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and not n.name.startswith("_")
            }
    return out


def _shared_names():
    jax_defs, port_defs = _public_defs(JAX_PKG), _public_defs(PORT_PKG)
    return sorted(
        (mod, name)
        for mod in set(jax_defs) & set(port_defs)
        for name in jax_defs[mod] & port_defs[mod]
        if name not in EXEMPT
    )


SHARED = _shared_names()


def _positional(obj):
    fn = obj.__init__ if inspect.isclass(obj) else obj
    params = list(inspect.signature(fn).parameters.values())
    if inspect.isclass(obj):
        params = params[1:]  # self
    return [p.name for p in params
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _path_121(cls):
    return cls(
        vertex_count=3,
        edge_count=4,
        row_ptr=np.array([0, 1, 3, 4]),
        cols=np.array([1, 0, 2, 1]),
        vertex_data=np.array([1, 2, 1], dtype=np.uint64),
        diameter=2,
    )


POSITIONAL_121 = (1, "bucketed", None, 1 << 16, "auto", 1 << 12, True)


def test_positional_arguments_keep_the_same_vertices():
    src = np.array([0, 1], dtype=np.int64)
    dst = np.array([1, 0], dtype=np.int64)
    labels = np.array([1, 2], dtype=np.uint64)
    jax_r = JaxMatchEngine(
        jax_from_edges(src, dst, num_vertices=2), labels,
        _path_121(JaxPatternGraph), [], *POSITIONAL_121,
    ).run()
    port_engine = MatchEngine(
        from_edges(src, dst, num_vertices=2), labels,
        _path_121(PatternGraph), [], *POSITIONAL_121, device="cpu",
    )
    assert port_engine.superstep_timing and not port_engine.counting
    port_r = port_engine.run()
    assert sorted(jax_r.active_vertices) == [0, 1]
    assert sorted(port_r.active_vertices) == sorted(jax_r.active_vertices)
    assert port_r.trace() == jax_r.trace()


def test_build_mesh_positional_two_d():
    mesh, mesh_j = build_mesh(4, True, device="cpu"), jax_build_mesh(4, True)
    assert mesh.axis_names == mesh_j.axis_names == ("host", "chip")
    assert mesh.shape == mesh_j.devices.shape == (1, 4)


def test_the_scan_finds_the_shared_entry_points():
    names = {name for _, name in SHARED}
    assert {"MatchEngine", "build_mesh", "ShardedLccEngine",
            "BucketedLccEngine", "gather_accept_or"} <= names


@pytest.mark.parametrize("mod,name", SHARED, ids=[f"{m}.{n}" for m, n in SHARED])
def test_positional_names_are_a_prefix(mod, name):
    jax_obj = getattr(importlib.import_module(f"{JAX_PKG}.{mod}"), name)
    port_obj = getattr(importlib.import_module(f"{PORT_PKG}.{mod}"), name)
    a, b = _positional(jax_obj), _positional(port_obj)
    k = min(len(a), len(b))
    assert a[:k] == b[:k], f"{mod}.{name}: JAX {a}, port {b}"
