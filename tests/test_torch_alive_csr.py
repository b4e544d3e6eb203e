"""The port's AliveCsr (engine/nlcc.py) indexed by the alive pairs' rows,
against the dense V + 1 row pointer it replaces on the host.

On random row-sorted pair sets (rows with no pair, rows whose vertex is
not live, vertices past the last row) ``from_pairs`` expands every query
(repeated and unsorted vertices, vertices with no row, an empty query)
to exactly the (token, neighbour, position) triples of the dense
construction, whole and in slices of a small ``chunk``; its lazily built
``ptr`` equals the dense one and the JAX package's ``from_pairs`` bit for
bit; ``degrees`` is ``ptr[vs + 1] - ptr[vs]``; an AliveCsr given a dense
``ptr`` expands as the JAX package's does. ``token_sources`` and the
selected-vertices map keys over an active set equal the scans over every
vertex. Every value compared is an integer: exact equality."""

import numpy as np
import pytest

from fuzzypatternmatching_tpu.engine import nlcc as jax_nlcc
from fuzzypatternmatching_tpu_torch.engine import nlcc

from test_oracle import cycle_constraint, path_constraint, tds_constraint
from test_engine_vs_oracle import selected_constraint
from test_torch_counting import port_constraint

V = 300


def _pairs(seed, with_meta):
    """(arow, acol, tv, meta): row-sorted pairs over rows below V - 40,
    each row with 0-6 pairs, a third of the vertices dead in tv."""
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, 7, size=V - 40) * (rng.rand(V - 40) < 0.6)
    arow = np.repeat(np.arange(V - 40, dtype=np.int64), deg)
    acol = rng.randint(0, V, size=len(arow)).astype(np.int64)
    tv = rng.randint(1, 1 << 6, size=V).astype(np.uint32)
    tv[rng.rand(V) < 0.33] = 0
    meta = rng.randint(0, 9, size=len(arow)).astype(np.int64) if with_meta else None
    return arow, acol, tv, meta


def _dense(arow, acol, live, meta):
    """The dense construction: a bincount of the live pairs' rows."""
    mask = live[arow]
    ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(np.bincount(arow[mask], minlength=V), out=ptr[1:])
    return nlcc.AliveCsr(
        ptr=ptr, col=acol[mask].astype(np.int64),
        meta=None if meta is None else meta[mask],
    )


def _queries(seed):
    rng = np.random.RandomState(100 + seed)
    return [
        np.empty(0, dtype=np.int64),
        np.arange(V, dtype=np.int64),
        rng.randint(0, V, size=200).astype(np.int64),  # repeated, unsorted
        np.array([V - 1, 0, V - 1, 5, 5], dtype=np.int64),
        np.arange(V - 40, V, dtype=np.int64),  # past the last row
    ]


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int64
        assert np.array_equal(x, y)


@pytest.mark.parametrize("with_meta", [False, True], ids=["plain", "meta"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_expand_as_the_dense_pointer(seed, with_meta):
    arow, acol, tv, meta = _pairs(seed, with_meta)
    sparse = nlcc.AliveCsr.from_pairs(arow, acol, tv, V, meta=meta)
    dense = _dense(arow, acol, tv != 0, meta)
    assert sparse.rows is not None and sparse._ptr is None
    assert np.array_equal(sparse.col, dense.col)
    if with_meta:
        assert np.array_equal(sparse.meta, dense.meta)
    else:
        assert sparse.meta is None
    for vs in _queries(seed):
        _same(sparse.expand(vs), dense.expand(vs))
        _same(sparse.degrees(vs), dense.ptr[vs + 1] - dense.ptr[vs])
        for chunk in (1, 3, 17):
            got = list(sparse.expand_slices(vs, chunk=chunk))
            want = list(dense.expand_slices(vs, chunk=chunk))
            assert [g[:2] for g in got] == [w[:2] for w in want]
            for g, w in zip(got, want):
                _same(g[2:], w[2:])
    assert sparse._ptr is None  # the host walks never built the dense pointer


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lazy_ptr_equals_the_dense_one(seed):
    arow, acol, tv, _ = _pairs(seed, False)
    sparse = nlcc.AliveCsr.from_pairs(arow, acol, tv != 0, V)
    want = jax_nlcc.AliveCsr.from_pairs(arow, acol, tv != 0, V)
    got = sparse.ptr
    assert got.dtype == want.ptr.dtype == np.int64
    assert np.array_equal(got, want.ptr)
    assert np.array_equal(got, _dense(arow, acol, tv != 0, None).ptr)
    assert sparse.ptr is got  # built once
    assert np.array_equal(sparse.col, want.col)


def test_live_as_tv_or_mask():
    arow, acol, tv, meta = _pairs(3, True)
    a = nlcc.AliveCsr.from_pairs(arow, acol, tv, V, meta=meta)
    b = nlcc.AliveCsr.from_pairs(arow, acol, tv != 0, V, meta=meta)
    for x, y in ((a.rows, b.rows), (a.row_ptr, b.row_ptr), (a.col, b.col), (a.meta, b.meta)):
        assert np.array_equal(x, y)


def test_no_live_pair():
    arow, acol, _, _ = _pairs(4, False)
    e = nlcc.AliveCsr.from_pairs(arow, acol, np.zeros(V, dtype=bool), V)
    assert len(e.rows) == 0 and len(e.col) == 0
    vs = np.array([0, 7, V - 1], dtype=np.int64)
    rep, nbr, pos = e.expand(vs)
    assert len(rep) == len(nbr) == len(pos) == 0
    assert np.array_equal(e.degrees(vs), np.zeros(3, dtype=np.int64))
    assert np.array_equal(e.ptr, np.zeros(V + 1, dtype=np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_constructor_expands_as_before(seed):
    """``AliveCsr(ptr=, col=)`` (how callers hand in a CSR of their own)
    against the JAX package's AliveCsr over the same arrays."""
    arow, acol, tv, _ = _pairs(seed, False)
    dj = jax_nlcc.AliveCsr.from_pairs(arow, acol, tv != 0, V)
    d = nlcc.AliveCsr(ptr=dj.ptr.copy(), col=dj.col.copy())
    assert d.rows is None and d.num_vertices == V
    for vs in _queries(seed):
        _same(d.expand(vs), dj.expand(vs))
        _same(d.degrees(vs), dj.ptr[vs + 1] - dj.ptr[vs])
        got = list(d.expand_slices(vs, chunk=5))
        want = list(dj.expand_slices(vs, chunk=5))
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            _same(g[2:], w[2:])


@pytest.mark.parametrize(
    "make", [path_constraint, tds_constraint, cycle_constraint, selected_constraint],
    ids=["path", "tds", "cycle", "selected"],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_sources_over_the_active_set(make, seed):
    """Sources and map keys over ``act = flatnonzero(tv)`` taken before
    bits were cleared, with and without candidates, equal the scans over
    every vertex of the tv after."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, 4, size=V).astype(np.uint64)
    tv = rng.randint(0, 8, size=V).astype(np.uint32)
    act = np.flatnonzero(tv)
    tv[rng.rand(V) < 0.2] &= np.uint32(~np.uint32(1))  # bits lost since act
    c = port_constraint(make())
    cand = np.nonzero(labels == c.labels[0])[0].astype(np.int64)
    want = nlcc.token_sources(c, labels, tv)
    assert len(want) > 0
    for kw in ({"active": act}, {"active": act, "candidates": cand}):
        got = nlcc.token_sources(c, labels, tv, **kw)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(nlcc.token_sources(c, labels, tv, cand), want)
    half = cand[: len(cand) // 2]  # candidates bound the sources with active too
    assert np.array_equal(
        nlcc.token_sources(c, labels, tv, half, active=act),
        nlcc.token_sources(c, labels, tv, half),
    )
    assert np.array_equal(nlcc.map_keys_of(c, labels, tv, act), nlcc.map_keys_of(c, labels, tv))
