"""The torch superstep ops (fuzzypatternmatching_tpu_torch/ops/lcc_superstep.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_pallas_ops.py runs them, and against numpy. Everything
compared is an integer bitset, flag or count, so the tolerance is exact
equality.

The CUDA kernels are held against their plain twins by the tests marked
``cuda``; they skip where there is no card. JAX is imported only by the
tests that compare with it, so the ``cuda`` tests also run where JAX is not
installed, without tests/conftest.py (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_ops.py
"""

import numpy as np
import pytest
import torch

from fuzzypatternmatching_tpu_torch.ops import lcc_superstep as ops

DENSITIES = [0.005, 0.6, 1.0]
NARROW_SHAPES = [(n, w) for w in (8, 16, 128) for n in (0, 1, 33)]


@pytest.fixture(scope="module")
def jax_ops():
    from fuzzypatternmatching_tpu.ops import lcc_superstep

    return lcc_superstep


def _as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _rev_inputs(rng, n, w, S=500, density=0.5):
    alive = rng.rand(S + 1) < density
    alive[S] = False  # pad slot
    rev = rng.randint(0, S + 1, size=(n, w)).astype(np.int32)
    rev[:, -1] = S  # pad sentinel
    return alive, rev


def _gather_inputs(rng, n, w, V=300, density=0.6):
    tv = rng.randint(0, 1 << 16, size=V + 1).astype(np.int32)
    tv[rng.rand(V + 1) < 0.5] = 0
    tv[V] = 0  # pad entry
    adj = rng.randint(0, V + 1, size=(n, w)).astype(np.int32)
    adj[:, -1] = V  # pad sentinel
    alive_rev = rng.rand(n, w) < density
    mask = rng.randint(0, 1 << 16, size=n).astype(np.int32)
    return tv, adj, alive_rev, mask


def _gather_numpy(tv, adj, alive_rev, mask):
    p = tv[adj]
    send_ok = (p != 0) & alive_rev
    p = np.where(send_ok, p, 0)
    accept = (p & mask[:, None]) != 0
    tn = np.bitwise_or.reduce(np.where(accept, p, 0), axis=1).astype(np.int32)
    return tn, accept, send_ok.sum(axis=1).astype(np.int32)


def _words_numpy(bits, n_words):
    """Bool flags -> n_words uint32 words, bit i of word j = flag 32 j + i."""
    padded = np.zeros(n_words * 32, dtype=np.uint64)
    padded[: len(bits)] = bits
    shifts = np.arange(32, dtype=np.uint64)
    return (padded.reshape(-1, 32) << shifts).sum(axis=1).astype(np.uint32)


def _summary_numpy(alive, group_log2, n_words):
    """One bit per group of 2**group_log2 flags, in n_words words."""
    g = 1 << group_log2
    groups = -(-len(alive) // g)
    padded = np.zeros(groups * g, dtype=bool)
    padded[: len(alive)] = alive
    return _words_numpy(padded.reshape(groups, g).any(axis=1), n_words)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_pack_alive_bits_equal_jax(jax_ops, n):
    import jax.numpy as jnp

    flags = np.random.RandomState(n).rand(n) < 0.3
    flags[-1] = True  # a set high bit in the last word when n % 32 == 0
    got = _as_u32(ops.pack_alive(torch.from_numpy(flags)))
    want = np.asarray(jax_ops.pack_alive(jnp.asarray(flags)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "n, budget",
    [(0, 16), (1, 16), (700, 16), (1025, 16), (5000, 64), (40000, 16),
     (40000, 96 * 1024), (300001, 256)],
)
def test_alive_table_summary_equals_numpy(n, budget):
    """Words and summary of the table twin against numpy; the last flag is
    the always-dead pad slot. The budgets force G from 32 up to 1024."""
    rng = np.random.RandomState(n + budget)
    alive = rng.rand(n) < 0.01
    if n:
        alive[-1] = False
    t = ops.alive_table(torch.from_numpy(alive), budget)
    g = t.group_log2
    assert g == ops.summary_group_log2(n, budget)
    assert g >= 5 and (g == 5 or 4 * ops._summary_words(n, g - 1) > budget)
    assert t.summary.shape[0] % 4 == 0 and 4 * t.summary.shape[0] <= max(budget, 16)
    assert np.array_equal(
        _as_u32(t.summary), _summary_numpy(alive, g, t.summary.shape[0])
    )
    assert np.array_equal(_as_u32(t.words), _words_numpy(alive, -(-n // 32)))


def test_summary_group_sizes():
    """G = 128 at the s21 slot count, 1024 at 8x that (about s24's)."""
    assert ops.summary_group_log2(90_776_129) == 7
    assert ops.summary_group_log2(8 * 90_776_129) == 10
    assert ops.summary_group_log2(1) == 5


@pytest.mark.parametrize("shape", [(5, 8), (33, 16), (100, 128), (3, 8192)])
def test_rev_alive_lookup_matches_pallas(jax_ops, shape):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    alive, rev = _rev_inputs(rng, *shape)
    table = ops.alive_table(torch.from_numpy(alive))
    got = ops.rev_alive_lookup(torch.from_numpy(rev), table)
    want = jax_ops.rev_alive_lookup(
        jnp.asarray(rev), jax_ops.pack_alive(jnp.asarray(alive)),
        interpret=True,
    )
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), alive[rev])


@pytest.mark.parametrize("density", [0.005, 0.6])
@pytest.mark.parametrize("shape", [(33, 8), (40, 128)])
def test_rev_alive_lookup_density_matches_pallas(jax_ops, shape, density):
    import jax.numpy as jnp

    rng = np.random.RandomState(int(density * 1000) + shape[1])
    alive, rev = _rev_inputs(rng, *shape, S=20000, density=density)
    got = ops.rev_alive_lookup(
        torch.from_numpy(rev), ops.alive_table(torch.from_numpy(alive))
    )
    want = jax_ops.rev_alive_lookup(
        jnp.asarray(rev), jax_ops.pack_alive(jnp.asarray(alive)),
        interpret=True,
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(7, 8), (50, 64), (2, 8192)])
def test_gather_accept_or_matches_pallas(jax_ops, shape):
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    tv, adj, alive_rev, mask = _gather_inputs(rng, *shape)
    tn, accept, sendok = ops.gather_accept_or(
        torch.from_numpy(adj), torch.from_numpy(alive_rev),
        torch.from_numpy(mask), torch.from_numpy(tv),
    )
    tn_j, accept_j, sendok_j = jax_ops.gather_accept_or(
        jnp.asarray(adj), jnp.asarray(alive_rev),
        jnp.asarray(mask.astype(np.uint16)), jnp.asarray(tv.astype(np.uint16)),
        interpret=True,
    )
    assert (tn.dtype, accept.dtype, sendok.dtype) == (
        torch.int32, torch.bool, torch.int32,
    )
    assert np.array_equal(tn.numpy(), np.asarray(tn_j).astype(np.int32))
    assert np.array_equal(accept.numpy(), np.asarray(accept_j))
    assert np.array_equal(sendok.numpy(), np.asarray(sendok_j))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n, w", NARROW_SHAPES)
def test_gather_accept_or_density_matches_pallas(jax_ops, n, w, density):
    """The twin against numpy, and against the Pallas kernel where it takes
    the shape (its row tiling needs n >= 1)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(n * 3 + w)
    tv, adj, alive_rev, mask = _gather_inputs(rng, n, w, density=density)
    got = ops.gather_accept_or(
        torch.from_numpy(adj), torch.from_numpy(alive_rev),
        torch.from_numpy(mask), torch.from_numpy(tv),
    )
    for g, want in zip(got, _gather_numpy(tv, adj, alive_rev, mask)):
        assert np.array_equal(g.numpy(), want)
    if n:
        want_j = jax_ops.gather_accept_or(
            jnp.asarray(adj), jnp.asarray(alive_rev),
            jnp.asarray(mask.astype(np.uint16)),
            jnp.asarray(tv.astype(np.uint16)), interpret=True,
        )
        for g, want in zip(got, want_j):
            assert np.array_equal(g.numpy(), np.asarray(want).astype(g.numpy().dtype))


@pytest.mark.parametrize("w", [1, 3, 8, 24, 8192])
def test_row_or_matches_numpy(w):
    x = np.random.RandomState(w).randint(0, 1 << 16, size=(6, w)).astype(np.int32)
    x[x % 3 == 0] = 0
    got = ops.row_or(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.bitwise_or.reduce(x, axis=1))


def test_wrappers_reject_wrong_dtypes():
    table = ops.alive_table(torch.zeros(40, dtype=torch.bool))
    rev = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        ops.rev_alive_lookup(rev, table)
    with pytest.raises(ValueError):
        ops.rev_alive_lookup(rev.int(), table.words)
    with pytest.raises(ValueError):
        ops.alive_table(torch.zeros(40, dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.alive_table(torch.zeros(40, dtype=torch.bool), 2 * ops.SUMMARY_BUDGET_BYTES)
    adj = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.gather_accept_or(
            adj, torch.zeros((2, 8), dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int16),
        )
    with pytest.raises(ValueError):
        ops.gather_accept_or(
            adj, torch.zeros((2, 8), dtype=torch.bool),
            torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
        )


def test_twins_count_no_launches_on_cpu():
    ops.reset_launches()
    rng = np.random.RandomState(3)
    alive, rev = _rev_inputs(rng, 4, 8)
    ops.rev_alive_lookup(torch.from_numpy(rev), ops.alive_table(torch.from_numpy(alive)))
    tv, adj, alive_rev, mask = _gather_inputs(rng, 4, 8)
    ops.gather_accept_or(
        torch.from_numpy(adj), torch.from_numpy(alive_rev),
        torch.from_numpy(mask), torch.from_numpy(tv),
    )
    assert ops.launches == {
        "pack_alive": 0, "rev_alive_lookup": 0, "gather_accept_or": 0,
    }


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _table_on_cuda_equals_twin(alive, dev, budget=ops.SUMMARY_BUDGET_BYTES):
    flags = torch.from_numpy(alive)
    got = ops.alive_table(flags.to(dev), budget)
    torch.cuda.synchronize()
    want = ops.alive_table_reference(flags, budget)
    assert got.group_log2 == want.group_log2
    assert torch.equal(got.words.cpu(), want.words)
    assert torch.equal(got.summary.cpu(), want.summary)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 128, 1024, 8192])
@pytest.mark.parametrize("n", [0, 1, 1000])
def test_kernels_match_twins_on_cuda(cuda_device, n, w):
    rng = np.random.RandomState(n * 7 + w)
    alive, rev = _rev_inputs(rng, n, w, S=70000)
    table, table_cpu = _table_on_cuda_equals_twin(alive, cuda_device)
    rev_t = torch.from_numpy(rev)
    got = ops.rev_alive_lookup(rev_t.to(cuda_device), table)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ops.rev_alive_lookup_reference(rev_t, table_cpu))

    tv, adj, alive_rev, mask = _gather_inputs(rng, n, w, V=50000)
    for m in (mask, np.zeros_like(mask), np.full_like(mask, 0xFFFF)):
        args = [torch.from_numpy(a) for a in (adj, alive_rev, m, tv)]
        got = ops.gather_accept_or(*[a.to(cuda_device) for a in args])
        torch.cuda.synchronize()
        want = ops.gather_accept_or_reference(*args)
        for g, r in zip(got, want):
            assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n, budget",
    [(0, 16), (1, 16), (700, 16), (1025, 16), (5000, 64), (40000, 16),
     (40000, 96 * 1024), (300001, 256)],
)
@pytest.mark.parametrize("density", DENSITIES)
def test_alive_table_and_lookup_on_cuda(cuda_device, n, budget, density):
    rng = np.random.RandomState(n + budget)
    alive = rng.rand(n) < density
    if n:
        alive[-1] = False  # pad slot
    table, table_cpu = _table_on_cuda_equals_twin(alive, cuda_device, budget)
    if n:
        rev = rng.randint(0, n, size=4099).astype(np.int32)
        rev[-1] = n - 1
        rev_t = torch.from_numpy(rev)
        got = ops.rev_alive_lookup(rev_t.to(cuda_device), table)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ops.rev_alive_lookup_reference(rev_t, table_cpu))
        # an odd offset takes the kernel's unaligned path
        got = ops.rev_alive_lookup(rev_t.to(cuda_device)[1:], table)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ops.rev_alive_lookup_reference(rev_t[1:], table_cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n, w", NARROW_SHAPES)
def test_gather_accept_or_density_on_cuda(cuda_device, n, w, density):
    rng = np.random.RandomState(n * 3 + w)
    tv, adj, alive_rev, mask = _gather_inputs(rng, n, w, density=density)
    args = [torch.from_numpy(a) for a in (adj, alive_rev, mask, tv)]
    got = ops.gather_accept_or(*[a.to(cuda_device) for a in args])
    torch.cuda.synchronize()
    for g, r in zip(got, ops.gather_accept_or_reference(*args)):
        assert torch.equal(g.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 4])
@pytest.mark.parametrize("w", [1, 2, 4, 24, 32, 64, 256, 384, 512, 2048, 4096])
@pytest.mark.parametrize("n", [1, 33, 300])
def test_gather_accept_or_every_lane_mapping_on_cuda(cuda_device, n, w, offset):
    """Every lane mapping of the gather kernel, and its fallbacks: planes
    at an offset of 1 or 4 bytes into a larger buffer are not 16-byte
    aligned."""
    rng = np.random.RandomState(n * 11 + w + offset)
    tv, adj, alive_rev, mask = _gather_inputs(rng, n, w, V=5000)
    args = [torch.from_numpy(a) for a in (adj, alive_rev, mask, tv)]
    dev_args = [a.to(cuda_device) for a in args]
    buf = torch.zeros(n * w + offset, dtype=torch.bool, device=cuda_device)
    buf[offset:] = dev_args[1].view(-1)
    dev_args[1] = buf[offset:].view(n, w)
    got = ops.gather_accept_or(*dev_args)
    torch.cuda.synchronize()
    for g, r in zip(got, ops.gather_accept_or_reference(*args)):
        assert torch.equal(g.cpu(), r)
