"""The torch superstep ops (fuzzypatternmatching_tpu_torch/ops/lcc_superstep.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_pallas_ops.py runs them. Everything compared is an integer
bitset, flag or count, so the tolerance is exact equality.

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


@pytest.fixture(scope="module")
def jax_ops():
    from fuzzypatternmatching_tpu.ops import lcc_superstep

    return lcc_superstep


def _as_u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _rev_inputs(rng, n, w, S=500):
    alive = rng.rand(S + 1) < 0.5
    alive[S] = False  # pad slot
    rev = rng.randint(0, S + 1, size=(n, w)).astype(np.int32)
    rev[:, -1] = S  # pad sentinel
    return alive, rev


def _gather_inputs(rng, n, w, V=300):
    tv = rng.randint(0, 1 << 16, size=V + 1).astype(np.int32)
    tv[rng.rand(V + 1) < 0.5] = 0
    tv[V] = 0  # pad entry
    adj = rng.randint(0, V + 1, size=(n, w)).astype(np.int32)
    adj[:, -1] = V  # pad sentinel
    alive_rev = rng.rand(n, w) < 0.6
    mask = rng.randint(0, 1 << 16, size=n).astype(np.int32)
    return tv, adj, alive_rev, mask


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 4097])
def test_pack_alive_bits_equal_jax(jax_ops, n):
    import jax.numpy as jnp

    flags = np.random.RandomState(n).rand(n) < 0.3
    flags[-1] = True  # a set high bit in the last word when n % 32 == 0
    got = _as_u32(ops.pack_alive(torch.from_numpy(flags)))
    want = np.asarray(jax_ops.pack_alive(jnp.asarray(flags)))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(5, 8), (33, 16), (100, 128), (3, 8192)])
def test_rev_alive_lookup_matches_pallas(jax_ops, shape):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    alive, rev = _rev_inputs(rng, *shape)
    bits = ops.pack_alive(torch.from_numpy(alive))
    got = ops.rev_alive_lookup(torch.from_numpy(rev), bits)
    want = jax_ops.rev_alive_lookup(
        jnp.asarray(rev), jax_ops.pack_alive(jnp.asarray(alive)),
        interpret=True,
    )
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), alive[rev])


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


@pytest.mark.parametrize("w", [1, 3, 8, 24, 8192])
def test_row_or_matches_numpy(w):
    x = np.random.RandomState(w).randint(0, 1 << 16, size=(6, w)).astype(np.int32)
    x[x % 3 == 0] = 0
    got = ops.row_or(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.bitwise_or.reduce(x, axis=1))


def test_wrappers_reject_wrong_dtypes():
    rev = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        ops.rev_alive_lookup(rev, torch.zeros(1, dtype=torch.int32))
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
    ops.rev_alive_lookup(torch.from_numpy(rev), ops.pack_alive(torch.from_numpy(alive)))
    tv, adj, alive_rev, mask = _gather_inputs(rng, 4, 8)
    ops.gather_accept_or(
        torch.from_numpy(adj), torch.from_numpy(alive_rev),
        torch.from_numpy(mask), torch.from_numpy(tv),
    )
    assert ops.launches == {"rev_alive_lookup": 0, "gather_accept_or": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [8, 128, 1024, 8192])
@pytest.mark.parametrize("n", [0, 1, 1000])
def test_kernels_match_twins_on_cuda(cuda_device, n, w):
    rng = np.random.RandomState(n * 7 + w)
    alive, rev = _rev_inputs(rng, n, w, S=70000)
    bits = ops.pack_alive(torch.from_numpy(alive))
    rev_t = torch.from_numpy(rev)
    got = ops.rev_alive_lookup(rev_t.to(cuda_device), bits.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ops.rev_alive_lookup_reference(rev_t, bits))

    tv, adj, alive_rev, mask = _gather_inputs(rng, n, w, V=50000)
    for m in (mask, np.zeros_like(mask), np.full_like(mask, 0xFFFF)):
        args = [torch.from_numpy(a) for a in (adj, alive_rev, m, tv)]
        got = ops.gather_accept_or(*[a.to(cuda_device) for a in args])
        torch.cuda.synchronize()
        want = ops.gather_accept_or_reference(*args)
        for g, r in zip(got, want):
            assert torch.equal(g.cpu(), r)
