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
    payload = torch.from_numpy(tv)
    for sends in (None, ops.sends_table(payload)):
        ops.gather_accept_or_payload(
            torch.from_numpy(adj.reshape(-1)), torch.from_numpy(mask), payload, [(8, 4)],
            sends=sends,
        )
    idx = torch.from_numpy(rev.reshape(-1))
    ops.map_alive(torch.from_numpy(alive), idx, idx, idx,
                  torch.zeros(len(alive), dtype=torch.int32))
    assert ops.launches == {
        "pack_alive": 0, "rev_alive_lookup": 0, "gather_accept_or": 0,
        "pack_sends": 0, "gather_accept_or_payload": 0, "map_alive": 0,
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


# -- the multi-device superstep's gather on payload words ---------------------
# (gather_accept_or_payload takes all of a shard's buckets in one call; on the
# card it packs the sends bits with sends_table, then gathers through them)

# the mesh engine's ELL widths (parallel/sharded.py WIDTHS), and width 1
PAYLOAD_WIDTHS = [1, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024]
SENDS_DENSITIES = [0.0, 0.005, 0.6, 1.0]
# (words, summary budget): one word; lengths that are not multiples of 32 or
# of G (5,000 words on a 16-byte summary: G = 64)
SENDS_SIZES = [(1, ops.SUMMARY_BUDGET_BYTES), (33, ops.SUMMARY_BUDGET_BYTES),
               (1000, ops.SUMMARY_BUDGET_BYTES), (5000, 16), (70001, 64)]
BUCKET_ROWS = [0, 1, 33, 1000]


def _payload_words(rng, S, density, int_min_share=0.1):
    """Payload words alive << 31 | tv (uint32 [S + 1], the last the
    appended zero word): a share of tv is 0, so alive words include
    INT_MIN (bit 31 alone), which does not send."""
    tv = rng.randint(0, 1 << 16, size=S + 1).astype(np.uint32)
    tv[rng.rand(S + 1) < int_min_share] = 0
    alive = rng.rand(S + 1) < density
    payload = tv | (alive.astype(np.uint32) << np.uint32(31))
    payload[S] = 0
    return payload


def _payload_inputs(rng, n, w, S=700, density=0.6):
    """Payload words with a zero pad word, gather indices [n, w] with pad
    sentinels S, and row masks."""
    payload = _payload_words(rng, S, density, int_min_share=0.3)
    adj = rng.randint(0, S + 1, size=(n, w)).astype(np.int32)
    adj[:, -1] = S  # pad sentinel reads the appended zero word
    mask = rng.randint(0, 1 << 16, size=n).astype(np.int32)
    return payload, adj, mask


def _payload_args(payload, adj, mask):
    return (torch.from_numpy(adj.reshape(-1)), torch.from_numpy(mask),
            torch.from_numpy(payload.view(np.int32)))


def _jax_bucket(payload, adj, mask):
    """The per-bucket arithmetic of the JAX mesh superstep
    (fuzzypatternmatching_tpu/parallel/sharded.py:900-941), in jnp on
    uint32 words: (tn, accept, sendok) as numpy."""
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32
    p_raw = jnp.asarray(payload)[jnp.asarray(adj)]
    p_b = p_raw & u32(0x7FFFFFFF)
    send_ok = (p_b != 0) & (p_raw >= u32(0x80000000))
    p_b = jnp.where(send_ok, p_b, u32(0))
    accept = (p_b & jnp.asarray(mask.astype(np.uint32))[:, None]) != 0
    tn = jax.lax.reduce(jnp.where(accept, p_b, u32(0)), np.uint32(0),
                        jax.lax.bitwise_or, dimensions=[1])
    sor = jnp.sum(send_ok, axis=1, dtype=jnp.int32)
    return np.asarray(tn).astype(np.int32), np.asarray(accept), np.asarray(sor)


def _bucket_case(k, S=60000, mask_kind="random"):
    """A shard's bucket table over every width in PAYLOAD_WIDTHS, whose
    row counts rotate through BUCKET_ROWS with ``k``; its planes, payload
    (alive density SENDS_DENSITIES[k]) and per-bucket inputs."""
    rng = np.random.RandomState(100 + k)
    payload = _payload_words(rng, S, SENDS_DENSITIES[k % len(SENDS_DENSITIES)])
    buckets, parts = [], []
    for i, w in enumerate(PAYLOAD_WIDTHS):
        nb = BUCKET_ROWS[(i + k) % len(BUCKET_ROWS)]
        adj = rng.randint(0, S + 1, size=(nb, w)).astype(np.int32)
        adj[:, -1] = S
        mask = {"random": rng.randint(0, 1 << 16, size=nb),
                "zero": np.zeros(nb), "one": np.full(nb, 0xFFFF)}[mask_kind]
        buckets.append((w, nb))
        parts.append((adj, mask.astype(np.int32)))
    revmap = np.concatenate([a.reshape(-1) for a, _ in parts]).astype(np.int32)
    masks = np.concatenate([m for _, m in parts]).astype(np.int32)
    return payload, buckets, parts, revmap, masks


@pytest.mark.parametrize("density", SENDS_DENSITIES)
@pytest.mark.parametrize("n, budget", SENDS_SIZES)
def test_sends_table_twin_matches_the_jax_sends_predicate(n, budget, density):
    """The pack twin against the sends predicate of the JAX mesh superstep
    (fuzzypatternmatching_tpu/parallel/sharded.py:900-905) in jnp, packed
    by numpy: bits and group summary; INT_MIN words and the appended zero
    word send nothing."""
    import jax.numpy as jnp

    rng = np.random.RandomState(n + budget)
    payload = _payload_words(rng, n - 1, density) if n > 1 else np.zeros(1, np.uint32)
    p_raw = jnp.asarray(payload)
    sends = np.asarray(((p_raw & jnp.uint32(0x7FFFFFFF)) != 0) & (p_raw >= jnp.uint32(0x80000000)))
    t = ops.sends_table(torch.from_numpy(payload.view(np.int32)), budget)
    assert t.group_log2 == ops.summary_group_log2(n, budget)
    assert np.array_equal(_as_u32(t.words), _words_numpy(sends, -(-n // 32)))
    assert np.array_equal(_as_u32(t.summary),
                          _summary_numpy(sends, t.group_log2, t.summary.shape[0]))
    if n > 1 and density == 1.0:
        assert (payload == 0x80000000).any() and 0 < sends.sum() < n - 1


@pytest.mark.parametrize("mask_kind", ["random", "zero", "one"])
@pytest.mark.parametrize("k", range(len(BUCKET_ROWS)))
def test_payload_buckets_twin_matches_the_jax_formula_per_bucket(k, mask_kind):
    """The grouped twin (and the wrapper on the CPU) over a bucket table of
    every width, each with 0, 1, 33 or 1000 rows, against the JAX formula
    bucket by bucket."""
    payload, buckets, parts, revmap, masks = _bucket_case(k, mask_kind=mask_kind)
    table = torch.from_numpy(payload.view(np.int32))
    args = (torch.from_numpy(revmap), torch.from_numpy(masks), table)
    got = ops.gather_accept_or_payload_reference(*args, buckets)
    want = [_jax_bucket(payload, adj, mask) for adj, mask in parts]
    assert np.array_equal(got[0].numpy(), np.concatenate([x[0] for x in want]))
    assert np.array_equal(got[1].numpy(), np.concatenate([x[1].reshape(-1) for x in want]))
    assert np.array_equal(got[2].numpy(), np.concatenate([x[2] for x in want]))
    for sends in (None, ops.sends_table(table)):
        on_cpu = ops.gather_accept_or_payload(*args, buckets, sends=sends)
        for g, x in zip(on_cpu, got):
            assert torch.equal(g, x)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n, w", [(n, w) for w in (8, 12, 24, 96, 1024) for n in (0, 1, 33)])
def test_payload_twin_matches_the_jax_superstep_formula(n, w, density):
    """The twin on one bucket against the per-bucket arithmetic of the JAX
    mesh superstep (fuzzypatternmatching_tpu/parallel/sharded.py:900-941),
    in jnp on uint32 words, and the wrapper on the CPU against the twin."""
    rng = np.random.RandomState(n * 5 + w)
    payload, adj, mask = _payload_inputs(rng, n, w, density=density)
    revmap, mask_t, table = _payload_args(payload, adj, mask)
    got = ops.gather_accept_or_payload_reference(revmap, mask_t, table, [(w, n)])
    tn, accept, sor = _jax_bucket(payload, adj, mask)
    for g, x in zip(got, (tn, accept.reshape(-1), sor)):
        assert np.array_equal(g.numpy(), x)
    for g, x in zip(ops.gather_accept_or_payload(revmap, mask_t, table, [(w, n)]), got):
        assert torch.equal(g, x)
    if n and density == 1.0:
        assert int(got[2].sum()) > 0  # the alive bit really gates


def test_payload_wrapper_checks_its_arguments():
    payload, adj, mask = _payload_inputs(np.random.RandomState(0), 4, 8)
    revmap, mask_t, table = _payload_args(payload, adj, mask)
    sends = ops.sends_table(table)
    with pytest.raises(ValueError):  # the buckets must cover the planes
        ops.gather_accept_or_payload(revmap, mask_t, table, [(8, 3)])
    with pytest.raises(ValueError):  # at least one bucket
        ops.gather_accept_or_payload(revmap[:0], mask_t[:0], table, [])
    with pytest.raises(ValueError):  # no more than the kernel's table holds
        ops.gather_accept_or_payload(
            revmap[:0], mask_t[:0], table, [(8, 0)] * (ops.MAX_BUCKETS + 1)
        )
    with pytest.raises(ValueError):
        ops.gather_accept_or_payload(revmap, mask_t, table.to(torch.int64), [(8, 4)])
    with pytest.raises(ValueError):
        ops.sends_table(table.to(torch.int64))
    # a sends table that is not this payload's: the kernel would index its
    # words and summary out of bounds, so the wrapper refuses it
    other = ops.sends_table(table[:-40])
    mismatched = [
        sends.words,  # not an AliveTable
        other,  # of a shorter payload: fewer words
        sends._replace(words=sends.words[:-1]),
        sends._replace(summary=torch.zeros(8, dtype=torch.int32)),
        sends._replace(group_log2=4),
        sends._replace(words=sends.words.to(torch.int64)),
    ]
    for bad in mismatched:
        with pytest.raises(ValueError):
            ops.gather_accept_or_payload(revmap, mask_t, table, [(8, 4)], sends=bad)
    ops.gather_accept_or_payload(revmap, mask_t, table, [(8, 4)], sends=sends)


@pytest.mark.cuda
@pytest.mark.parametrize("density", SENDS_DENSITIES)
@pytest.mark.parametrize("n, budget", SENDS_SIZES + [((1 << 22) + 5, ops.SUMMARY_BUDGET_BYTES)])
def test_sends_table_kernel_matches_twin_on_cuda(cuda_device, n, budget, density):
    rng = np.random.RandomState(n + budget)
    payload = _payload_words(rng, n - 1, density) if n > 1 else np.zeros(1, np.uint32)
    table = torch.from_numpy(payload.view(np.int32))
    ops.reset_launches()
    got = ops.sends_table(table.to(cuda_device), budget)
    torch.cuda.synchronize()
    assert ops.launches["pack_sends"] == 1
    want = ops.sends_table_reference(table, budget)
    assert got.group_log2 == want.group_log2
    assert torch.equal(got.words.cpu(), want.words)
    assert torch.equal(got.summary.cpu(), want.summary)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4])
@pytest.mark.parametrize("mask_kind", ["random", "zero", "one"])
@pytest.mark.parametrize("k", range(len(BUCKET_ROWS)))
def test_payload_kernel_matches_twin_on_cuda(cuda_device, k, mask_kind, offset):
    """The grouped gather over a bucket table of every width (every lane
    mapping; width 1 and odd row counts put later buckets off a 4-slot
    boundary) against its twin; an index plane 4 bytes into a larger
    buffer is not 16-byte aligned."""
    payload, buckets, _, revmap, masks = _bucket_case(k, mask_kind=mask_kind)
    args = (torch.from_numpy(revmap), torch.from_numpy(masks),
            torch.from_numpy(payload.view(np.int32)))
    buf = torch.zeros(revmap.size + offset // 4, dtype=torch.int32, device=cuda_device)
    buf[offset // 4 :] = args[0].to(cuda_device)
    table = args[2].to(cuda_device)
    want = ops.gather_accept_or_payload_reference(*args, buckets)
    ops.reset_launches()
    got = ops.gather_accept_or_payload(buf[offset // 4 :], args[1].to(cuda_device), table, buckets)
    torch.cuda.synchronize()
    assert ops.launches["pack_sends"] == 1 and ops.launches["gather_accept_or_payload"] == 1
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)
    sends = ops.sends_table(table)
    got = ops.gather_accept_or_payload(
        buf[offset // 4 :], args[1].to(cuda_device), table, buckets, sends=sends
    )
    torch.cuda.synchronize()
    assert ops.launches["pack_sends"] == 2 and ops.launches["gather_accept_or_payload"] == 2
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)


# -- the NLCC walk kernels (ops/nlcc_frontier.py) -----------------------------
# Inputs shared with tests/test_torch_nlcc_device.py, which holds the twins
# against numpy on the CPU; here the kernels are held against the twins.

CPU = torch.device("cpu")


def _csr_case(rng, v=300, hub=12000, zero_frac=0.2):
    """A random CSR over v vertices with one hub row of ``hub`` neighbours
    (vertex 7; neighbours repeat: the kernels do not need distinct columns)
    and a share of zero-degree rows."""
    deg = rng.randint(0, 12, size=v)
    deg[rng.rand(v) < zero_frac] = 0
    deg[7] = hub
    ptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    col = rng.randint(0, v, size=int(ptr[-1])).astype(np.int32)
    return ptr, col


EXPAND_CASES = [
    # (frontier size, hub in frontier, ok-bit density, h_next, ranks, drop)
    (0, False, 0.5, 1, 1, False),  # empty frontier
    (1, True, 0.5, 2, 4, True),  # the hub row alone
    (200, True, 0.5, 3, 1, True),
    (200, True, 0.5, 3, 4, False),
    (200, False, 0.0, 1, 4, True),  # every lane filtered
    (200, False, 1.0, 1, 1, True),  # no lane filtered
    (200, True, 0.3, -1, 4, False),  # every message kept (TDS mode)
    (2000, True, 0.02, 5, 3, True),
]


def _expand_inputs(seed, n, hub, density):
    """(ptr, col, cur, parent, ok_bits) numpy inputs of expand_frontier."""
    rng = np.random.RandomState(seed)
    ptr, col = _csr_case(rng)
    v = len(ptr) - 1
    ok = (rng.rand(v, 31) < density).astype(np.uint64)
    ok_bits = (ok << np.arange(31, dtype=np.uint64)).sum(axis=1).astype(np.uint64)
    ok_bits[rng.rand(v) < 0.5] |= np.uint64(1 << 31)  # the cycle map-key bit
    ok_bits = ok_bits.astype(np.uint32).view(np.int32)
    cur = rng.randint(0, v, size=n).astype(np.int32)
    if hub and n:
        cur[n // 2] = 7
    parent = rng.randint(0, v, size=n).astype(np.int32)
    # a third of the tokens with neighbours came from their first neighbour
    back = np.nonzero(ptr[cur + 1] > ptr[cur])[0][::3]
    parent[back] = col[ptr[cur[back]]]
    return ptr, col, cur, parent, ok_bits


def _winner_inputs(seed, n_lanes, n_keys, n_seen):
    """(keys, parents, seen): keys that repeat within the hop (n_keys
    distinct among n_lanes), parents that repeat within a key, and earlier
    keys, partly among this hop's."""
    rng = np.random.RandomState(seed)
    pool = np.unique(rng.randint(0, 1 << 40, size=max(n_keys, 1), dtype=np.int64))
    keys = pool[rng.randint(0, len(pool), size=n_lanes)]
    parents = rng.randint(0, 50, size=n_lanes).astype(np.int32)
    seen = np.concatenate([
        pool[rng.rand(len(pool)) < 0.3],
        np.unique(rng.randint(1 << 41, 1 << 42, size=n_seen, dtype=np.int64)),
    ])
    rng.shuffle(seen)
    return keys, parents, seen


WINNER_CASES = [(0, 5, 0), (1, 1, 0), (40, 40, 0), (1000, 37, 10), (5000, 4000, 300)]


def _as_torch(*arrays, dev=CPU):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(EXPAND_CASES)))
def test_expand_frontier_kernel_matches_twin(cuda_device, case):
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    n, hub, density, h, r, drop = EXPAND_CASES[case]
    arrays = _expand_inputs(case, n, hub, density)
    want = nf.expand_frontier_reference(*_as_torch(*arrays), h, r, drop)
    before = nf.launches["expand_frontier"]
    got = nf.expand_frontier(*_as_torch(*arrays, dev=cuda_device), h, r, drop)
    torch.cuda.synchronize()
    assert nf.launches["expand_frontier"] == before + (1 if want.lanes else 0)
    assert torch.equal(got.tok.cpu(), want.tok)
    assert torch.equal(got.nbr.cpu(), want.nbr)
    assert torch.equal(got.msg_per_rank.cpu(), want.msg_per_rank)
    assert got.lanes == want.lanes


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(WINNER_CASES)))
def test_forward_winners_kernel_matches_twin(cuda_device, case):
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    arrays = _winner_inputs(case, *WINNER_CASES[case])
    want = nf.forward_winners_reference(*_as_torch(*arrays))
    got = nf.forward_winners(*_as_torch(*arrays, dev=cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_nlcc_on_cuda_matches_host(cuda_device, seed):
    """The port's DeviceNlcc on the card against the port's host engine
    (held equal to the JAX package's by tests/test_torch_shared.py), for
    a cycle, a path and a TDS constraint, with 4 ranks."""
    from fuzzypatternmatching_tpu_torch.engine import nlcc
    from fuzzypatternmatching_tpu_torch.engine.nlcc_device import DeviceNlcc
    from fuzzypatternmatching_tpu_torch.graph.csr import from_edges
    from fuzzypatternmatching_tpu_torch.pattern.nonlocal_constraint import (
        NonLocalConstraint,
    )

    v = 400
    rng = np.random.RandomState(seed)
    u, w = rng.randint(0, v, size=3000), rng.randint(0, v, size=3000)
    g = from_edges(np.concatenate([u, w]), np.concatenate([w, u]), num_vertices=v)
    acsr = nlcc.AliveCsr(ptr=g.row_ptr.astype(np.int64), col=g.cols.astype(np.int64))
    labels = rng.randint(1, 4, size=v).astype(np.uint64)
    lab = np.array([1, 2, 3, 1], dtype=np.uint64)
    idx = np.array([0, 1, 2, 0], dtype=np.int64)
    cs = [
        NonLocalConstraint(lab, idx, 2, True, True, False),  # cycle
        NonLocalConstraint(lab[[0, 1, 0]], idx[[0, 1, 0]], 1, False, True, False),  # path
        NonLocalConstraint(lab[[0, 1, 0]], idx[[0, 1, 0]], 1, False, True, False,
                           enumeration=np.arange(3), is_tds=True),
    ]
    dn = DeviceNlcc(v, num_ranks=4, device=cuda_device)
    for c in cs:
        tv = np.zeros(v, dtype=np.uint32)
        for h in range(c.walk_len):
            tv |= np.where(labels == c.labels[h], np.uint32(1 << int(c.indices[h])), 0).astype(np.uint32)
        fh, fd = nlcc.ForwardedSets.empty(), nlcc.ForwardedSets.empty()
        run = nlcc.run_tds if c.is_tds else nlcc.run_nem
        host = run(acsr, labels, tv, c, v, num_ranks=4, forwarded=fh)
        dev = (dn.run_tds if c.is_tds else dn.run_nem)(acsr, labels, tv, c, v, forwarded=fd)
        assert host.messages == dev.messages > 0
        assert np.array_equal(host.sources, dev.sources)
        assert np.array_equal(host.validated, dev.validated)
        assert np.array_equal(host.msg_per_rank, dev.msg_per_rank)
        assert sorted(host.edge_marks) == sorted(dev.edge_marks)
        if c.is_tds:
            assert sorted(map(tuple, host.subgraphs.tolist())) == sorted(
                map(tuple, dev.subgraphs.tolist())
            )
        assert np.array_equal(fh.keys, fd.keys)


# -- the routes of the walk kernels -------------------------------------------
# expand_frontier keeps a summary of the hop's bit plane (one bit per 1, 2,
# 4, ... vertices, chosen from V) in each CTA's shared memory for large
# filtered hops, and reads the ok_bits word (the first design) for the
# others. forward_winners builds shared-memory tables per hash partition
# for large calls and moves a partition that outgrows its table to global
# memory; small calls take one global table (the first design).

# V: the route of a large filtered hop
ROUTE_VERTICES = {
    300: "summary-1",  # the summary is the plane
    (1 << 21) + 7: "summary-2",  # R-MAT s21 (+7: V not a multiple of 32)
    1 << 22: "summary-4",
    (1 << 23) - 5: "summary-8",
    (1 << 24) + 3: "summary-16",  # s24
}


def _sparse_expand_inputs(seed, v, n_tok=3000, rows=2000, density=0.5):
    """expand_frontier inputs over ``v`` vertices with ``rows`` non-empty
    rows (a hub row of 20,000 among them), neighbours spread over all of
    ``v``, and tokens on non-empty and on empty rows."""
    rng = np.random.RandomState(seed)
    deg = np.zeros(v, dtype=np.int64)
    full = rng.randint(0, v, size=rows)
    deg[full] = rng.randint(1, 40, size=rows)
    deg[full[0]] = 20000
    ptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    col = rng.randint(0, v, size=int(ptr[-1])).astype(np.int32)
    ok_bits = rng.randint(-(1 << 31), 1 << 31, size=v, dtype=np.int64)
    ok_bits[rng.rand(v) > density] = 0
    ok_bits = ok_bits.astype(np.int32)
    cur = np.concatenate([full[rng.randint(0, rows, size=n_tok - 100)],
                          rng.randint(0, v, size=100)]).astype(np.int32)
    parent = rng.randint(0, v, size=n_tok).astype(np.int32)
    back = np.nonzero(ptr[cur + 1] > ptr[cur])[0][::3]
    parent[back] = col[ptr[cur[back]]]
    return ptr, col, cur, parent, ok_bits


def _assert_expansion_equal(got, want):
    assert torch.equal(got.tok.cpu(), want.tok)
    assert torch.equal(got.nbr.cpu(), want.nbr)
    assert torch.equal(got.msg_per_rank.cpu(), want.msg_per_rank)
    assert got.lanes == want.lanes


@pytest.mark.cuda
@pytest.mark.parametrize("h", [0, 30, -1])
@pytest.mark.parametrize("v", list(ROUTE_VERTICES))
def test_expand_frontier_routes_match_twin(cuda_device, v, h):
    """The first and the unfiltered design, chosen from the lane count, and
    every summary size, chosen from V (forced at this lane count), against
    the twin."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    summary = ROUTE_VERTICES[v]
    arrays = _sparse_expand_inputs(v % 1000 + h, v)
    dev_arrays = _as_torch(*arrays, dev=cuda_device)
    for r, drop in ((1, True), (4, False), (5000, True)):
        want = nf.expand_frontier_reference(*_as_torch(*arrays), h, r, drop)
        assert 0 < want.lanes < nf.PLANE_MIN_LANES
        route = "unfiltered" if h < 0 else "first-design"
        assert nf.expand_route(v, h, want.lanes) == route
        assert nf.expand_route(v, h, nf.PLANE_MIN_LANES) == (summary if h >= 0 else route)
        nf.reset_launches()
        got = nf.expand_frontier(*dev_arrays, h, r, drop)
        torch.cuda.synchronize()
        assert nf.routes == {route: 1} and nf.launches["expand_frontier"] == 1
        _assert_expansion_equal(got, want)
        assert 0 < want.tok.shape[0] < want.lanes or (h < 0 and not drop)
        if h < 0:
            continue
        nf.reset_launches()
        got = nf.expand_frontier_cuda(*dev_arrays, h, r, drop, route="summary")
        torch.cuda.synchronize()
        assert nf.routes == {summary: 1}
        _assert_expansion_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [0, 30])
def test_expand_frontier_large_hop_takes_summary_route(cuda_device, h):
    """A hop of at least PLANE_MIN_LANES lanes takes the summary route by
    itself (here that many tokens on a hub row of 20,000)."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    ptr, col, cur, parent, ok_bits = _sparse_expand_inputs(h + 5, 1 << 16)
    hub = int(np.argmax(np.diff(ptr)))
    n_hub = nf.PLANE_MIN_LANES // 20000 + 50
    cur = np.concatenate([cur, np.full(n_hub, hub, dtype=np.int32)])
    parent = np.concatenate([parent, parent[:n_hub]])
    arrays = (ptr, col, cur, parent, ok_bits)
    want = nf.expand_frontier_reference(*_as_torch(*arrays), h, 4, True)
    assert want.lanes >= nf.PLANE_MIN_LANES
    nf.reset_launches()
    got = nf.expand_frontier(*_as_torch(*arrays, dev=cuda_device), h, 4, True)
    torch.cuda.synchronize()
    assert nf.routes == {"summary-1": 1}
    _assert_expansion_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["summary", "first-design"])
@pytest.mark.parametrize("h", [0, 30])
def test_expand_frontier_forced_routes_match_twin(cuda_device, route, h):
    """The summary and the first design, forced at the s21 V."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    arrays = _sparse_expand_inputs(h + 11, (1 << 21) + 7)
    want = nf.expand_frontier_reference(*_as_torch(*arrays), h, 4, True)
    got = nf.expand_frontier_cuda(*_as_torch(*arrays, dev=cuda_device), h, 4, True, route=route)
    torch.cuda.synchronize()
    _assert_expansion_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [0, 30, 31])
@pytest.mark.parametrize("v", [1, 31, 33, 3000, (1 << 21) + 7])
def test_bit_plane_matches_twin_on_cuda(cuda_device, v, h):
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    rng = np.random.RandomState(v + h)
    ok = torch.from_numpy(rng.randint(-(1 << 31), 1 << 31, size=v, dtype=np.int64).astype(np.int32))
    n_words = nf.plane_words(v)
    got = nf.bit_plane(ok.to(cuda_device), h, n_words)
    torch.cuda.synchronize()
    want = nf.bit_plane_reference(ok, h, n_words)
    assert torch.equal(got.cpu(), want)
    for g in (0, 1, 3, 5, 7):
        s_words = 4 * -(-v // (128 << g))
        summary = nf.plane_summary(got, g, s_words)
        torch.cuda.synchronize()
        assert torch.equal(summary.cpu(), nf.plane_summary_reference(want, g, s_words))


WINNER_ROUTE_CASES = WINNER_CASES + [(100000, 5000, 3000), (300000, 200000, 50000)]


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [None, 2, 64, 1000])
@pytest.mark.parametrize("case", range(len(WINNER_ROUTE_CASES)))
def test_forward_winners_partitions_match_twin(cuda_device, case, slots):
    """The partitioned winners, with shared-memory tables of the default
    size and with small ones that force partitions (all, or some) onto
    their global-memory tables."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    arrays = _winner_inputs(case, *WINNER_ROUTE_CASES[case])
    want = nf.forward_winners_reference(*_as_torch(*arrays))
    dev_arrays = _as_torch(*arrays, dev=cuda_device)
    got = nf.forward_winners_cuda(*dev_arrays, route="partition", table_slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    nf.reset_launches()
    got = nf.forward_winners(*dev_arrays)  # below WINNER_PARTITION_MIN: the first design
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    if len(arrays[0]):
        assert nf.routes == {"global-table": 1}


@pytest.mark.cuda
def test_forward_winners_large_hop_takes_partition_route(cuda_device):
    """WINNER_PARTITION_MIN entries or more take the partitioned design by
    themselves."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    arrays = _winner_inputs(11, nf.WINNER_PARTITION_MIN, 400000, 1000)
    nf.reset_launches()
    got = nf.forward_winners(*_as_torch(*arrays, dev=cuda_device))
    torch.cuda.synchronize()
    assert nf.routes == {"partition": 1}
    assert torch.equal(got.cpu(), nf.forward_winners_reference(*_as_torch(*arrays)))


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [None, 64])
def test_forward_winners_across_hops_on_cuda(cuda_device, slots):
    """Two hops: the first hop's winners join the earlier keys; keys repeat
    within each hop and across the two."""
    from fuzzypatternmatching_tpu_torch.ops import nlcc_frontier as nf

    kw = {"route": "partition", "table_slots": slots}
    keys, parents, seen = _as_torch(*_winner_inputs(9, 300000, 40000, 20000), dev=cuda_device)
    win = nf.forward_winners_cuda(keys, parents, seen, **kw)
    want = nf.forward_winners_reference(keys.cpu(), parents.cpu(), seen.cpu())
    assert torch.equal(win.cpu(), want)
    seen = torch.cat([seen, keys[win]])
    keys2 = torch.cat([keys[:100000], keys[:50000] + 1])
    parents2 = torch.cat([parents[:100000], parents[:50000]])
    got = nf.forward_winners_cuda(keys2, parents2, seen, **kw)
    torch.cuda.synchronize()
    want = nf.forward_winners_reference(keys2.cpu(), parents2.cpu(), seen.cpu())
    assert torch.equal(got.cpu(), want)
    assert 0 < int(want.sum()) < 150000


def _mode_engines(device, kind, **kw):
    """A port LCC engine over R-MAT s10 (the golden recipe, split hubs for
    the bucketed one) and the tree corpus, with random symmetric edge
    metadata over {55, 56} (56 is no pattern edge's value)."""
    import tempfile

    from fuzzypatternmatching_tpu_torch import golden
    from fuzzypatternmatching_tpu_torch.engine.lcc import LccEngine
    from fuzzypatternmatching_tpu_torch.engine.lcc_bucketed import BucketedLccEngine
    from fuzzypatternmatching_tpu_torch.pattern.builtin import load_tree_pattern

    with tempfile.TemporaryDirectory() as tmp:
        pattern, _ = load_tree_pattern(tmp)
        g, labels, _, _ = golden.build_config(10, tmp + "/0/pattern")
    rng = np.random.RandomState(7)
    vals = rng.choice([55, 56], p=[0.9, 0.1], size=g.num_edges)
    ed = np.where(g.edge_row < g.cols, vals, vals[np.maximum(g.rev_edge, 0)])
    vv, allow = pattern.edge_meta_tables()
    if kw.pop("meta"):
        kw["edge_meta"] = (allow, np.where(ed == 55, 0, len(vv)).astype(np.int64))
    if kind == "bucketed":
        return BucketedLccEngine(g, labels, pattern, device=device, num_ranks=4,
                                 max_width=16, **kw)
    return LccEngine(g, labels, pattern, num_ranks=4, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bucketed", "flat"])
@pytest.mark.parametrize(
    "mode", [{"counting": True, "meta": False}, {"counting": False, "meta": True},
             {"counting": True, "meta": True}], ids=["counting", "meta", "both"],
)
def test_mode_supersteps_on_cuda_equal_cpu(cuda_device, kind, mode):
    """Counting and metadata supersteps on the card (the kernels) against
    the same calls on the CPU (their twins): the init superstep, then the
    continuation from that state with token-passing marks, equal rows,
    died flags, tv and alive."""
    engines = [_mode_engines(d, kind, **mode) for d in (cuda_device, torch.device("cpu"))]
    ops.reset_launches()
    outs = []
    for eng in engines:
        st, rows, died = eng.lcc_call(eng.init_state(), True, n_steps=1)
        tv, alive = eng.state_to_global(st)
        flag = np.zeros_like(alive)
        flag[np.nonzero(alive)[0][::5]] = True
        st2, rows2, died2 = eng.lcc_call(eng.state_from_global(tv, alive, flag), False)
        outs.append((rows, died, tv, alive, rows2, died2, *eng.state_to_global(st2)))
    assert ops.launches["rev_alive_lookup"] > 0
    (r_c, d_c, tv_c, al_c, r2_c, d2_c, tv2_c, al2_c), cpu = outs
    r_p, d_p, tv_p, al_p, r2_p, d2_p, tv2_p, al2_p = cpu
    for a, b in ((r_c, r_p), (r2_c, r2_p)):
        assert [x[:3] for x in a] == [x[:3] for x in b]
        for x, y in zip(a, b):
            for key in ("av", "ae", "msg"):
                assert np.array_equal(x[3][key], y[3][key])
    assert d_c == d_p and d2_c == d2_p
    for x, y in ((tv_c, tv_p), (al_c, al_p), (tv2_c, tv2_p), (al2_c, al2_p)):
        assert np.array_equal(x, y)
