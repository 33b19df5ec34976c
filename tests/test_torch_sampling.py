"""The port's threefry chain and seeded categorical sampling against `jax.random`.

`repro_torch.core.prng` is jax's threefry2x32 in torch integer ops. On the
CPU, against jax 0.9.0 as installed: key data of `PRNGKey(seed)` ->
`fold_in(rid)` -> `fold_in(pos)` bit-equal over a grid with 0 and 2**31-1;
32-bit random bits and uniforms bit-equal for rows of 32000 and 1000;
gumbel noise within rtol=1e-6, atol=1e-6 (float32 `log` differs by about
an ulp between XLA's and torch's CPU builds); categorical draws, the
`TokenSampler`'s and the specdec `seeded_scores`' first-index argmaxes equal
to the reference's for 256 (rid, pos) pairs. The settings these depend on
are asserted first, so that a jax upgrade that changes them fails loudly.
The `cuda` test holds the card's draws to the CPU port's; it skips here.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.specdec import ops as jspecdec
from repro.launch.scheduler import TokenSampler as JSampler
from repro_torch.core import prng
from repro_torch.kernels.specdec import ops as specdec
from repro_torch.launch.scheduler import TokenSampler

GUMBEL_TOL = dict(rtol=1e-6, atol=1e-6)
GRID = (0, 1, 3, 17, 4096, 2 ** 31 - 1)
# 256 (rid, pos) pairs, 32 rows of each of 8 rids
PAIRS = [(rid, pos) for rid in (0, 1, 2, 5, 11, 100, 12345, 2 ** 31 - 1)
         for pos in range(0, 320, 10)]
VOCAB = 1000


def _jkey(seed, rid, pos):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rid), pos)


def _tkey(seed, rid, pos):
    return prng.fold_in(prng.fold_in(prng.seed_key(seed), rid), pos)


def _rows(n, v, seed=0):
    return np.random.default_rng(seed).normal(scale=2.0, size=(n, v)).astype(np.float32)


def test_jax_settings_the_port_copies():
    """The port copies the partitionable threefry and the low-range gumbel:
    a jax that changes either must fail here, not in a stream."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_high_dynamic_range_gumbel is False


def test_known_answer():
    """PRNGKey(0) -> fold_in(3) -> fold_in(17), as jax 0.9.0 gives it."""
    assert _tkey(0, 3, 17).tolist() == [667729679, 229813208]
    assert np.asarray(_jkey(0, 3, 17)).tolist() == [667729679, 229813208]


@pytest.mark.parametrize("seed", GRID)
def test_key_data_bit_equal(seed):
    assert prng.seed_key(seed).tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()
    for rid in GRID:
        for pos in GRID:
            assert _tkey(seed, rid, pos).tolist() == np.asarray(_jkey(seed, rid, pos)).tolist()


def test_batched_fold_in_and_request_keys():
    """fold_in over a (B,) tensor of data, and the (rid, pos) keys of a
    (B, T) grid, equal the scalar chain."""
    root = prng.seed_key(7)
    rids = torch.tensor([0, 4, 2 ** 31 - 1])
    batched = prng.fold_in(root, rids)
    for b, rid in enumerate(rids.tolist()):
        assert batched[b].tolist() == prng.fold_in(root, rid).tolist()
    positions = torch.tensor([[0, 1], [9, 10], [5, 2 ** 31 - 1]])
    keys = prng.request_keys(root, rids, positions)
    assert keys.shape == (3, 2, 2)
    for b in range(3):
        for t in range(2):
            want = np.asarray(_jkey(7, int(rids[b]), int(positions[b, t])))
            assert keys[b, t].tolist() == want.tolist()


@pytest.mark.parametrize("n", [32000, 1000])
def test_bits_and_uniforms_bit_equal(n):
    for seed, rid, pos in ((0, 3, 17), (7, 2 ** 31 - 1, 0)):
        jk, tk = _jkey(seed, rid, pos), _tkey(seed, rid, pos)
        jbits = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits32(tk, n).numpy(), jbits)
        # the ranges the samplers draw from: their scale is exactly 1
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
            ju = np.asarray(jax.random.uniform(jk, (n,), minval=lo, maxval=hi))
            tu = prng.uniform(tk, n, lo, hi).numpy()
            np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


def test_bits_do_not_depend_on_the_row_length():
    """Partitionable threefry: element i's bits come from the counter i
    alone, so a shorter row is a prefix of a longer one."""
    k = _tkey(0, 1, 2)
    assert torch.equal(prng.random_bits32(k, 1000), prng.random_bits32(k, 32000)[:1000])


@pytest.mark.parametrize("n", [32000, 1000])
def test_gumbel_within_tolerance(n):
    for seed, rid, pos in ((0, 3, 17), (1, 9, 300)):
        want = np.asarray(jax.random.gumbel(_jkey(seed, rid, pos), (n,)))
        got = prng.gumbel(_tkey(seed, rid, pos), n).numpy()
        np.testing.assert_allclose(got, want, **GUMBEL_TOL)


def test_categorical_draws_equal_jax():
    """256 (rid, pos) draws over 1000-wide rows, one batched call."""
    rows = _rows(len(PAIRS), VOCAB)
    keys = torch.stack([_tkey(0, r, p) for r, p in PAIRS])
    got = prng.categorical(keys, torch.from_numpy(rows)).numpy()
    draw = jax.jit(jax.random.categorical)
    want = [int(draw(_jkey(0, r, p), rows[i])) for i, (r, p) in enumerate(PAIRS)]
    np.testing.assert_array_equal(got, want)


def test_categorical_full_vocab_rows():
    """Rows of tinyllama's 32000 entries, a few (rid, pos) pairs."""
    rows = _rows(4, 32000, seed=1)
    pairs = [(0, 0), (3, 17), (8, 511), (2 ** 31 - 1, 2 ** 31 - 1)]
    keys = torch.stack([_tkey(5, r, p) for r, p in pairs])
    got = prng.categorical(keys, torch.from_numpy(rows)).numpy()
    want = [int(jax.random.categorical(_jkey(5, r, p), rows[i]))
            for i, (r, p) in enumerate(pairs)]
    np.testing.assert_array_equal(got, want)


def test_token_sampler_matches_reference():
    """The port's `TokenSampler("categorical")` against the reference's, row
    by row and batched, over rows wider than the vocab (the sampler slices
    them); greedy is the first-index argmax."""
    rows = _rows(len(PAIRS), VOCAB + 24, seed=2)
    ref = JSampler("categorical", VOCAB, seed=3)
    port = TokenSampler("categorical", VOCAB, seed=3)
    want = [ref(rows[i], r, p) for i, (r, p) in enumerate(PAIRS)]
    assert [port(rows[i], r, p) for i, (r, p) in enumerate(PAIRS[:16])] == want[:16]
    got = port.pick(torch.from_numpy(rows), [r for r, _ in PAIRS], [p for _, p in PAIRS])
    np.testing.assert_array_equal(got, want)
    greedy = TokenSampler("greedy", VOCAB)
    np.testing.assert_array_equal(greedy.pick(rows, [0] * len(PAIRS), [0] * len(PAIRS)),
                                  rows[:, :VOCAB].argmax(-1))
    with pytest.raises(ValueError, match="sampling mode"):
        TokenSampler("nucleus", VOCAB)


def test_sampler_modes_are_distinct_and_deterministic():
    """After the reference's `test_sampler_modes_are_distinct_and_deterministic`."""
    vocab = 64
    logits = np.random.default_rng(0).normal(size=(vocab,)).astype(np.float32)
    greedy = TokenSampler("greedy", vocab, seed=0)
    cat = TokenSampler("categorical", vocab, seed=0)
    assert greedy(logits, 0, 5) == greedy(logits, 3, 9) == int(np.argmax(logits))
    draws = [cat(np.zeros(vocab, np.float32), 0, p) for p in range(20)]
    assert len(set(draws)) > 1
    assert draws == [TokenSampler("categorical", vocab, seed=0)(
        np.zeros(vocab, np.float32), 0, p) for p in range(20)]


def test_seeded_scores_match_reference():
    """specdec's score rows (B, T, V) against the reference's, within the
    gumbel tolerance, with equal argmaxes."""
    b, t = 8, 32
    lg = _rows(b * t, VOCAB, seed=4).reshape(b, t, VOCAB)
    rids = np.array([r for r, _ in PAIRS[::32]], np.int32)
    positions = (np.arange(t)[None] + 10 * np.arange(b)[:, None]).astype(np.int32)
    want = np.asarray(jspecdec.seeded_scores(jnp.asarray(lg), jax.random.PRNGKey(11),
                                             jnp.asarray(rids), jnp.asarray(positions),
                                             "categorical"))
    got = specdec.seeded_scores(torch.from_numpy(lg), prng.seed_key(11),
                                torch.from_numpy(rids), torch.from_numpy(positions),
                                "categorical").numpy()
    np.testing.assert_allclose(got, want, **GUMBEL_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_card_draws_equal_the_cpu_port():
    """On the card: key data, bits and uniforms bit-equal to the CPU port's,
    gumbel within 1e-6, and categorical draws over (8, 32000) fp32 rows
    equal to the CPU port's."""
    root = prng.seed_key(0)
    rids, positions = torch.arange(8) * 7, torch.arange(8) * 131 + 5
    keys = prng.request_keys(root, rids, positions)
    keys_gpu = prng.request_keys(root.cuda(), rids.cuda(), positions.cuda())
    assert torch.equal(keys_gpu.cpu(), keys)
    assert torch.equal(prng.random_bits32(keys_gpu, 32000).cpu(), prng.random_bits32(keys, 32000))
    assert torch.equal(prng.uniform(keys_gpu, 32000).cpu(), prng.uniform(keys, 32000))
    torch.testing.assert_close(prng.gumbel(keys_gpu, 32000).cpu(), prng.gumbel(keys, 32000),
                               **GUMBEL_TOL)
    rows = torch.from_numpy(_rows(8, 32000, seed=6))
    assert torch.equal(prng.categorical(keys_gpu, rows.cuda()).cpu(),
                       prng.categorical(keys, rows))
