"""The attention kernels at the wide head dims, and flash's kernel plan.

On the CPU: at head dims 128 and 256 (granite, phi4, command-r, chameleon,
dbrx: 128; recurrentgemma: 256) the port's flash, decode and paged decode
wrappers, which run their plain versions on a CPU tensor, against the JAX
package's Pallas kernels in interpret mode, as the reference's own tests run
them; small sizes (Sq, Skv <= 80), tolerances `_flash_tol`. The JAX runs are
memoised per module. `flash_plan`, which picks the bf16 / fp16 kernel path
and the number of key splits, reads (Sq, Skv) and nothing else, so a
lane's bits cannot change with the batch; the wrapper refuses rows that are
not 16-byte aligned.

On the card (`cuda`-marked, skipped elsewhere): flash at d 128 and 256 and
at one query against the plain version; the same call twice, and 8 lanes
against the first 8 of 16, bit for bit; decode and the paged decode at d 128
and 256, the paged form bit for bit against `decode_attention(bk=bs)`.
"""

import _torch_threads  # noqa: F401

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import decode_attention as jdec
from repro.kernels.flash.flash_attention import flash_attention as jflash
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.flash.decode_attention import (decode_attention, decode_attention_ref,
                                                        gather_pages, gathered_positions,
                                                        paged_decode_attention,
                                                        paged_decode_attention_ref)
from repro_torch.kernels.flash.flash_attention import (HEAD_DIMS, MAX_SPLITS, SHORT_QUERY,
                                                       SPLIT_KEYS, SPLIT_STAGE, FlashPlan,
                                                       _check_aligned, flash_attention,
                                                       flash_plan)
from repro_torch.kernels.flash.ref import flash_attention_ref

WIDE = (128, 256)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# name -> ((B, H, KVH, Sq, Skv), causal, window)
FLASH_CASES = {
    "causal": ((1, 4, 4, 80, 80), True, None),
    "non_causal": ((1, 2, 2, 48, 80), False, None),
    "window": ((1, 2, 2, 80, 80), True, 24),
    "gqa": ((2, 4, 1, 40, 40), True, None),
    "one_query": ((2, 4, 2, 1, 77), False, None),
}
# name -> (B, H, KVH, S cache slots, written length, window)
DECODE_CASES = {"gqa": (2, 8, 2, 70, 50, None), "group16": (2, 16, 1, 70, 61, 9)}


def _tol(dt: str):
    return treg.get("flash").tol(TDT[dt])


def _bridge(*arrays):
    return [tensor_from_numpy(np.asarray(a), "cpu") for a in arrays]


@functools.lru_cache(maxsize=None)
def _pallas_flash(case: str, d: int, dt: str):
    """The case's operands (in the dtype) and the Pallas kernel's output."""
    (b, h, kvh, sq, skv), causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(d + sq)
    q, k, v = (jnp.asarray(rng.normal(size=shape), JDT[dt])
               for shape in ((b, h, sq, d), (b, kvh, skv, d), (b, kvh, skv, d)))
    want = jflash(q, k, v, causal=causal, window=window)
    return (q, k, v), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dt", list(JDT))
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_wide_heads_match_pallas(case, d, dt):
    (q, k, v), want = _pallas_flash(case, d, dt)
    _, causal, window = FLASH_CASES[case]
    got = flash_attention(*_bridge(q, k, v), causal=causal, window=window)
    assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
    rtol, atol = _tol(dt)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)
    assert native.launch_counts()["flash"] == 0


def _decode_operands(case: str, d: int, dt: str):
    b, h, kvh, s, length, _ = DECODE_CASES[case]
    rng = np.random.default_rng(d + h)
    q, k, v = (jnp.asarray(rng.normal(size=shape), JDT[dt])
               for shape in ((b, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    pos = np.where(np.arange(s)[None] < np.array([[length], [length - 7]]),
                   np.arange(s)[None], -1).astype(np.int32)
    cur = np.array([length - 1, length - 8], np.int32)
    return q, k, v, jnp.asarray(pos), jnp.asarray(cur)


@functools.lru_cache(maxsize=None)
def _pallas_decode(case: str, d: int, dt: str):
    args = _decode_operands(case, d, dt)
    want = jdec.decode_attention(*args, window=DECODE_CASES[case][-1])
    return args, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dt", list(JDT))
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_wide_heads_match_pallas(case, d, dt):
    args, want = _pallas_decode(case, d, dt)
    window = DECODE_CASES[case][-1]
    got = decode_attention(*_bridge(*args), window=window)
    assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
    rtol, atol = _tol(dt)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)
    assert native.launch_counts()["decode_attention"] == 0


def _paged_operands(d: int, dt: str, *, b=3, h=16, kvh=1, n=20, bs=8, nb=5, lens=(37, 16, 0)):
    """Ragged lanes on permuted arena rows: a partial last page, a
    page-exact lane and an empty lane."""
    rng = np.random.default_rng(d)
    q, k, v = (jnp.asarray(rng.normal(size=shape), JDT[dt])
               for shape in ((b, h, d), (n, bs, kvh, d), (n, bs, kvh, d)))
    perm = rng.permutation(n)
    tables = np.full((b, nb), -1, np.int32)
    pos = np.full((n, bs), -1, np.int32)
    for i, length in enumerate(lens):
        for j in range(-(-length // bs)):
            row = int(perm[i * nb + j])
            tables[i, j] = row
            valid = min(bs, length - j * bs)
            pos[row, :valid] = np.arange(j * bs, j * bs + valid)
    cur = np.maximum(np.asarray(lens, np.int32) - 1, 0)
    return q, k, v, jnp.asarray(pos), jnp.asarray(tables), jnp.asarray(cur)


@functools.lru_cache(maxsize=None)
def _pallas_paged(d: int, dt: str, window):
    args = _paged_operands(d, dt)
    want = jdec.paged_decode_attention(*args, window=window)
    return args, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dt", list(JDT))
@pytest.mark.parametrize("d", WIDE)
def test_paged_decode_wide_heads_match_pallas(d, dt):
    for window in (None, 9):
        args, want = _pallas_paged(d, dt, window)
        got = paged_decode_attention(*_bridge(*args), window=window)
        assert got.dtype == TDT[dt] and tuple(got.shape) == want.shape
        rtol, atol = _tol(dt)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)
    assert native.launch_counts()["paged_decode_attention"] == 0


def test_flash_plan_is_a_function_of_lengths_and_head_dim_alone():
    """The plan's only inputs are (Sq, Skv): neither the batch, the heads,
    the head dim nor the card can move a lane's key splits, so a lane's bits
    do not change with how many lanes run. Its splits are whole 64-key
    stages of SPLIT_KEYS keys or more that cover the keys exactly once;
    short queries take the short-query path."""
    assert list(inspect.signature(flash_plan).parameters) == ["sq", "skv"]
    for skv in (0, 1, 77, 300, 1500, 4096, 10 ** 6):
        for sq in (1, 7, SHORT_QUERY, SHORT_QUERY + 1, 77, 1500):
            plan = flash_plan(sq, skv)
            assert plan == flash_plan(sq, skv)
            if sq > SHORT_QUERY:
                assert plan == FlashPlan("tile", 1, 0)
                continue
            assert plan.path == "short" and 1 <= plan.n_split <= MAX_SPLITS
            assert plan.split_len >= SPLIT_KEYS and plan.split_len % SPLIT_STAGE == 0
            assert (plan.n_split - 1) * plan.split_len < max(skv, 1) <= \
                plan.n_split * plan.split_len
    # whisper-small's decode-step cross-attention: one query against 1,500 keys
    assert flash_plan(1, 1500) == FlashPlan("short", 6, 256)
    assert flash_plan(4, 1000) == FlashPlan("short", 4, 256)


def test_flash_refuses_unaligned_rows():
    """The kernel stages rows with 16-byte copies: a view whose rows start
    off a 16-byte boundary is refused, never copied; the flash route's
    (B, S, H, d) -> (B, H, S, d) transposes pass."""
    x = torch.zeros(1, 2, 4, 24, dtype=torch.bfloat16)
    _check_aligned("q", x[..., :16])
    _check_aligned("q", torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16).transpose(1, 2))
    _check_aligned("q", torch.zeros(1, 1, 1, 20)[..., :16])    # one row: no stride read
    with pytest.raises(ValueError, match="16-byte"):
        _check_aligned("q", x[..., 1:17])                      # starts 2 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        _check_aligned("k", torch.zeros(1, 2, 4, 20, dtype=torch.bfloat16)[..., :16])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _normal(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape)).to(device=device, dtype=dtype)


def _flash_on_card(dims, d, dtype, causal, window, device, rng):
    b, h, kvh, sq, skv = dims
    q = _normal(rng, (b, h, sq, d), dtype, device)
    k, v = (_normal(rng, (b, kvh, skv, d), dtype, device) for _ in range(2))
    before = native.launch_counts()["flash"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert native.launch_counts()["flash"] == before + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    rtol, atol = treg.get("flash").tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE)
def test_cuda_flash_wide_heads_match_plain_version(d, cuda_device):
    rng = np.random.default_rng(d)
    for dtype in treg.get("flash").dtypes:
        for dims, causal, window in FLASH_CASES.values():
            _flash_on_card(dims, d, dtype, causal, window, cuda_device, rng)


@pytest.mark.cuda
def test_cuda_flash_one_query_matches_plain_version(cuda_device):
    rng = np.random.default_rng(1)
    for dtype in treg.get("flash").dtypes:
        for d in HEAD_DIMS:
            for skv in (1, 77, 1500):
                _flash_on_card((8, 12, 12, 1, skv), d, dtype, False, None, cuda_device, rng)


@pytest.mark.cuda
def test_cuda_flash_is_bit_stable(cuda_device):
    """The same call twice, and 8 lanes against the first 8 of 16 at one
    query against 1,500 keys, bit for bit."""
    rng = np.random.default_rng(2)
    bf16 = torch.bfloat16
    q, k, v = (_normal(rng, (16, 12, s, 64), bf16, cuda_device) for s in (1, 1500, 1500))
    once = flash_attention(q, k, v, causal=False)
    assert torch.equal(once, flash_attention(q, k, v, causal=False))
    assert torch.equal(once[:8], flash_attention(q[:8], k[:8], v[:8], causal=False))
    qt, kt, vt = (_normal(rng, (1, 32, 512, 64), bf16, cuda_device) for _ in range(3))
    assert torch.equal(flash_attention(qt, kt, vt), flash_attention(qt, kt, vt))


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE)
def test_cuda_decode_wide_heads_match_plain_version(d, cuda_device):
    for dt in ("float32", "bfloat16"):
        rtol, atol = treg.get("decode_attention").tol(TDT[dt])
        args = [t.to(cuda_device) for t in _bridge(*_decode_operands("group16", d, dt))]
        torch.testing.assert_close(decode_attention(*args).float(),
                                   decode_attention_ref(*args).float(), rtol=rtol, atol=atol)
        q, k, v, pos, tables, cur = (t.to(cuda_device) for t in _bridge(*_paged_operands(d, dt)))
        got = paged_decode_attention(q, k, v, pos, tables, cur)
        torch.testing.assert_close(got.float(), paged_decode_attention_ref(
            q, k, v, pos, tables, cur).float(), rtol=rtol, atol=atol)
        want = decode_attention(q, gather_pages(k, tables), gather_pages(v, tables),
                                gathered_positions(pos, tables), cur, bk=k.shape[1])
        assert torch.equal(got, want)
