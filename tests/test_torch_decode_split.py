"""The split plans of the decode and verify/accept kernels, and their
contracts on the card.

On the CPU: `decode_plan`, which splits a decode call's cache over blocks,
reads the cache length and the chunk and nothing else, so a lane's bits
cannot change with the batch, and the paged form (s = nb·bs, bk = bs) takes
the plan of `decode_attention(bk=bs)` on its gathered pages; its splits are
whole chunks that tile [0, s) in order, none empty. `slice_plan`, which cuts
a verify window's score rows into column slices, reads V alone; its slices
start 16 bytes apart and cover the row. The wrappers refuse what the
kernels do not take: head dims, groups, chunks, rows off a 16-byte boundary,
empty caches and rows.

On the card (`cuda`-marked, skipped elsewhere): decode and the paged decode
against their plain versions at the serve path's shapes and at 4,096 slots;
8 lanes against the first 8 of 16 bit for bit; a lane with no valid slot;
the paged form bit for bit against `decode_attention(bk=bs)` where the plan
has several splits; `specdec` and `specdec_tree` with equal maxima planted on
both sides of a slice boundary, equal to their plain versions' ints.
"""

import _torch_threads  # noqa: F401

import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.flash.decode_attention import (CHUNKS, MAX_SPLITS, SPLIT_SLOTS,
                                                        DecodePlan, _check_kernel_surface,
                                                        _check_rows_aligned, decode_attention,
                                                        decode_attention_ref, decode_plan,
                                                        gather_pages, gathered_positions,
                                                        paged_decode_attention,
                                                        paged_decode_attention_ref)
from repro_torch.kernels.specdec.ref import verify_accept_ref, verify_accept_tree_ref
from repro_torch.kernels.specdec.specdec import (SLICE_COLS, SlicePlan, slice_plan,
                                                 verify_accept_kernel,
                                                 verify_accept_tree_kernel)


def _check_plan(s: int, bk: int) -> None:
    """The plan's splits: whole chunks, at least SPLIT_SLOTS slots (or one
    split of the whole cache), at most MAX_SPLITS, tiling [0, s) in order
    with none empty."""
    plan = decode_plan(s, bk)
    assert isinstance(plan, DecodePlan) and plan == decode_plan(s, bk)
    split = plan.chunks_per_split * bk
    assert 1 <= plan.n_split <= MAX_SPLITS and plan.chunks_per_split >= 1
    assert (plan.n_split - 1) * split < s <= plan.n_split * split
    assert split >= SPLIT_SLOTS or plan.n_split == 1


def test_decode_plan_is_a_function_of_the_lengths_alone():
    """(s, bk) and nothing else: neither the batch, the heads, the head dim
    nor the card can move a lane's splits."""
    assert list(inspect.signature(decode_plan).parameters) == ["s", "bk"]
    # the serve path: tinyllama's 544-slot cache, the served arena's 16
    # pages of 16, whisper's 160-slot cache
    assert decode_plan(544, 64) == DecodePlan(5, 2)
    assert decode_plan(256, 16) == DecodePlan(2, 8)
    assert decode_plan(160, 64) == DecodePlan(2, 2)
    assert decode_plan(4096, 64) == DecodePlan(8, 8)


@pytest.mark.parametrize("bk", CHUNKS)
def test_decode_plan_tiles_every_cache_length(bk):
    for s in range(1, 4097):
        _check_plan(s, bk)


def test_decode_plan_sweep():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=300, deadline=None, derandomize=True)
    @hyp.given(s=st.integers(1, 10 ** 8), bk=st.sampled_from(CHUNKS))
    def check(s, bk):
        _check_plan(s, bk)

    check()


@pytest.mark.parametrize("bs", CHUNKS)
def test_paged_plan_is_the_gathered_decode_plan(bs, monkeypatch):
    """The paged wrapper asks for the plan of (nb·bs, bs), the plan of
    `decode_attention(bk=bs)` on the gathered pages: both launches get the
    same splits (recorded here in place of the launch)."""
    import repro_torch.kernels.flash.decode_attention as da

    seen = []
    monkeypatch.setattr(da, "_launch", lambda name, q, args, plan: seen.append((name, plan)))
    b, h, kvh, d, nb = 2, 4, 2, 16, 40
    fake = torch.device("cuda")
    monkeypatch.setattr(da, "_device_of", lambda *_: fake)
    q = torch.zeros(b, h, d)
    arena = torch.zeros(nb * b, bs, kvh, d)
    pos = torch.zeros(nb * b, bs, dtype=torch.int32)
    tables = torch.arange(b * nb, dtype=torch.int32).reshape(b, nb)
    cur = torch.zeros(b, dtype=torch.int32)
    paged_decode_attention(q, arena, arena, pos, tables, cur)
    decode_attention(q, gather_pages(arena, tables), gather_pages(arena, tables),
                     gathered_positions(pos, tables), cur, bk=bs)
    assert [n for n, _ in seen] == ["paged_decode_attention", "decode_attention"]
    assert seen[0][1] == seen[1][1] == decode_plan(nb * bs, bs)
    assert seen[0][1].n_split > 1


@pytest.mark.parametrize("v", [1, 3, 4, 5, 100, 301, 4095, 4096, 4097, 32000, 32001, 151936])
def test_slice_plan_covers_the_row_in_aligned_slices(v):
    """V alone; slices of SLICE_COLS columns (or one of V rounded up to 4)
    start on 16-byte boundaries of an aligned fp32 row and cover [0, V),
    none starting at or past V."""
    assert list(inspect.signature(slice_plan).parameters) == ["v"]
    plan = slice_plan(v)
    assert isinstance(plan, SlicePlan) and plan == slice_plan(v)
    assert plan.slice_cols % 4 == 0 and 4 <= plan.slice_cols <= SLICE_COLS
    assert (plan.n_slice - 1) * plan.slice_cols < v <= plan.n_slice * plan.slice_cols
    assert all((i * plan.slice_cols * 4) % 16 == 0 for i in range(plan.n_slice))


def test_slice_plan_of_tinyllamas_vocab():
    assert slice_plan(32000) == SlicePlan(8, 4096)


@pytest.mark.parametrize("s,bk,match", [(0, 64, "slot"), (-3, 16, "slot"), (100, 32, "chunk"),
                                        (100, 0, "chunk")])
def test_decode_plan_refuses(s, bk, match):
    with pytest.raises(ValueError, match=match):
        decode_plan(s, bk)


def test_slice_plan_refuses_an_empty_row():
    with pytest.raises(ValueError, match="column"):
        slice_plan(0)


@pytest.mark.parametrize("h,kvh,d,chunk", [(4, 2, 48, 64), (4, 2, 512, 64), (66, 2, 64, 64),
                                           (4, 2, 64, 32), (4, 2, 64, 128)])
def test_kernel_surface_refuses(h, kvh, d, chunk):
    """Head dims outside 16..256, more than 32 query heads a kv head,
    chunks other than 8, 16, 64."""
    with pytest.raises(ValueError):
        _check_kernel_surface("decode_attention", torch.zeros(1, h, d), kvh, d, chunk)


def test_rows_off_16_bytes_are_refused():
    """The kernel stages q and K/V rows with 16-byte copies: a view that
    starts off a 16-byte boundary, or a paged arena whose block stride is
    not a multiple of 16 bytes, is refused, never copied; a layer's slice of
    a stacked arena passes."""
    cache = torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)
    stacked = torch.zeros(6, 3, 16, 2, 16, dtype=torch.bfloat16)
    _check_rows_aligned("decode_attention", cache, stacked[:, 1])
    with pytest.raises(ValueError, match="16-byte"):
        _check_rows_aligned("decode_attention", cache.reshape(-1)[1:481].view(15, 2, 16))
    odd = torch.zeros(5, 8 * 2 * 16 + 4, dtype=torch.bfloat16)[:, :8 * 2 * 16]
    with pytest.raises(ValueError, match="16-byte"):
        _check_rows_aligned("paged_decode_attention", odd.view(5, 8, 2, 16))


def test_cpu_tensors_run_the_plain_versions():
    """On the CPU the wrappers run the plain versions, which ignore the plan
    and launch nothing."""
    rng = np.random.default_rng(3)
    spec = treg.get("decode_attention")
    i = spec.make_inputs(spec.cases[0], torch.float32, rng, "cpu")
    before = native.launch_counts()["decode_attention"]
    got = decode_attention(i["q"], i["k_cache"], i["v_cache"], i["positions"], i["current"])
    want = decode_attention_ref(i["q"], i["k_cache"], i["v_cache"], i["positions"],
                                i["current"])
    assert torch.equal(got, want)
    assert native.launch_counts()["decode_attention"] == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _decode_operands(rng, b, s, h, kvh, d, lens, dtype, device):
    """Lane i holds positions 0..lens[i]-1 in its first slots, the rest
    empty, and decodes at lens[i] - 1."""
    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape)).to(device=device, dtype=dtype)

    lens = torch.as_tensor(np.asarray(lens), dtype=torch.int32, device=device)
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    return (normal((b, h, d)), normal((b, s, kvh, d)), normal((b, s, kvh, d)),
            torch.where(pos < lens[:, None], pos, -1).contiguous(), (lens - 1).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [544, 4096])
def test_cuda_decode_matches_plain_version(s, cuda_device):
    rng = np.random.default_rng(s)
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = treg.get("decode_attention").tol(dtype)
        for h, kvh, d in ((32, 4, 64), (12, 12, 64), (32, 8, 128), (16, 1, 256)):
            args = _decode_operands(rng, 8, s, h, kvh, d, rng.integers(1, s + 1, size=8),
                                    dtype, cuda_device)
            got = decode_attention(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), decode_attention_ref(*args).float(),
                                       rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [544, 4096])
def test_cuda_decode_rows_are_bit_stable(s, cuda_device):
    """8 lanes against the first 8 of 16 over several splits, and a rerun."""
    rng = np.random.default_rng(s + 1)
    for dtype in (torch.float32, torch.bfloat16):
        args = _decode_operands(rng, 16, s, 32, 4, 64, rng.integers(1, s + 1, size=16),
                                dtype, cuda_device)
        full = decode_attention(*args)
        assert torch.equal(decode_attention(*(a[:8] for a in args)), full[:8])
        assert torch.equal(decode_attention(*args), full)


@pytest.mark.cuda
def test_cuda_decode_lane_without_a_valid_slot(cuda_device):
    """Nothing written and current -1: the plain version's uniform average
    over the lane's slots, beside written lanes, over several splits."""
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = treg.get("decode_attention").tol(dtype)
        args = _decode_operands(rng, 4, 544, 32, 4, 64, [300, 0, 544, 17], dtype, cuda_device)
        torch.testing.assert_close(decode_attention(*args).float(),
                                   decode_attention_ref(*args).float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kvh,bs,nb", [(4, 8, 2, 8, 40), (4, 8, 2, 16, 24), (4, 8, 2, 64, 5),
                                           (8, 32, 4, 16, 16), (4, 8, 2, 16, 256)])
def test_cuda_paged_equals_gathered_decode_over_splits(b, h, kvh, bs, nb, cuda_device):
    """Several splits, the served arena's shape (8 lanes, 32/4 heads, 16
    pages of 16) and 4,096 slots: bit for bit against the gathered decode,
    within tolerance of the plain version."""
    rng = np.random.default_rng(bs + nb)
    spec = treg.get("paged_decode_attention")
    for dtype in spec.dtypes:
        i = spec.make_inputs(treg.ShapeCase("splits", (b, h, kvh, b * nb + 3, bs, nb, 64,
                                                        nb * bs - 5)), dtype, rng, cuda_device)
        names = ("q", "k_arena", "v_arena", "pos_arena", "block_tables", "current")
        assert decode_plan(nb * bs, bs).n_split > 1
        for window in (None, 7):
            got = paged_decode_attention(*(i[k] for k in names), window=window)
            tables = i["block_tables"]
            want = decode_attention(i["q"], gather_pages(i["k_arena"], tables),
                                    gather_pages(i["v_arena"], tables),
                                    gathered_positions(i["pos_arena"], tables), i["current"],
                                    window=window, bk=bs)
            assert torch.equal(got, want)
            rtol, atol = spec.tol(dtype)
            torch.testing.assert_close(got.float(), paged_decode_attention_ref(
                *(i[k] for k in names), window=window).float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_verify_ties_across_a_slice_boundary(cuda_device):
    """Equal maxima on both sides of the first slice boundary and in a later
    slice: the first index wins, as in the plain version; NaN in one slice
    wins over every number."""
    rng = np.random.default_rng(9)
    edge = slice_plan(32000).slice_cols
    for kind in ("ties", "nan"):
        scores = torch.from_numpy(rng.normal(size=(8, 2, 5, 32000)).astype(np.float32))
        top = scores.amax(-1, keepdim=True) + 1.0
        for col in (edge - 1, edge, 3 * edge + 2):
            scores[..., col:col + 1] = top
        if kind == "nan":
            scores[::2, :, :, 2 * edge + 1] = float("nan")
        scores = scores.to(cuda_device)
        draft = torch.from_numpy(rng.integers(0, 32000, size=(8, 2, 4)).astype(np.int32))
        draft[:, 0, :2] = edge - 1                      # accept a prefix on branch 0
        draft = draft.to(cuda_device)
        for got, want in zip(verify_accept_tree_kernel(scores, draft),
                             verify_accept_tree_ref(scores, draft)):
            assert torch.equal(got, want)
        for got, want in zip(verify_accept_kernel(scores[:, 0], draft[:, 0]),
                             verify_accept_ref(scores[:, 0], draft[:, 0])):
            assert torch.equal(got, want)
