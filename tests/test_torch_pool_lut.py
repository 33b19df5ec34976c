"""The pool and act_lut kernels' host-side contracts, and their bits on the card.

On the CPU: `pool_plan`, which maps the pool kernel's launch (tiles of
output pixels of one image, channel chunks, a staged input patch), covers
every output exactly once and stages every tap an output reads, for every
registry pool case, both pyramid shapes and a few that force the patch to
shrink; it takes 16-byte vectors only when a pixel's channels are whole
vectors and both pointers are 16-byte aligned, and refuses what does not
fit. A plain-PyTorch mirror of `csrc/lut_eval.cuh`'s five-step search over
the knots equals the reference's compare count (and the whole evaluation
equals `lut_eval_ref` bit for bit) for every table `build_lut` makes and
for tables with equal knots, at the knots, their float32 neighbours, +-0,
+-inf, NaN and subnormals. The host's knot-order check passes every built
table and raises on an unsorted one.

On the card (`cuda`-marked, skipped elsewhere): both pools and `act_lut`
equal to their plain versions bit for bit (`torch.equal`, NaN where the
plain version has NaN) on every registry case in fp32, bf16 and fp16, at
the pyramid and stem shapes, on unaligned views and with NaN inputs; the
stem conv with its GELU fused equal to conv2d, then act_lut.
"""

import _torch_threads  # noqa: F401

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import numerics
from repro_torch.kernels import native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.act_lut.act_lut import act_lut
from repro_torch.kernels.act_lut.ops import lut_activation, table_operands
from repro_torch.kernels.act_lut.ref import act_lut_ref, lut_eval_ref
from repro_torch.kernels.conv.ops import avg_pool, conv2d, max_pool
from repro_torch.kernels.conv.pool import SMEM_BYTES, THREADS, PoolPlan, pool_plan
from repro_torch.kernels.conv.ref import avg_pool_ref, max_pool_ref, out_extent

LUT_NAMES = tuple(numerics._LUT_SPECS)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
POOLS = {"avg_pool": (avg_pool, avg_pool_ref), "max_pool": (max_pool, max_pool_ref)}

# (shape, window, stride, padding): the registry's pool cases, the
# pyramid of the kernels phase (a 3x3 s2 SAME max pool, a 7x7 global
# average pool), and cases whose patch must shrink (a wide window; a
# partial channel chunk; stride past the window)
POOL_GEOMETRY = [((b, h, w, c), (wh, ww), (sh, sw), "SAME" if same else "VALID")
                 for b, h, w, c, wh, ww, sh, sw, same in
                 (case.dims for case in treg.get("max_pool").cases)]
PYRAMID = [((8, 112, 112, 64), (3, 3), (2, 2), "SAME"), ((8, 7, 7, 2048), (7, 7), (7, 7), "VALID")]
POOL_GEOMETRY += PYRAMID + [((1, 40, 40, 64), (30, 30), (1, 1), "SAME"),
                            ((2, 9, 11, 80), (3, 3), (1, 1), "SAME"),
                            ((1, 20, 20, 24), (2, 2), (5, 3), "VALID")]


def _writes(shape, window, stride, padding, plan: PoolPlan) -> np.ndarray:
    """How often each output is written under `plan`, by csrc/pool.cu's
    index math (block: image and row tile, column tile, channel chunk;
    thread: a fold of the chunk's channels, then every `rows`-th pixel of
    the tile);
    asserts that every tap a written output reads lies in its block's
    staged patch and that no thread reaches past its chunk."""
    b, h, w, c = shape
    (wh, ww), (sh, sw) = window, stride
    oh, ow = out_extent(h, wh, sh, padding), out_extent(w, ww, sw, padding)
    count = np.zeros((b, oh, ow, c), np.int64)
    lanes, rows = plan.block
    log2 = plan.tile_w.bit_length() - 1
    pixels = np.concatenate([np.arange(ty, plan.tile_h << log2, rows) for ty in range(rows)])
    ry, rx = pixels >> log2, pixels & (plan.tile_w - 1)
    # the channels the chunks' active lanes write (z and x of every block)
    chans = []
    for gz in range(plan.n_chunks):
        width = min(plan.chunk, c - gz * plan.chunk)
        for tx in range(lanes):
            if tx * plan.fold < width:
                assert tx * plan.fold + plan.fold <= width
                chans.extend(range(gz * plan.chunk + tx * plan.fold,
                                   gz * plan.chunk + (tx + 1) * plan.fold))
    chans = np.asarray(chans)
    for gx in range(b * plan.row_tiles):
        img, oy0 = gx // plan.row_tiles, (gx % plan.row_tiles) * plan.tile_h
        for gy in range(plan.col_tiles):
            oy, ox = oy0 + ry, (gy << log2) + rx
            keep = (oy < oh) & (ox < ow)
            assert (ry[keep] * sh + wh <= plan.patch_h).all()
            assert (rx[keep] * sw + ww <= plan.patch_w).all()
            np.add.at(count, (img, oy[keep][:, None], ox[keep][:, None], chans[None, :]), 1)
    return count


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("geometry", POOL_GEOMETRY, ids=lambda g: str(g))
def test_pool_plan_covers_every_output_once(geometry, itemsize):
    shape, window, stride, padding = geometry
    plan = pool_plan(shape, window, stride, padding, itemsize, True)
    assert plan == pool_plan(shape, window, stride, padding, itemsize, True)
    lanes, rows = plan.block
    assert lanes * rows <= THREADS and plan.chunk % plan.vec == 0
    # the staging loop's threads: (load lane, first cell) distinct for each
    assert (lanes * rows) % (plan.chunk // plan.vec) == 0
    assert plan.fold in (plan.vec, 4 // itemsize) and plan.vec % plan.fold == 0
    assert plan.tile_w & (plan.tile_w - 1) == 0
    assert plan.patch_h * plan.patch_w * plan.chunk * itemsize <= SMEM_BYTES
    assert max(plan.col_tiles, plan.n_chunks) <= 65535
    assert (_writes(shape, window, stride, padding, plan) == 1).all()


def test_pool_plan_at_the_pyramid_shapes():
    """bf16: 8 lanes of 16 bytes over the 64 channels, 4x4 output tiles
    (a 9x9 patch); the global pool one pixel a block, 32 chunks of 64, its
    49 taps folded 2 channels a thread by 32 lanes."""
    (mx, avg) = (pool_plan(*g, 2, True) for g in PYRAMID)
    assert mx == PoolPlan(8, 8, 64, 4, 4, 14, 14, 1, 9, 9) and mx.block == (8, 32)
    assert avg == PoolPlan(8, 2, 64, 1, 1, 1, 1, 32, 7, 7) and avg.block == (32, 8)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("geometry", POOL_GEOMETRY, ids=lambda g: str(g))
def test_pool_plan_takes_vectors_only_when_allowed(geometry, itemsize, aligned):
    shape, window, stride, padding = geometry
    whole = shape[3] * itemsize % 16 == 0
    plan = pool_plan(shape, window, stride, padding, itemsize, aligned)
    assert plan.vec == (16 // itemsize if aligned and whole else 1)
    if plan.vec == 1:
        assert (_writes(shape, window, stride, padding, plan) == 1).all()


def test_pool_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="patch"):
        pool_plan((1, 300, 300, 64), (200, 200), (1, 1), "VALID", 4, True)
    with pytest.raises(ValueError, match="32-bit"):
        pool_plan((1, 2 ** 14, 2 ** 14, 8), (2, 2), (2, 2), "VALID", 2, True)


# ---------------------------------------------------------------------------
# lut_eval: the five-step search against the compare count
# ---------------------------------------------------------------------------


def _search(xf: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """csrc/lut_eval.cuh `lut_segment`, as torch ops."""
    idx = torch.zeros(xf.shape, dtype=torch.int64)
    for s in (16, 8, 4, 2, 1):
        idx += torch.where(xf >= xs[idx + s], s, 0)
    return idx


def _count(xf: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The reference's index: knots 1..32 that x reaches, clipped to 31."""
    return (xf[:, None] >= xs[None, 1:]).sum(1).clamp(max=31)


def _lut_eval_search(xf: torch.Tensor, table: torch.Tensor, ane: bool) -> torch.Tensor:
    """csrc/lut_eval.cuh `lut_eval`, as torch ops."""
    if ane:
        xf = torch.where(torch.isnan(xf), torch.full_like(xf, float("inf")), xf)
    idx = _search(xf, table[:33])
    y = table[33:65][idx] * xf
    y = y + table[65:97][idx]
    y = torch.where(xf < table[0], table[97], y)
    y = torch.where(xf > table[32], table[98], y)
    return y.to(torch.float16).float() if ane else y


def _probes(xs: np.ndarray) -> torch.Tensor:
    """Every knot, its float32 neighbours, +-0, +-inf, NaN, subnormals,
    the extremes and a spread across and past the domain."""
    xs = xs.astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, -1e-40,
                        tiny, -tiny, np.nextafter(tiny, 0), np.finfo(np.float32).max,
                        -np.finfo(np.float32).max], np.float32)
    spread = np.linspace(xs[0] - 3, xs[-1] + 3, 1001, dtype=np.float32)
    x = np.concatenate([xs, np.nextafter(xs, np.float32(np.inf)),
                        np.nextafter(xs, np.float32(-np.inf)), special, spread])
    return torch.from_numpy(x.astype(np.float32))


def _equal_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


def _tables():
    """Every built table, then synthetic ones with equal knots: a few
    distinct values repeated, all knots equal, the last two equal."""
    for name in LUT_NAMES:
        yield name, torch.from_numpy(numerics.build_lut(name).kernel_operands())
    rng = np.random.default_rng(5)
    base = torch.from_numpy(numerics.build_lut("gelu").kernel_operands())
    for label, xs in (("repeats", np.sort(rng.choice(np.linspace(-4, 4, 9), 33))),
                      ("all equal", np.full(33, 0.5)),
                      ("last pair", np.concatenate([np.linspace(-2, 2, 32), [2.0]]))):
        table = base.clone()
        table[:33] = torch.from_numpy(xs.astype(np.float32))
        yield label, table


@pytest.mark.parametrize("label,table", list(_tables()), ids=lambda v: v if isinstance(v, str)
                         else "")
def test_five_step_search_equals_the_compare_count(label, table):
    xs = table[:33]
    assert (xs[1:] >= xs[:-1]).all()
    x = _probes(xs.numpy())
    assert torch.equal(_search(x, xs), _count(x, xs)), label
    for ane in (True, False):
        assert _equal_bits(_lut_eval_search(x, table, ane), lut_eval_ref(x, table, ane_mode=ane))


@pytest.mark.parametrize("name", LUT_NAMES)
def test_every_built_table_passes_the_knot_check(name):
    ops = numerics.build_lut(name).kernel_operands()
    assert ops.dtype == np.float32 and ops.shape == (99,)
    assert (np.diff(ops[:33]) >= 0).all()
    assert torch.equal(table_operands(name, "cpu"), torch.from_numpy(ops))


def test_knot_check_raises_on_an_unsorted_table():
    good = numerics.build_lut("tanh")
    swapped = good.xs.copy()
    swapped[[10, 11]] = swapped[[11, 10]]
    for xs in (swapped, good.xs[::-1].copy(), np.where(np.arange(33) == 7, np.nan, good.xs)):
        with pytest.raises(ValueError, match="non-decreasing"):
            dataclasses.replace(good, xs=xs).kernel_operands()


# ---------------------------------------------------------------------------
# On the card: bit for bit against the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """torch.equal, with NaN exactly where the plain version has NaN."""
    nan = torch.isnan(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous tensor that starts one element past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def _pool_calls(x, window, stride, padding):
    for name, (kernel, plain) in POOLS.items():
        before = native.launch_counts()[name]
        got = kernel(x, window=window, stride=stride, padding=padding)
        torch.cuda.synchronize()
        assert native.launch_counts()[name] == before + 1
        yield name, got, plain(x, window=window, stride=stride, padding=padding)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_pools_bit_identical_to_plain(dtype, cuda_device):
    rng = np.random.default_rng(0)
    geometry = POOL_GEOMETRY + [((8, 112, 112, 5), (3, 3), (2, 2), "SAME")]
    for shape, window, stride, padding in geometry:
        x = torch.from_numpy(rng.normal(size=shape)).to(cuda_device, dtype)
        for view in (x, _unaligned(x)):
            for name, got, want in _pool_calls(view, window, stride, padding):
                assert _same(got, want), (name, shape, window, view.data_ptr() % 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_pools_propagate_nan(dtype, cuda_device):
    rng = np.random.default_rng(1)
    for shape, window, stride, padding in PYRAMID + POOL_GEOMETRY[:4]:
        x = rng.normal(size=shape)
        x[rng.random(size=shape) < 0.01] = np.nan
        x = torch.from_numpy(x).to(cuda_device, dtype)
        for name, got, want in _pool_calls(x, window, stride, padding):
            assert torch.isnan(want).any() and _same(got, want), (name, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_act_lut_bit_identical_to_plain(dtype, cuda_device):
    spec, rng = treg.get("act_lut"), np.random.default_rng(2)
    cases = [spec.make_inputs(case, dtype, rng, cuda_device)["x"] for case in spec.cases]
    cases.append(torch.from_numpy(rng.normal(size=(3000, 768)) * 2).to(cuda_device, dtype))
    for name in LUT_NAMES:
        table = table_operands(name, cuda_device)
        probes = _probes(numerics.build_lut(name).kernel_operands()[:33]).to(cuda_device, dtype)
        for x in cases + [probes]:
            for view in (x, _unaligned(x)):
                for ane in (True, False):
                    before = native.launch_counts()["act_lut"]
                    got = act_lut(view, table, ane_mode=ane)
                    torch.cuda.synchronize()
                    assert native.launch_counts()["act_lut"] == before + 1
                    assert _same(got, act_lut_ref(view, table, ane_mode=ane)), (name, x.shape)


@pytest.mark.cuda
def test_cuda_fused_stem_equals_unfused(cuda_device):
    """whisper-small's stem convs (conv2: 768 -> 768 stride 2, conv1: 80
    mels -> 768) with the GELU fused at the output port, against conv2d,
    then act_lut."""
    rng = np.random.default_rng(3)
    for cin, stride in ((768, 2), (80, 1)):
        x = torch.from_numpy(rng.normal(size=(1, 1, 3000, cin))).to(cuda_device, torch.bfloat16)
        w = torch.from_numpy(rng.normal(size=(1, 3, cin, 768)) * (3 * cin) ** -0.5).to(
            cuda_device, torch.bfloat16)
        b = torch.from_numpy(rng.normal(size=(768,)) * 0.1).to(cuda_device, torch.bfloat16)
        fused = conv2d(x, w, b, stride=(1, stride), epilogue="gelu")
        unfused = lut_activation("gelu")(conv2d(x, w, b, stride=(1, stride)))
        assert torch.equal(fused, unfused)
