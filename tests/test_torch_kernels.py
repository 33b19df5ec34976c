"""The port's kernels against the JAX package's Pallas kernels, on the CPU.

For `anemm`, `palette`, `sparse`, `flash` and `decode_attention`, every
registry shape class in fp32 and bf16: the reference's own input bundle goes through the Pallas
kernel (interpret mode on the CPU, as the reference's tests run it) and,
bridged bit for bit into torch, through the port's kernel wrapper, which on
a CPU tensor runs the kernel's plain PyTorch version. They must agree at the
reference registry's tolerance. The port's registry rows must mirror the
reference's: case names, dims, edge flags, dtypes and tolerances. The packed
rows pack with the port's own packers, which must give the reference's
payloads bit for bit, palette codebooks included (each Lloyd mean is taken
in numpy's float32 summation order).

The CUDA kernels themselves run only on a card: the `cuda`-marked tests at
the end hold each kernel against its plain version there and skip here.
"""

import _torch_threads  # noqa: F401

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.kernels import common, native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.anemm.anemm import anemm
from repro_torch.kernels.anemm.ref import anemm_ref
from repro_torch.kernels.flash.decode_attention import decode_attention
from repro_torch.kernels.flash.flash_attention import flash_attention
from repro_torch.kernels.palette.palette_matmul import pack_kn, palette_matmul
from repro_torch.kernels.palette.ref import palette_matmul_ref
from repro_torch.kernels.sparse.ref import sparse_matmul_ref
from repro_torch.kernels.sparse.sparse_matmul import pack_pair_sparse, sparse_matmul

KERNELS = ("anemm", "palette", "sparse", "flash", "decode_attention")
LUT_ULPS = 0   # a palette codebook entry against the reference's: the same bits
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _cases():
    for name in KERNELS:
        for case in jreg.get(name).cases:
            for dt in ("float32", "bfloat16"):
                yield pytest.param(name, case.name, dt, id=f"{name}-{case.name}-{dt}")


def _bridge(bundle: dict) -> dict:
    return {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in bundle.items()}


def ulp_distance(got: np.ndarray, want: np.ndarray) -> int:
    """Largest distance in float32 ulps (same-sign values)."""
    g = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    w = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(g - w).max())


def _close(got: torch.Tensor, want: np.ndarray, tol) -> None:
    rtol, atol = tol
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,case_name,dt", list(_cases()))
def test_port_matches_pallas_kernel(name, case_name, dt):
    jspec, tspec = jreg.get(name), treg.get(name)
    case = next(c for c in jspec.cases if c.name == case_name)
    bundle = jspec.make_inputs(case, JDT[dt], np.random.default_rng(0))
    want = jspec.run_kernel(bundle)               # the Pallas kernel, interpret mode
    got = tspec.run_kernel(_bridge(bundle))       # CPU tensor: the plain version
    assert got.dtype == TDT[dt] and tuple(got.shape) == tuple(want.shape)
    _close(got, want, jspec.tol(JDT[dt]))
    assert native.launch_counts()[name] == 0     # nothing launched on the CPU


@pytest.mark.parametrize("name", KERNELS)
def test_registry_rows_mirror_the_reference(name):
    jspec, tspec = jreg.get(name), treg.get(name)
    assert [(c.name, c.dims, c.edge) for c in tspec.cases] == \
        [(c.name, c.dims, c.edge) for c in jspec.cases]
    # the port's one extension: float16 on the two decode rows (the
    # reference's dispatcher sends an fp16 decode to its plain version)
    extension = ["float16"] if name in ("decode_attention", "paged_decode_attention") else []
    assert [str(d).removeprefix("torch.") for d in tspec.dtypes] == \
        [jnp.dtype(d).name for d in jspec.dtypes] + extension
    for dt in tspec.dtypes:
        assert tspec.tol(dt) == jspec.tol(JDT[str(dt).removeprefix("torch.")])
    assert tspec.replaces.startswith("src/repro/kernels/")
    assert tspec.source.startswith("src/repro_torch/csrc/")


@pytest.mark.parametrize("name", KERNELS)
def test_make_inputs_draw_the_reference_values(name):
    """Same numpy seed, same draws: the fp32 bundles are equal value for value."""
    jspec, tspec = jreg.get(name), treg.get(name)
    for case in jspec.cases:
        want = jspec.make_inputs(case, jnp.float32, np.random.default_rng(3))
        got = tspec.make_inputs(case, torch.float32, np.random.default_rng(3), "cpu")
        assert list(got) == list(want)
        for key in want:
            if key == "lut":
                assert ulp_distance(got[key].numpy(), np.asarray(want[key])) <= LUT_ULPS
            else:
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
def test_anemm_epilogue_matches_pallas(dt):
    """scale, bias and ANE-mode saturation, with rows driven past 2^15."""
    from repro.kernels.anemm.anemm import anemm as janemm

    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 72)).astype(np.float32)
    a[:3] *= 3000.0                                   # saturating rows
    b = rng.normal(size=(72, 24)).astype(np.float32)
    scale = np.linspace(0.5, 2.0, 24).astype(np.float32)
    bias = np.linspace(-1.0, 1.0, 24).astype(np.float32)
    ja, jb = jnp.asarray(a, JDT[dt]), jnp.asarray(b, JDT[dt])
    want = np.asarray(janemm(ja, jb, jnp.asarray(scale), jnp.asarray(bias),
                             ane_mode=True).astype(jnp.float32))
    ta, tb = tensor_from_numpy(np.asarray(ja), "cpu"), tensor_from_numpy(np.asarray(jb), "cpu")
    got = anemm(ta, tb, torch.from_numpy(scale), torch.from_numpy(bias),
                ane_mode=True).float().numpy()
    assert np.isinf(want).any(), "the case must saturate"
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    rtol, atol = jreg.get("anemm").tol(JDT[dt])
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["flash", "decode_attention"])
def test_window_matches_pallas(name):
    """The sliding-window mask, which the registry cases leave off."""
    from repro.kernels.flash.decode_attention import decode_attention as jdecode
    from repro.kernels.flash.flash_attention import flash_attention as jflash

    jspec = jreg.get(name)
    bundle = jspec.make_inputs(jspec.cases[0], jnp.float32, np.random.default_rng(4))
    t = _bridge(bundle)
    if name == "flash":
        want = jflash(bundle["q"], bundle["k"], bundle["v"], causal=True, window=24,
                      bq=64, bk=64)
        got = flash_attention(t["q"], t["k"], t["v"], causal=True, window=24)
    else:
        args = [bundle[k] for k in ("q", "k_cache", "v_cache", "positions", "current")]
        want = jdecode(*args, window=24, bk=64)
        got = decode_attention(*(t[k] for k in ("q", "k_cache", "v_cache", "positions",
                                                "current")), window=24)
    _close(got, want, jspec.tol(jnp.float32))


def test_anemm_fused_lut_epilogue_is_not_ported():
    """The fused epilogue names a table of `core.numerics`: a known name
    runs (the LUT after the product), an unknown one is refused."""
    from repro_torch.kernels.act_lut.ops import lut_apply_ref

    a = torch.ones(2, 4)
    assert torch.equal(anemm(a, torch.ones(4, 3), epilogue="gelu"),
                       lut_apply_ref(torch.full((2, 3), 4.0), "gelu"))
    with pytest.raises(KeyError):
        anemm(a, torch.ones(4, 3), epilogue="no_such_table")


def test_decode_all_invalid_lane_is_finite():
    """A lane with no valid slot (an idle continuous lane) gives finite,
    uniform weights over its slots, as the reference's softmax over -1e30."""
    from repro.kernels.flash.decode_attention import decode_attention_ref as jref

    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    pos = np.full((2, 24), -1, np.int32)
    pos[0, :5] = np.arange(5)
    cur = np.array([4, 7], np.int32)
    want = np.asarray(jref(*(jnp.asarray(x) for x in (q, k, v, pos, cur))))
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, pos, cur))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[1], v[1].mean(0).repeat(2, 0), rtol=1e-5, atol=1e-5)


def test_dispatcher_routes_by_device():
    disp = KernelDispatcher()
    route = disp.resolve("anemm", torch.ones(2, 2, dtype=torch.bfloat16))
    assert (route.backend, route.reason, route.native) == ("torch", "cpu requested", False)
    with pytest.raises(ValueError):
        disp.resolve("anemm", torch.ones(2, 2, device="meta"))
    with pytest.raises(KeyError):
        disp.resolve("verify_accept", torch.ones(2, 2))


def test_wrappers_refuse_bad_operands():
    with pytest.raises(ValueError):
        anemm(torch.ones(2, 3), torch.ones(4, 5))
    with pytest.raises(TypeError):
        anemm(torch.ones(2, 3), torch.ones(3, 5, dtype=torch.float64))
    with pytest.raises(TypeError):
        decode_attention(torch.ones(1, 2, 16, dtype=torch.float64),
                         *(torch.ones(1, 4, 1, 16, dtype=torch.float64),) * 2,
                         torch.zeros(1, 4, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        flash_attention(torch.ones(1, 2, 4, 16), torch.ones(1, 3, 4, 16),
                        torch.ones(1, 3, 4, 16))
    with pytest.raises(ValueError):
        flash_attention(torch.ones(1, 2, 4, 16), torch.ones(1, 2, 4, 16),
                        torch.ones(1, 2, 4, 16), window=0)


def _palette_operands(k=32, n=16, m=4, dtype=torch.float32):
    return (torch.ones(m, k, dtype=dtype), torch.zeros(k // 2, n, dtype=torch.uint8),
            torch.linspace(-1.0, 1.0, 16))


def _sparse_operands(k=32, n=16, m=4, dtype=torch.float32):
    return (torch.ones(m, k, dtype=dtype), torch.ones(k // 2, n, dtype=torch.float16),
            torch.zeros(k // 16, n, dtype=torch.uint8))


def test_packed_wrappers_accept_their_contract():
    a, packed, lut = _palette_operands(dtype=torch.bfloat16)
    assert palette_matmul(a, packed, lut).dtype == torch.bfloat16
    a, values, selector = _sparse_operands()
    assert sparse_matmul(a, values.to(torch.bfloat16), selector).shape == (4, 16)


@pytest.mark.parametrize("case", [
    "odd_k", "a_rank", "a_fp16", "a_fp64", "packed_dtype", "packed_rows", "lut_shape",
    "lut_fp16", "device_mismatch", "meta_device", "non_contiguous"])
def test_palette_wrapper_refuses_bad_operands(case):
    a, packed, lut = _palette_operands()
    if case == "odd_k":
        a, packed = torch.ones(4, 33), torch.zeros(16, 16, dtype=torch.uint8)
    elif case == "a_rank":
        a = a[None]
    elif case == "a_fp16":
        a = a.half()
    elif case == "a_fp64":
        a = a.double()
    elif case == "packed_dtype":
        packed = packed.to(torch.int8)
    elif case == "packed_rows":
        packed = torch.zeros(15, 16, dtype=torch.uint8)
    elif case == "lut_shape":
        lut = torch.zeros(8)
    elif case == "lut_fp16":
        lut = lut.half()
    elif case == "device_mismatch":
        lut = lut.to("meta")
    elif case == "meta_device":
        a, packed, lut = (t.to("meta") for t in (a, packed, lut))
    elif case == "non_contiguous":
        packed = torch.zeros(16, 32, dtype=torch.uint8)[:, ::2]
    with pytest.raises((ValueError, TypeError)):
        palette_matmul(a, packed, lut)


@pytest.mark.parametrize("case", [
    "k_not_16", "selector_rows", "selector_cols", "selector_dtype", "values_fp32",
    "values_rows", "a_fp16", "device_mismatch", "non_contiguous"])
def test_sparse_wrapper_refuses_bad_operands(case):
    a, values, selector = _sparse_operands()
    if case == "k_not_16":
        a, values, selector = _sparse_operands(k=24)
    elif case == "selector_rows":
        selector = torch.zeros(3, 16, dtype=torch.uint8)
    elif case == "selector_cols":
        selector = torch.zeros(2, 15, dtype=torch.uint8)
    elif case == "selector_dtype":
        selector = selector.to(torch.int32)
    elif case == "values_fp32":
        values = values.float()
    elif case == "values_rows":
        values = torch.ones(15, 16, dtype=torch.float16)
    elif case == "a_fp16":
        a = a.half()
    elif case == "device_mismatch":
        selector = selector.to("meta")
    elif case == "non_contiguous":
        a = torch.ones(32, 4).T
    with pytest.raises((ValueError, TypeError)):
        sparse_matmul(a, values, selector)


def _ragged_palette(device="cpu"):
    """K = 130, not a multiple of any tile depth, with a codebook whose entry
    0 is large: the nibbles of a zero-padded weight row decode to lut[0], not
    to 0, so a kernel that padded B and relied on it would go wrong unless it
    also zeroed A's K tail."""
    rng = np.random.default_rng(7)
    lut = np.sort(rng.normal(size=16)).astype(np.float32)
    lut[0] = 1000.0
    packed = rng.integers(0, 256, size=(65, 72), dtype=np.uint8)
    a = rng.normal(size=(32, 130)).astype(np.float32)
    return a, packed, lut


def test_palette_ragged_k_matches_pallas():
    from repro.kernels.palette.palette_matmul import palette_matmul as jpalette

    a, packed, lut = _ragged_palette()
    want = np.asarray(jpalette(jnp.asarray(a), jnp.asarray(packed), jnp.asarray(lut)))
    got = palette_matmul(*(torch.from_numpy(x) for x in (a, packed, lut)))
    _close(got, want, jreg.get("palette").tol(jnp.float32))


# ---------------------------------------------------------------------------
# The streaming loop's plan (kernels/common.py): the sum order reads K, N
# and dtype, never M; the launch that spreads it stays within the card
# ---------------------------------------------------------------------------

# every K of the port's matmuls and convs (tinyllama, whisper-small and its
# stem convs' KW*Cin, the registry rows) and the shapes around a chunk's
# edges
PLAN_KS = (1, 8, 16, 32, 63, 64, 65, 130, 144, 240, 256, 257, 300, 384, 512, 768, 2048,
           2304, 3072, 5632, 32000)
HALF_DTYPES = (torch.bfloat16, torch.float16)


def test_chunk_plan_reads_k_n_and_dtype_never_m():
    assert list(inspect.signature(common.chunk_plan).parameters) == ["k", "n", "dtype"]


@pytest.mark.parametrize("k", PLAN_KS)
def test_chunk_plan_tiles_k_in_order(k):
    for dtype in HALF_DTYPES:
        kc, chunks = common.chunk_plan(k, 2048, dtype)
        assert kc % common.STREAM_BK == 0 and 1 <= chunks <= common.MAX_CHUNKS
        spans = [(c * kc, min(k, (c + 1) * kc)) for c in range(chunks)]
        assert spans[0][0] == 0 and spans[-1][1] == k
        assert all(lo < hi for lo, hi in spans)                 # no empty chunk
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        # the fewest steps a chunk that keep within MAX_CHUNKS
        steps = -(-k // common.STREAM_BK)
        assert kc // common.STREAM_BK == -(-steps // common.MAX_CHUNKS)
        # the order is the same for every N and both 16-bit dtypes
        assert {common.chunk_plan(k, n, dt) for n in (8, 130, 256, 5632, 32000)
                for dt in HALF_DTYPES} == {(kc, chunks)}
    assert common.chunk_plan(k, 2048, torch.float32) == (k, 1)   # one fmaf chain


@pytest.mark.parametrize("m", (1, 2, 8, 9, 16, 17, 40, 64, 65, 80, 264, 512, 4096))
def test_launch_plan_within_card_limits(m):
    for k in PLAN_KS:
        for n in (8, 100, 130, 256, 2048, 5632, 32000):
            chunks = common.chunk_plan(k, n, torch.bfloat16)
            bm, split = common.launch_plan(m, n, chunks)
            assert bm in common.STREAM_ROWS and bm >= min(m, common.STREAM_ROWS[-1])
            assert split in (1, chunks.chunks) and split <= 8   # a portable cluster
            tiles = -(-n // common.STREAM_BN) * -(-m // bm)
            assert (split > 1) <= (tiles < common.SPLIT_TILES)


SMEM_LIMIT = 232_448   # shared memory an H100 block may use (227 KB)
SM_SMEM = 233_472      # an SM's shared memory for blocks (228 KB), 1 KB a block reserved


def stream_smem_bytes(bm: int, weight: str) -> int:
    """smem_bytes of tile_matmul.cuh's streaming loop, restated: a ring of 4
    stages of the activation slice (bm rows of 64 16-bit values) and the
    weight's share (dense: 64 such rows; sparse: 32 value rows and 4
    selector rows of 64 bytes; palette: 32 packed rows of 64 bytes), each
    rounded up to 128 bytes, then the weight's block-wide state (palette:
    its 256-entry byte table, 1 KB), or the fp32 output tile (bm x 68) if
    larger."""
    share = {"dense": 64 * 128, "sparse": 32 * 128 + 4 * 64, "palette": 32 * 64}[weight]
    state = {"palette": 256 * 4}.get(weight, 0)
    stage = -(-(bm * 128 + share) // 128) * 128
    return max(4 * stage + state, bm * 68 * 4)


def test_stream_shared_memory_fits_a_block():
    for bm in common.STREAM_ROWS:
        for weight in ("dense", "sparse", "palette"):
            smem = stream_smem_bytes(bm, weight)
            assert smem <= SMEM_LIMIT
            # an 8-row decode tile: six blocks an SM, so that gate_up's 704
            # blocks (88 tiles x 8 chunks) run in one wave on 132 SMs
            assert bm > 8 or 6 * (smem + 1024) <= SM_SMEM


def test_split_and_prefill_plans_at_the_main_path():
    """tinyllama's projections: decode (8 rows) and a verify window (40)
    spread the chunks over a cluster; a 512-token prefill of the wide
    projections walks them in one block."""
    shapes = {"q_o": (2048, 2048), "k_v": (2048, 256), "gate_up": (2048, 5632),
              "down": (5632, 2048)}
    for k, n in shapes.values():
        chunks = common.chunk_plan(k, n, torch.bfloat16)
        assert chunks == ((256, 8) if k == 2048 else (704, 8))
        assert common.launch_plan(8, n, chunks) == (8, 8)
        assert common.launch_plan(40, n, chunks) == (64, 8)
    assert common.launch_plan(512, 5632, common.chunk_plan(2048, 5632, torch.bfloat16)) \
        == (64, 1)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_cuda_kernel_matches_plain_version(name, cuda_device):
    spec = treg.get(name)
    rng = np.random.default_rng(0)
    for dt in spec.dtypes:
        for case in spec.cases:
            inputs = spec.make_inputs(case, dt, rng, cuda_device)
            before = native.launch_counts()[name]
            got = spec.run_kernel(inputs)
            torch.cuda.synchronize()
            assert native.launch_counts()[name] == before + 1
            want = spec.run_oracle(inputs)
            rtol, atol = spec.tol(dt)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_anemm_epilogue_matches_plain_version(cuda_device):
    rng = np.random.default_rng(1)
    for dt in treg.get("anemm").dtypes:
        a = torch.from_numpy(rng.normal(size=(70, 130))).to(cuda_device, dt)
        a[:2] *= 3000.0
        b = torch.from_numpy(rng.normal(size=(130, 90))).to(cuda_device, dt)
        scale = torch.linspace(0.5, 2.0, 90, device=cuda_device)
        bias = torch.linspace(-1.0, 1.0, 90, device=cuda_device)
        got = anemm(a, b, scale, bias, ane_mode=True).float()
        want = anemm_ref(a, b, scale, bias, ane_mode=True).float()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        rtol, atol = treg.get("anemm").tol(dt)
        torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_palette_ragged_k_matches_plain_version(cuda_device):
    a, packed, lut = (torch.from_numpy(x).to(cuda_device) for x in _ragged_palette())
    for dt in treg.get("palette").dtypes:
        got = palette_matmul(a.to(dt), packed, lut).float()
        want = palette_matmul_ref(a.to(dt), packed, lut).float()
        rtol, atol = treg.get("palette").tol(dt)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_packed_wrappers_refuse_fp16_activations(cuda_device):
    a, packed, lut = (t.to(cuda_device) for t in _palette_operands())
    with pytest.raises(TypeError):
        palette_matmul(a.half(), packed, lut)
    a, values, selector = (t.to(cuda_device) for t in _sparse_operands())
    with pytest.raises(TypeError):
        sparse_matmul(a.half(), values, selector)


@pytest.mark.cuda
def test_cuda_matmul_rows_do_not_depend_on_m(cuda_device, monkeypatch):
    """The first rows of a 96-row activation come out bit-identical at 1 to
    96 rows, with a tile's chunks over a cluster (the plan at these sizes)
    and walked by one block: anemm in three dtypes, sparse and palette in
    two, at K of 8 chunks and of 6 (the last one short), N aligned and
    ragged."""
    taken = common.launch_plan

    def one_block(m, n, chunks):
        return common.LaunchPlan(taken(m, n, chunks).bm, 1)

    rng = np.random.default_rng(6)
    for k, n in ((512, 192), (272, 130), (1040, 72)):
        w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
        values, selector = (t.to(cuda_device) for t in pack_pair_sparse(w))
        packed, lut = pack_kn(w.to(cuda_device), iters=4)
        runs = {("anemm", dt): (lambda a, dt=dt: anemm(a, w.to(cuda_device, dt)))
                for dt in treg.get("anemm").dtypes}
        runs.update({("sparse", dt): (lambda a: sparse_matmul(a, values, selector))
                     for dt in treg.get("sparse").dtypes})
        runs.update({("palette", dt): (lambda a: palette_matmul(a, packed, lut))
                     for dt in treg.get("palette").dtypes})
        for (name, dt), run in runs.items():
            a = torch.from_numpy(rng.normal(size=(96, k))).to(cuda_device, dt)
            full = run(a)
            bits = torch.int32 if dt == torch.float32 else torch.int16
            for m in (1, 8, 16, 40, 65, 80, 96):
                with monkeypatch.context() as patch:
                    patch.setattr(common, "launch_plan", one_block)
                    walked = run(a[:m])
                for got in (run(a[:m]), walked):
                    assert torch.equal(got.view(bits), full[:m].view(bits)), (name, dt, k, n, m)
            want = {"anemm": lambda: anemm_ref(a, w.to(cuda_device, dt)),
                    "sparse": lambda: sparse_matmul_ref(a, values, selector),
                    "palette": lambda: palette_matmul_ref(a, packed, lut)}[name]()
            rtol, atol = treg.get(name).tol(dt)
            torch.testing.assert_close(full.float(), want.float(), rtol=rtol, atol=atol)
