"""The port's kernels against the JAX package's Pallas kernels, on the CPU.

For `anemm`, `palette`, `sparse`, `flash` and `decode_attention`, every
registry shape class in fp32 and bf16: the reference's own input bundle goes through the Pallas
kernel (interpret mode on the CPU, as the reference's tests run it) and,
bridged bit for bit into torch, through the port's kernel wrapper, which on
a CPU tensor runs the kernel's plain PyTorch version. They must agree at the
reference registry's tolerance. The port's registry rows must mirror the
reference's: case names, dims, edge flags, dtypes and tolerances. The packed
rows pack with the port's own packers, which must give the reference's
payloads: bit for bit, except that a palette codebook entry may differ by 2
float32 ulp (a Lloyd mean is a float64 sum rounded once here, a pairwise
float32 sum in numpy).

The CUDA kernels themselves run only on a card: the `cuda`-marked tests at
the end hold each kernel against its plain version there and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.kernels import native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.anemm.anemm import anemm
from repro_torch.kernels.anemm.ref import anemm_ref
from repro_torch.kernels.flash.decode_attention import decode_attention
from repro_torch.kernels.flash.flash_attention import flash_attention
from repro_torch.kernels.palette.palette_matmul import palette_matmul
from repro_torch.kernels.palette.ref import palette_matmul_ref
from repro_torch.kernels.sparse.sparse_matmul import sparse_matmul

KERNELS = ("anemm", "palette", "sparse", "flash", "decode_attention")
LUT_ULPS = 2   # a palette codebook entry against the reference's (see above)
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
    assert [str(d).removeprefix("torch.") for d in tspec.dtypes] == \
        [jnp.dtype(d).name for d in jspec.dtypes]
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
        decode_attention(torch.ones(1, 2, 16, dtype=torch.float16),
                         *(torch.ones(1, 4, 1, 16, dtype=torch.float16),) * 2,
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
