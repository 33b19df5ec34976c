"""The port's act_lut, conv2d and pool kernels against the JAX package's, on the CPU.

The 33-knot tables equal the reference's bit for bit. For every case of
the `act_lut`, `conv2d`, `avg_pool` and `max_pool` rows, in fp32 and bf16,
the reference's own input bundle goes through the Pallas kernel (interpret
mode) and, bridged bit for bit, through the port's wrapper, which on a CPU
tensor runs the kernel's plain version; they agree at the reference row's
tolerance, and the port's rows mirror the reference's. The fused LUT
epilogue of `conv2d` and `anemm` equals kernel-then-`act_lut` bit for bit,
and the routed `conv2d` gives the same bits fused (one route) and unfused
(two). The CUDA kernels run only on a card: the `cuda`-marked tests at the
end hold each against its plain version there and skip here.
"""

import _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as jnumerics
from repro.kernels import registry as jreg
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import numerics
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.kernels import common, native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.act_lut.act_lut import act_lut
from repro_torch.kernels.act_lut.ops import lut_activation, table_operands
from repro_torch.kernels.anemm.anemm import anemm
from repro_torch.kernels.conv.ops import avg_pool, conv2d, max_pool
from repro_torch.kernels.conv.ref import conv2d_ref
from repro_torch.models import dispatched as dsp

KERNELS = ("act_lut", "conv2d", "avg_pool", "max_pool")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _cases():
    for name in KERNELS:
        for case in jreg.get(name).cases:
            for dt in ("float32", "bfloat16"):
                yield pytest.param(name, case.name, dt, id=f"{name}-{case.name}-{dt}")


def _bridge(bundle: dict) -> dict:
    """The reference's bundle as the port's: arrays bit for bit, a LutTable
    as its kernel operands, everything else (names, strides) as it is."""
    out = {}
    for k, v in bundle.items():
        if isinstance(v, jnumerics.LutTable):
            out[k] = table_operands(v.name, "cpu")
        elif isinstance(v, (str, tuple)):
            out[k] = v
        else:
            out[k] = tensor_from_numpy(np.asarray(v), "cpu")
    return out


def _close(got: torch.Tensor, want, tol) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", sorted(jnumerics._LUT_SPECS))
def test_lut_tables_bit_identical(name):
    want, got = jnumerics.build_lut(name), numerics.build_lut(name)
    np.testing.assert_array_equal(got.xs, want.xs)
    np.testing.assert_array_equal(got.ys, want.ys)
    assert (got.lo_clamp, got.hi_clamp) == (want.lo_clamp, want.hi_clamp)
    assert numerics.lut_worst_error(got) == jnumerics.lut_worst_error(want)
    ops = got.kernel_operands()
    np.testing.assert_array_equal(ops, np.concatenate(
        [want.xs, want.slopes, want.intercepts, [want.lo_clamp, want.hi_clamp]]).astype(np.float32))


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
        for key, value in _bridge(want).items():
            if isinstance(value, torch.Tensor):
                assert torch.equal(got[key], value), (case.name, key)
            else:
                assert got[key] == value, (case.name, key)


def test_act_lut_edges_match_pallas():
    """NaN, +-inf, the knots themselves and the clamps, in and out of ANE
    mode, against the Pallas kernel."""
    from repro.kernels.act_lut.act_lut import act_lut as jact_lut
    from repro.kernels.act_lut.ref import table_arrays

    for name in ("gelu", "sigmoid", "exp", "softplus"):
        table = jnumerics.build_lut(name)
        x = np.concatenate([table.xs, np.nextafter(table.xs.astype(np.float32), np.inf),
                            [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30],
                            np.linspace(-20, 20, 401)]).astype(np.float32)
        for ane in (True, False):
            want = np.asarray(jact_lut(jnp.asarray(x), *map(jnp.asarray, table_arrays(table)),
                                       ane_mode=ane))
            got = act_lut(torch.from_numpy(x), table_operands(name, "cpu"), ane_mode=ane).numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
            fin = ~np.isnan(want)
            # exp reaches 6.5e4 outside ANE mode: one fp32 rounding of the
            # segment's multiply-add (fused or not) is 5e-7 of that
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=2e-3, err_msg=name)


def test_max_pool_propagates_nan_as_pallas():
    from repro.kernels.conv.pool import max_pool as jmax_pool

    x = np.random.default_rng(5).normal(size=(1, 9, 9, 4)).astype(np.float32)
    x[0, 4, 4, 1] = np.nan
    x[0, 0, 0, 2] = np.inf
    want = np.asarray(jmax_pool(jnp.asarray(x), window=(3, 3), stride=(2, 2), padding="SAME"))
    got = max_pool(torch.from_numpy(x), window=(3, 3), stride=(2, 2), padding="SAME").numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Fused epilogues: bit-identity with kernel-then-act_lut
# ---------------------------------------------------------------------------


def _conv_operands(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 9, 11, 6))).to(dtype)
    w = torch.from_numpy(rng.normal(size=(3, 3, 6, 24)) * 0.2).to(dtype)
    b = torch.from_numpy(rng.normal(size=(24,))).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "sigmoid"])
def test_conv_fused_epilogue_bit_identical(dtype, act):
    x, w, b = _conv_operands(dtype)
    fused = conv2d(x, w, b, stride=(1, 2), padding="SAME", epilogue=act)
    separate = lut_activation(act)(conv2d(x, w, b, stride=(1, 2), padding="SAME"))
    assert fused.dtype == separate.dtype == dtype
    assert torch.equal(fused, separate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "swish"])
def test_anemm_fused_epilogue_bit_identical_and_matches_pallas(dtype, act):
    from repro.kernels.anemm.anemm import anemm as janemm

    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.normal(size=(48, 160)) * 0.3, JDT[dtype])
    b = jnp.asarray(rng.normal(size=(160, 72)) * 0.3, JDT[dtype])
    ta, tb = (tensor_from_numpy(np.asarray(t), "cpu") for t in (a, b))
    fused = anemm(ta, tb, epilogue=act)
    assert torch.equal(fused, lut_activation(act)(anemm(ta, tb)))
    want = janemm(a, b, epilogue=act)
    _close(fused, np.asarray(want.astype(jnp.float32)), jreg.get("anemm").tol(JDT[dtype]))


def test_dispatched_conv_fused_vs_unfused_same_bits_fewer_routes():
    x, w, b = _conv_operands(torch.float32)
    d_fused, d_unfused = KernelDispatcher(), KernelDispatcher()
    with dsp.use_dispatcher(d_fused), dsp.fuse_epilogues(True):
        out_fused = dsp.conv2d(x, w, b, stride=(1, 2), act="gelu")
    with dsp.use_dispatcher(d_unfused), dsp.fuse_epilogues(False):
        out_unfused = dsp.conv2d(x, w, b, stride=(1, 2), act="gelu")
    assert torch.equal(out_fused, out_unfused)
    assert dict(d_fused.census()) == {("conv2d", "torch"): 1}
    assert dict(d_unfused.census()) == {("conv2d", "torch"): 1, ("act_lut", "torch"): 1}
    assert dsp.epilogue_fusion_active()


def test_dispatched_conv_matches_the_reference_route():
    """The routed conv with its fused GELU against the reference's routed
    conv (Pallas) on the same operands."""
    from repro.core.dispatch import KernelDispatcher as JDispatcher
    from repro.models import dispatched as jdsp

    x, w, b = _conv_operands(torch.float32, seed=3)
    with jdsp.use_dispatcher(JDispatcher()):
        want = jdsp.conv2d(*(jnp.asarray(t.numpy()) for t in (x, w, b)), stride=(1, 2),
                           act="gelu")
    with dsp.use_dispatcher(KernelDispatcher()):
        got = dsp.conv2d(x, w, b, stride=(1, 2), act="gelu")
    _close(got, want, jreg.get("conv2d").tol(jnp.float32))


def test_pool_routes_through_dispatcher():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 10, 12, 5)).astype(np.float32))
    disp = KernelDispatcher()
    with dsp.use_dispatcher(disp):
        a = dsp.avg_pool(x, window=(2, 2))
        m = dsp.max_pool(x, window=(3, 3), stride=(2, 2), padding="SAME")
    assert list(disp.census()) == [("avg_pool", "torch"), ("max_pool", "torch")]
    assert torch.equal(a, avg_pool(x, window=(2, 2)))
    assert torch.equal(m, max_pool(x, window=(3, 3), stride=(2, 2), padding="SAME"))
    with pytest.raises(RuntimeError):
        dsp.max_pool(x, window=(2, 2))            # no dispatcher in scope


@pytest.mark.parametrize("case", [
    "x_rank", "cin_mismatch", "dtype_mismatch", "fp64", "bias_shape", "stride_zero",
    "padding", "valid_too_small", "meta_device"])
def test_conv_wrapper_refuses_bad_operands(case):
    x, w, b = _conv_operands(torch.float32)
    kw = {"stride": (1, 1), "padding": "SAME"}
    if case == "x_rank":
        x = x[0]
    elif case == "cin_mismatch":
        w = w[:, :, :5]
    elif case == "dtype_mismatch":
        w = w.to(torch.bfloat16)
    elif case == "fp64":
        x, w = x.double(), w.double()
    elif case == "bias_shape":
        b = b[:5]
    elif case == "stride_zero":
        kw["stride"] = (0, 1)
    elif case == "padding":
        kw["padding"] = "FULL"
    elif case == "valid_too_small":
        w = torch.zeros(12, 3, 6, 24)
        kw["padding"] = "VALID"
    elif case == "meta_device":
        x, w, b = (t.to("meta") for t in (x, w, b))
    with pytest.raises((ValueError, TypeError)):
        conv2d(x, w, b, **kw)


def test_act_lut_and_pool_wrappers_refuse_bad_operands():
    tab = table_operands("gelu", "cpu")
    with pytest.raises(TypeError):
        act_lut(torch.ones(4, dtype=torch.float64), tab)
    with pytest.raises(ValueError):
        act_lut(torch.ones(4), tab[:98])
    with pytest.raises(ValueError):
        act_lut(torch.ones(4, device="meta"), tab)
    with pytest.raises(ValueError):
        avg_pool(torch.ones(4, 4, 2), window=(2, 2))
    with pytest.raises(TypeError):
        max_pool(torch.ones(1, 4, 4, 2, dtype=torch.int32), window=(2, 2))
    with pytest.raises(ValueError):
        max_pool(torch.ones(1, 4, 4, 2), window=(0, 2))


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
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_epilogues_bit_identical(dtype, cuda_device):
    x, w, b = (t.to(cuda_device) for t in _conv_operands(dtype))
    fused = conv2d(x, w, b, stride=(1, 2), epilogue="gelu")
    assert torch.equal(fused, lut_activation("gelu")(conv2d(x, w, b, stride=(1, 2))))
    assert torch.equal(fused, conv2d_ref(x, w, b, stride=(1, 2),
                                         epilogue_table=table_operands("gelu", cuda_device)))
    a = torch.randn(48, 160, device=cuda_device).to(dtype)
    m = torch.randn(160, 72, device=cuda_device).to(dtype)
    assert torch.equal(anemm(a, m, epilogue="swish"), lut_activation("swish")(anemm(a, m)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_conv2d_images_do_not_depend_on_batch(dtype, cuda_device, monkeypatch):
    """The first images of a 4-image call come out bit-identical in calls of
    1 to 3 images, with a tile's chunks over a cluster and walked by one
    block: Cin on the 16-byte path (8, 80) and off it (6), SAME and VALID,
    strided, the GELU fused; and within tolerance of the plain version."""
    taken = common.launch_plan

    def one_block(m, n, chunks):
        return common.LaunchPlan(taken(m, n, chunks).bm, 1)

    rng = np.random.default_rng(9)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for cin, stride, padding in ((8, (1, 2), "SAME"), (6, (2, 1), "VALID"), (80, (1, 1), "SAME")):
        x = torch.from_numpy(rng.normal(size=(4, 5, 40, cin))).to(cuda_device, dtype)
        w = torch.from_numpy(rng.normal(size=(3, 3, cin, 72)) * cin ** -0.5).to(cuda_device,
                                                                                  dtype)
        b = torch.from_numpy(rng.normal(size=(72,))).to(cuda_device, dtype)

        def run(images):
            return conv2d(images, w, b, stride=stride, padding=padding, epilogue="gelu")

        full = run(x)
        for n in (1, 2, 3):
            with monkeypatch.context() as patch:
                patch.setattr(common, "launch_plan", one_block)
                walked = run(x[:n])
            for got in (run(x[:n]), walked):
                assert torch.equal(got.view(bits), full[:n].view(bits)), (dtype, cin, n)
        want = conv2d_ref(x, w, b, stride=stride, padding=padding,
                          epilogue_table=table_operands("gelu", cuda_device))
        rtol, atol = treg.get("conv2d").tol(dtype)
        torch.testing.assert_close(full.float(), want.float(), rtol=rtol, atol=atol)
