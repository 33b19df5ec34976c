"""The generated conformance harness of the port's kernel registry.

After `tests/test_conformance.py`: every case here is generated from the two
registries, with no kernel list of its own. The port's registry must name
every Pallas kernel the reference registers, and each row must mirror the
reference row: the same shape classes (names, dims, `edge` flags), dtypes
and tolerance, at least one edge case, and a work count that prices on both
roofline axes against the H100. Each (row, dtype, case) then runs the
reference's input bundle (the reference's per-case seeding) through the
reference's Pallas kernel in interpret mode and, bridged bit for bit into
torch, through the port's kernel wrapper, which on the CPU runs the plain
version; they must agree at the reference's tolerance.

Tiering, as the reference tiers it: the first non-edge case of each row at
its first dtype, and every edge case in fp32, stay in the fast lane; the
rest of the sweep is marked `slow`. The dispatcher's capability gating is not
ported yet, so no gated-route cases are generated.

The VJP leg (after `tests/test_conformance.py:130-148`): each row that
declares `make_vjp` (`anemm`, `flash`, `conv2d`, as the reference's rows
do) is differentiated at its first non-edge case in fp32, the port's
gradients through its kernel's autograd wrapper on the CPU against the
reference's `jax.grad` through its Pallas kernel's custom VJP (interpret
mode), at rtol = atol = 5e-3.
"""

import _torch_threads  # noqa: F401

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import numerics as jnumerics
from repro.kernels import registry as jreg
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import hal
from repro_torch.core.dispatch import KernelDispatcher, dtype_name
from repro_torch.kernels import native
from repro_torch.kernels import registry as treg
from repro_torch.kernels.act_lut.ops import table_operands

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}

# The one documented extension of the port's surface: float16 after the
# reference's dtypes on the two decode rows. The reference's dispatcher sends
# an fp16 decode to its plain jnp version; the port has no plain route on
# the card, so its kernels take fp16 themselves.
FP16_EXTENSION = ("decode_attention", "paged_decode_attention")


def _seed(*parts) -> np.random.Generator:
    """The reference's per-case seed (stable hash of the case's names)."""
    digest = hashlib.sha256("|".join(str(p) for p in parts).encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:4], "little"))


def _bridge(bundle: dict) -> dict:
    """The reference's bundle as the port's: arrays bit for bit, a LUT table
    as its kernel operands, names and strides as they are."""
    out = {}
    for k, v in bundle.items():
        if isinstance(v, jnumerics.LutTable):
            out[k] = table_operands(v.name, "cpu")
        elif isinstance(v, (str, tuple)):
            out[k] = v
        else:
            out[k] = tensor_from_numpy(np.asarray(v), "cpu")
    return out


def _sweep(fast: bool):
    """(row, case, dtype) of the generated sweep, the fast lane or the rest."""
    for jspec in jreg.all_specs():
        first = next(c for c in jspec.cases if not c.edge)
        for dtype in jspec.dtypes:
            name = jnp.dtype(dtype).name
            for case in jspec.cases:
                in_fast = (case.edge and name == "float32") or \
                    (case is first and dtype == jspec.dtypes[0])
                if in_fast == fast:
                    yield pytest.param(jspec.name, case.name, name,
                                       id=f"{jspec.name}-{case.name}-{name}")


def _check_case(name: str, case_name: str, dt: str) -> None:
    jspec, tspec = jreg.get(name), treg.get(name)
    case = next(c for c in jspec.cases if c.name == case_name)
    bundle = jspec.make_inputs(case, JDT[dt], _seed(jspec.name, case.name, JDT[dt]))
    want = np.asarray(jnp.asarray(jspec.run_kernel(bundle), jnp.float32))
    got = tspec.run_kernel(_bridge(bundle))
    assert tuple(got.shape) == want.shape
    rtol, atol = jspec.tol(JDT[dt])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=f"{name}/{case_name}/{dt} diverged from the "
                                       "reference's kernel")
    assert native.launch_counts()[name] == 0


class TestRegistrySurface:
    def test_names_equal_the_reference(self):
        assert [s.name for s in treg.all_specs()] == jreg.names()

    def test_every_row_declares_edge_cases_and_dtypes(self):
        for spec in treg.all_specs():
            assert any(c.edge for c in spec.cases), f"{spec.name} has no edge case"
            assert any(not c.edge for c in spec.cases), f"{spec.name} has no plain case"
            assert spec.dtypes, f"{spec.name} declares no dtypes"

    @pytest.mark.parametrize("name", jreg.names())
    def test_row_mirrors_the_reference(self, name):
        jspec, tspec = jreg.get(name), treg.get(name)
        assert [(c.name, c.dims, c.edge) for c in tspec.cases] == \
            [(c.name, c.dims, c.edge) for c in jspec.cases]
        extension = ["float16"] if name in FP16_EXTENSION else []
        assert [dtype_name(d) for d in tspec.dtypes] == \
            [jnp.dtype(d).name for d in jspec.dtypes] + extension
        for dt in tspec.dtypes:
            assert tspec.tol(dt) == jspec.tol(JDT[dtype_name(dt)])
        assert tspec.replaces.startswith("src/repro/kernels/")
        assert tspec.source.startswith("src/repro_torch/csrc/")

    @pytest.mark.parametrize("name", jreg.names())
    def test_work_prices_on_both_roofline_axes(self, name):
        spec = treg.get(name)
        for case in spec.cases:
            dt = spec.dtypes[0]
            ops, nbytes = spec.work(spec.make_inputs(case, dt, _seed(name, case.name), "cpu"))
            assert ops > 0 and nbytes > 0, (name, case.name)
            t = hal.H100
            assert ops / t.peak_for(dtype_name(dt)) > 0 and nbytes / t.hbm_bandwidth > 0

    @pytest.mark.parametrize("name", jreg.names())
    def test_every_row_routes_by_device(self, name):
        """CPU tensors route to the plain version; a device without a kernel
        raises, whatever the row."""
        disp = KernelDispatcher()
        dt = treg.get(name).dtypes[0]
        route = disp.resolve(name, torch.zeros(2, dtype=dt))
        assert (route.backend, route.reason, route.native) == ("torch", "cpu requested", False)
        with pytest.raises(ValueError, match="no route"):
            disp.resolve(name, torch.zeros(2, dtype=dt, device="meta"))


@pytest.mark.parametrize("name,case_name,dt", list(_sweep(fast=True)))
def test_kernel_matches_reference(name, case_name, dt):
    _check_case(name, case_name, dt)


@pytest.mark.slow
@pytest.mark.parametrize("name,case_name,dt", list(_sweep(fast=False)))
def test_kernel_matches_reference_sweep(name, case_name, dt):
    _check_case(name, case_name, dt)


@pytest.mark.parametrize("name,case_name", [
    pytest.param(n, c.name, id=f"{n}-{c.name}")
    for n in FP16_EXTENSION for c in jreg.get(n).cases])
def test_fp16_extension_matches_reference_plain(name, case_name):
    """The extension's fp16 cases: the port's wrapper (its plain version on
    the CPU) against the reference's plain version run in float16, on the
    reference's fp16 input bundle, at `_flash_tol(float16)`."""
    jspec, tspec = jreg.get(name), treg.get(name)
    case = next(c for c in jspec.cases if c.name == case_name)
    bundle = jspec.make_inputs(case, jnp.float16, _seed(jspec.name, case.name, jnp.float16))
    want = np.asarray(jnp.asarray(jspec.run_oracle(bundle), jnp.float32))
    got = tspec.run_kernel(_bridge(bundle))
    assert got.dtype == torch.float16 and tuple(got.shape) == want.shape
    rtol, atol = tspec.tol(torch.float16)
    assert (rtol, atol) == jspec.tol(jnp.float16) == (3e-2, 3e-2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", [s.name for s in jreg.all_specs() if s.make_vjp is not None])
def test_vjp_matches_reference(name):
    jspec, tspec = jreg.get(name), treg.get(name)
    assert tspec.make_vjp is not None
    case = next(c for c in jspec.cases if not c.edge)
    bundle = jspec.make_inputs(case, jnp.float32, _seed(jspec.name, "vjp"))
    jkernel_fn, _, jargs = jspec.make_vjp(bundle)
    want = jax.grad(jkernel_fn, tuple(range(len(jargs))))(*jargs)
    kernel_fn, plain_fn, args = tspec.make_vjp(_bridge(bundle))
    assert all(a.requires_grad and a.dtype == torch.float32 for a in args)
    got = torch.autograd.grad(kernel_fn(*args), args)
    plain = torch.autograd.grad(plain_fn(*args), args)
    assert len(got) == len(want)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3, atol=5e-3,
                                   err_msg=f"{name} VJP diverged from the reference's")
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=5e-3, atol=5e-3,
                                   err_msg=f"{name} VJP diverged from its plain math")
    assert native.launch_counts()[name] == 0


def test_vjp_rows_are_the_reference_rows():
    assert [s.name for s in treg.all_specs() if s.make_vjp is not None] == \
        [s.name for s in jreg.all_specs() if s.make_vjp is not None] == \
        ["anemm", "conv2d", "flash"]
