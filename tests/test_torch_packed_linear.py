"""The port's `PaletteLinear` / `SparseLinear` against the reference's.

The reference's cases (`tests/test_kernels.py` `test_hbm_bytes_quartered`,
`test_byte_ratio`) on 256 x 128 weights drawn with numpy: the packed
operands bit for bit, `hbm_bytes()` and `dense_bytes()` equal, and the
byte ratios the reference asserts. The outputs of a 16-row activation
against the reference's wrappers (Pallas in interpret mode): fp32 within
1e-4 (rtol and atol, the reference's own kernel-vs-oracle tolerance), bf16
within 2e-2 (its bf16 one). Both are forward-only. On the card (`cuda`,
skipped here) a call launches the wrapper's kernel once and agrees with
the plain version at the registry's tolerance. Only the tests that
compare with the reference import it, so the file's `cuda` tests run on
the card, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_packed_linear.py
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from repro_torch.kernels import native, registry
from repro_torch.kernels.palette.ops import PaletteLinear
from repro_torch.kernels.palette.ref import palette_matmul_ref
from repro_torch.kernels.sparse.ops import SparseLinear
from repro_torch.kernels.sparse.ref import sparse_matmul_ref

K, N, M = 256, 128, 16
WRAPPERS = {"palette": (PaletteLinear, ("packed", "lut")),
            "sparse": (SparseLinear, ("values", "selector"))}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _reference(kind: str):
    if kind == "palette":
        from repro.kernels.palette.ops import PaletteLinear as ref
    else:
        from repro.kernels.sparse.ops import SparseLinear as ref
    return ref


def _weight(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(K, N)).astype(np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_packed_operands_and_bytes_match_reference(kind):
    (cls, fields), jcls = WRAPPERS[kind], _reference(kind)
    w = _weight()
    lin, jlin = cls.pack(w), jcls.pack(w)
    assert lin.shape == jlin.shape == (K, N)
    for f in fields:
        np.testing.assert_array_equal(getattr(lin, f).numpy(), np.asarray(getattr(jlin, f)),
                                      err_msg=f)
    assert lin.hbm_bytes() == jlin.hbm_bytes()
    assert lin.dense_bytes() == jlin.dense_bytes() == K * N * 2
    if kind == "palette":
        assert lin.dense_bytes() / lin.hbm_bytes() > 3.5      # the reference's bar
    else:
        assert 0.5 < lin.hbm_bytes() / lin.dense_bytes() < 0.57


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_outputs_match_reference(kind, dtype):
    import jax.numpy as jnp

    cls, jcls = WRAPPERS[kind][0], _reference(kind)
    w = _weight(1)
    a = np.random.default_rng(2).normal(size=(M, K)).astype(np.float32)
    got = cls.pack(torch.from_numpy(w))(torch.from_numpy(a).to(dtype))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcls.pack(w)(jnp.asarray(a, jdt))
    assert got.dtype == dtype and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_forward_only(kind):
    lin = WRAPPERS[kind][0].pack(_weight())
    a = torch.randn(3, K, requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        lin(a)
    with torch.no_grad():
        assert lin(a).shape == (3, N)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(WRAPPERS))
def test_cuda_call_launches_the_kernel(kind, cuda_device):
    native.build()
    cls = WRAPPERS[kind][0]
    lin = cls.pack(torch.from_numpy(_weight()).to(cuda_device))
    a = torch.from_numpy(np.random.default_rng(3).normal(size=(M, K)).astype(np.float32))
    a = a.to(cuda_device, torch.bfloat16)
    native.reset_launch_counts()
    got = lin(a)
    torch.cuda.synchronize()
    assert native.launch_counts()[kind] == 1
    plain = palette_matmul_ref(a, lin.packed, lin.lut) if kind == "palette" else \
        sparse_matmul_ref(a, lin.values, lin.selector)
    rtol, atol = registry.get(kind).tol(torch.bfloat16)
    torch.testing.assert_close(got.float(), plain.float(), rtol=rtol, atol=atol)
