"""The port's model against the JAX model, on the CPU, from the same weights.

tinyllama smoke in fp32 and in bf16: the reference's parameters are bridged
into the port. The JAX model is routed through `KernelDispatcher(TPU_V5E)`
(its Pallas kernels in interpret mode); the port runs on the CPU, where
every kernel call takes its plain version. Prefill logits, every cache leaf,
and three teacher-forced decode steps (fed the reference's greedy tokens)
must agree at 4x the `anemm` registry tolerance, as
`tests/test_model_dispatch_parity.py` holds the routed JAX stack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import KernelDispatcher as JDispatcher
from repro.kernels import registry as jreg
from repro.launch.scheduler import merge_prefill_caches as jmerge
from repro.models.model import Model as JModel, build_model as jbuild
from repro_torch import configs
from repro_torch.bridge import caches_from_numpy, caches_to_numpy, params_from_numpy
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.launch.scheduler import merge_prefill_caches
from repro_torch.models.model import build_model
from repro_torch.tree import leaves_with_path

ARCH = "tinyllama-1.1b"
DTYPES = ("float32", "bfloat16")
B, S, DECODE_STEPS = 2, 16, 3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tolerance(dtype: str) -> tuple[float, float]:
    rtol, atol = jreg.get("anemm").tol(JDT[dtype])
    return 4 * rtol, 4 * atol


def _configs(dtype: str):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype)
    return jcfg, tcfg


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


_RUNS: dict = {}


def _run(dtype: str) -> dict:
    """Prefill + decode through both stacks once per dtype; memoized."""
    if dtype in _RUNS:
        return _RUNS[dtype]
    jcfg, tcfg = _configs(dtype)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tdisp = KernelDispatcher()
    tmodel = build_model(tcfg, tdisp, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    out = {"prefill": (np.asarray(jlg), tlg.numpy()),
           "prefill_caches": (JModel.named_leaves(jcaches),
                              leaves_with_path(caches_to_numpy(tcaches)))}

    max_len = S + DECODE_STEPS + 1
    jcaches = jmerge(jmodel.init_cache(B, max_len), jcaches)
    tcaches = merge_prefill_caches(tmodel.init_cache(B, max_len), tcaches)
    jdecode = jax.jit(jmodel.decode_step)
    tok = np.argmax(np.asarray(jlg)[:, -1, :jcfg.vocab], axis=-1).astype(np.int32)[:, None]
    steps = []
    for i in range(DECODE_STEPS):
        pos = np.full((B,), S + i, np.int32)
        jcaches, jdl = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tcaches, tdl = tmodel.decode_step(tparams, tcaches, torch.from_numpy(tok),
                                          torch.from_numpy(pos))
        steps.append((np.asarray(jdl), tdl.numpy()))
        tok = np.argmax(np.asarray(jdl)[:, -1, :jcfg.vocab], axis=-1).astype(np.int32)[:, None]
    out["decode"] = steps
    out["decode_caches"] = (JModel.named_leaves(jcaches),
                            leaves_with_path(caches_to_numpy(tcaches)))
    out["routes"] = set(tdisp.census())
    out["jroutes"] = {(r.kernel, r.backend) for r in jmodel.dispatcher.routes}
    _RUNS[dtype] = out
    return out


def _assert_caches_match(jleaves, tleaves, tol):
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, jl), (_, tl) in zip(jleaves, tleaves):
        assert tuple(tl.shape) == tuple(jl.shape), path
        if path.endswith("pos"):
            np.testing.assert_array_equal(tl, np.asarray(jl), err_msg=path)
        else:
            np.testing.assert_allclose(tl, _np(jl), rtol=tol[0], atol=tol[1], err_msg=path)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_caches_match_reference(dtype):
    run = _run(dtype)
    want, got = run["prefill"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, *_tolerance(dtype))
    _assert_caches_match(*run["prefill_caches"], _tolerance(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
    run = _run(dtype)
    for i, (want, got) in enumerate(run["decode"]):
        np.testing.assert_allclose(got, want, *_tolerance(dtype), err_msg=f"step {i}")
    _assert_caches_match(*run["decode_caches"], _tolerance(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_routes_cover_the_reference_kernels(dtype):
    """Same (kernel) set as the JAX routes; on the CPU every port route is
    the plain version (the JAX log counts traces, the port's calls, so only
    the sets compare)."""
    run = _run(dtype)
    assert {k for k, _ in run["routes"]} == {k for k, _ in run["jroutes"]} == \
        {"anemm", "flash", "decode_attention"}
    assert {b for _, b in run["routes"]} == {"torch"}
    assert {b for _, b in run["jroutes"]} == {"pallas"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_matches_reference_tree(dtype):
    """The port's own init: the reference's tree, shapes and dtypes."""
    jcfg, tcfg = _configs(dtype)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in JModel.named_leaves(jshape)]
    tmodel = build_model(tcfg, device="cpu")
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in leaves_with_path(tmodel.init(torch.Generator().manual_seed(0)))]
    assert got == want
    jc = JModel.named_leaves(jax.eval_shape(lambda: jbuild(jcfg).init_cache(3, 20)))
    tc = leaves_with_path(tmodel.init_cache(3, 20))
    assert [(p, tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in tc] == \
        [(p, tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in jc]


def test_cache_bridge_round_trip():
    """The reference's caches bridge in leaf for leaf; the port's bridge back."""
    run = _run("bfloat16")
    jleaves, tleaves = run["prefill_caches"]
    jtree = [{"sub0": {p.rsplit("/", 1)[-1]: np.asarray(x) for p, x in jleaves}}]
    bridged = caches_from_numpy(jtree, "cpu")
    got = leaves_with_path(bridged)
    assert [p for p, _ in got] == [p for p, _ in tleaves]
    for (path, t), (_, j) in zip(got, jleaves):
        assert t.dtype == (torch.int32 if path.endswith("pos") else torch.bfloat16)
        np.testing.assert_array_equal(caches_to_numpy(t), _np(j), err_msg=path)


def test_init_is_seeded():
    _, tcfg = _configs("float32")
    model = build_model(tcfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(5))
    b = model.init(torch.Generator().manual_seed(5))
    for (_, x), (_, y) in zip(leaves_with_path(a), leaves_with_path(b)):
        assert torch.equal(x, y)


def test_plain_decode_attention_matches_reference():
    """`_decode_attention`, the plain one-token path, against the
    reference's, and against the decode kernel's plain version."""
    from repro.models.attention import _decode_attention as jdecode
    from repro_torch.kernels.flash.decode_attention import decode_attention_ref
    from repro_torch.models.attention import _decode_attention

    jcfg, _ = _configs("float32")
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 20, 2, 16)).astype(np.float32)
    v = rng.normal(size=(3, 20, 2, 16)).astype(np.float32)
    pos = np.where(np.arange(20)[None] < np.array([[7], [20], [0]]),
                   np.arange(20)[None], -1).astype(np.int32)
    cur = np.array([[6], [25], [0]], np.int32)
    want = np.asarray(jdecode(jcfg, jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                                     "pos": jnp.asarray(pos)},
                              jnp.asarray(cur)))
    cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v), "pos": torch.from_numpy(pos)}
    got = _decode_attention(torch.from_numpy(q), cache, torch.from_numpy(cur))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    kernel_plain = decode_attention_ref(torch.from_numpy(q[:, 0]), cache["k"], cache["v"],
                                        cache["pos"], torch.from_numpy(cur[:, 0]))
    np.testing.assert_allclose(kernel_plain.numpy(), want[:, 0], rtol=2e-3, atol=2e-3)


def test_linear_outside_a_dispatcher_raises():
    from repro_torch.models.dispatched import linear

    with pytest.raises(RuntimeError):
        linear(torch.ones(2, 4), torch.ones(4, 3))


def test_unported_configs_are_refused():
    _, tcfg = _configs("float32")
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(tcfg, attn_window=8), device="cpu")
