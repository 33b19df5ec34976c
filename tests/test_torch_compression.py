"""The port's compressed-weight path against the JAX package's, on the CPU.

Packers: the port's `pack_pair_sparse` is bit-identical to the reference's;
its `pack_kn` starts from a bit-identical quantile codebook and gives the
reference's nibble planes and Lloyd codebook bit for bit (each mean taken in
numpy's float32 summation order, `pairwise.grouped_means`, itself held
against `np.mean` here). Both hold on the registry shapes and on every
matmul of smoke tinyllama.

Model: the reference's smoke tinyllama parameters are packed by the
reference (`compress_model_params`) and bridged into the port, payload bit
for bit. The port runs them on the CPU (the kernels' plain versions), the
reference through its routed model (Pallas kernels in interpret mode).
Prefill and three decode steps must agree at 4x the streaming row's
tolerance in fp32 and bf16, as `tests/test_model_dispatch_parity.py` holds
the reference's routed stack; continuous greedy streams must be
token-exact with the same dispatch kinds and ProgramCache hits and misses.
"""

import _torch_threads  # noqa: F401

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import (ExecutionStream as JStream, KernelDispatcher as JDispatcher,
                                 ProgramCache as JCache)
from repro.kernels import registry as jreg
from repro.kernels.palette.palette_matmul import pack_kn as jpack_kn
from repro.kernels.sparse.sparse_matmul import pack_pair_sparse as jpack_sparse
from repro.launch.scheduler import (ContinuousSchedule as JContinuous, Request as JRequest,
                                    merge_prefill_caches as jmerge)
from repro.models.model import build_model as jbuild
from repro.optim.compression import (compress_model_params as jcompress,
                                     decompress_model_params as jdecompress,
                                     matmul_view as jmatmul_view,
                                     weight_form_census as jcensus)
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.kernels.palette.palette_matmul import pack_kn
from repro_torch.kernels.palette.pairwise import grouped_means
from repro_torch.kernels.sparse.sparse_matmul import pack_pair_sparse
from repro_torch.launch import serve
from repro_torch.launch.scheduler import ContinuousSchedule, Request, merge_prefill_caches
from repro_torch.core.hal import WeightForm
from repro_torch.models.dispatched import FORM_KERNELS, DispatchedWeight, pack_linear_weight
from repro_torch.models.model import build_model
from repro_torch.optim.compression import (compress_model_params, decompress_model_params,
                                           weight_form_census)
from repro_torch.tree import flatten_node, leaves_with_path, tree_map
from test_torch_kernels import LUT_ULPS, ulp_distance
from test_torch_serve import GEN, LANES, LENS, NAMED_KEYS, _kinds, _prompts

ARCH = "tinyllama-1.1b"
FORMS = ("int4_palette", "sparse")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, S, DECODE_STEPS = 2, 16, 3
# the serve harness's first three prompts (5, 8, 13) on 2 lanes: decode-only
# admission, a bucket-exact prompt, teacher-forced catch-up and lane reuse,
# with one prefill bucket to compile instead of two
STREAM_LENS = LENS[:3]

_MEMO: dict = {}


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _row(form: str) -> str:
    """The kernel-registry row that streams `form`."""
    return FORM_KERNELS[WeightForm(form)].kernel


def _configs(dtype: str):
    return (dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype))


def _jparams(dtype: str):
    return init_params(_configs(dtype)[0])


def _jpacked(form: str, dtype: str):
    return _memo(("packed", form, dtype), lambda: jcompress(_jparams(dtype), form))


def _bridged(form: str, dtype: str):
    """The reference's packed parameters as the port's."""
    return params_from_numpy(jax.tree.map(np.asarray, _jpacked(form, dtype)),
                             _configs(dtype)[1], "cpu")


def _smoke_matrices() -> list[np.ndarray]:
    """Every 2-D matmul view of smoke tinyllama (fp32), layer by layer."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(_jparams("float32"))[0]:
        path_str = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        view = jmatmul_view(path_str)
        if view is None:
            continue
        w = np.asarray(leaf, np.float32)
        n_stack = w.ndim - sum(view)
        k = int(np.prod(w.shape[n_stack:n_stack + view[0]]))
        out += list(w.reshape((-1, k, int(np.prod(w.shape[n_stack + view[0]:])))))
    return out


def _registry_matrices(row: str) -> list[np.ndarray]:
    rng = np.random.default_rng(11)
    return [rng.normal(size=c.dims[1:]).astype(np.float32) for c in jreg.get(row).cases]


@pytest.mark.parametrize("source", ["registry", "smoke"])
def test_pack_pair_sparse_is_bit_identical(source):
    mats = _registry_matrices("sparse") if source == "registry" else _smoke_matrices()
    for w in mats:
        values, selector = jpack_sparse(w)
        tv, ts = pack_pair_sparse(torch.from_numpy(w.copy()))
        assert tv.dtype == torch.float16 and ts.dtype == torch.uint8
        np.testing.assert_array_equal(tv.numpy().view(np.uint16), values.view(np.uint16))
        np.testing.assert_array_equal(ts.numpy(), selector)


@pytest.mark.parametrize("source", ["registry", "smoke"])
def test_pack_kn_quantile_start_is_bit_identical(source):
    mats = _registry_matrices("palette") if source == "registry" else _smoke_matrices()
    for w in mats:
        packed, lut = jpack_kn(w, iters=0)
        tp, tl = pack_kn(torch.from_numpy(w.copy()), iters=0)
        np.testing.assert_array_equal(tl.numpy().view(np.uint32), lut.view(np.uint32))
        np.testing.assert_array_equal(tp.numpy(), packed)


@pytest.mark.parametrize("source", ["registry", "smoke"])
def test_pack_kn_matches_reference(source):
    """iters=4 (the serve path's): identical nibble planes and codebook."""
    mats = _registry_matrices("palette") if source == "registry" else _smoke_matrices()
    for w in mats:
        packed, lut = jpack_kn(w, iters=4)
        tp, tl = pack_kn(torch.from_numpy(w.copy()), iters=4)
        assert tp.dtype == torch.uint8 and tl.dtype == torch.float32
        assert ulp_distance(tl.numpy(), lut) <= LUT_ULPS
        np.testing.assert_array_equal(tp.numpy(), packed)


# every leaf shape of numpy's pairwise sum, and one, two and nine buffer
# pieces with a partial last piece
MEAN_LENGTHS = tuple(range(1, 301)) + (8191, 8192, 8193, 16385, 70001)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n", MEAN_LENGTHS)
def test_grouped_means_equal_numpy_mean(n):
    """One group: the mean's bits equal `np.mean` of the float32 array for
    normal draws, draws over ten decades, signed zeros among equal values,
    all negative zeros and one value repeated."""
    rng = np.random.default_rng(n)
    draws = [rng.normal(size=n),
             rng.normal(size=n) * 10.0 ** rng.integers(-5, 5, size=n),
             rng.choice([0.0, -0.0, 0.1, 0.1, -3.0], size=n),
             np.full(n, -0.0),
             np.full(n, 0.1)]
    for a in draws:
        a = a.astype(np.float32)
        got = grouped_means(torch.from_numpy(a), [n])
        assert got.dtype == np.float32 and got.shape == (1,)
        assert _bits(got[0]) == _bits(a.mean()), (n, a[:4])


def test_grouped_means_take_every_group_at_once():
    """Many groups of one tensor, empty ones among them (NaN), each equal
    to `np.mean` of its own slice."""
    sizes = [0, 3, 8192, 20000, 1, 129, 16384, 0, 77, 9000, 5, 200, 300, 8, 7, 70001]
    a = np.random.default_rng(7).normal(size=sum(sizes)).astype(np.float32)
    got = grouped_means(torch.from_numpy(a), sizes)
    start = 0
    for g, size in enumerate(sizes):
        if size:
            assert _bits(got[g]) == _bits(a[start:start + size].mean()), (g, size)
        else:
            assert np.isnan(got[g])
        start += size


@pytest.mark.parametrize("form", FORMS)
def test_compress_census_and_payloads_match_reference(form):
    """The port packs the bridged dense parameters itself: the same leaves
    pack, with the reference's payloads bit for bit."""
    tcfg = _configs("float32")[1]
    dense = params_from_numpy(jax.tree.map(np.asarray, _jparams("float32")), tcfg, "cpu")
    ours = compress_model_params(dense, form)
    assert weight_form_census(ours) == jcensus(_jpacked(form, "float32"))
    assert len(weight_form_census(ours)) == 8          # 7 per layer stack + unembed
    got = dict(leaves_with_path(ours))
    want = dict(leaves_with_path(_bridged(form, "float32")))
    assert list(got) == list(want)
    for path, t in got.items():
        if path.endswith("lut"):
            assert ulp_distance(t.numpy(), want[path].numpy()) <= LUT_ULPS, path
        else:
            assert torch.equal(t, want[path]), path


@pytest.mark.parametrize("form", FORMS)
def test_decompress_matches_reference_exactly(form):
    bridged = _bridged(form, "bfloat16")
    packed = [p for p, x in leaves_with_path(bridged, is_leaf=lambda x: isinstance(
        x, DispatchedWeight)) if isinstance(x, DispatchedWeight)]
    assert len(packed) == 8
    got = dict(leaves_with_path(decompress_model_params(bridged)))
    want = jax.tree_util.tree_flatten_with_path(
        jax.jit(jdecompress)(_jpacked(form, "bfloat16")))[0]
    assert len(got) == len(want)
    for path, leaf in want:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        t = got[key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}", key
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(jnp.asarray(leaf, jnp.float32)), err_msg=key)


def _parity_run(form: str, dtype: str) -> dict:
    """Prefill and teacher-forced decode through both stacks; memoized."""
    def make():
        jcfg, tcfg = _configs(dtype)
        jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
        jparams = _jpacked(form, dtype)
        tdisp = KernelDispatcher()
        tmodel = build_model(tcfg, tdisp, device="cpu")
        tparams = _bridged(form, dtype)
        tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
        jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
        tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
        out = {"logits": [(np.asarray(jlg), tlg.numpy())]}
        max_len = S + DECODE_STEPS + 1
        jcaches = jmerge(jmodel.init_cache(B, max_len), jcaches)
        tcaches = merge_prefill_caches(tmodel.init_cache(B, max_len), tcaches)
        jdecode = jax.jit(jmodel.decode_step)
        tok = np.argmax(np.asarray(jlg)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
        for i in range(DECODE_STEPS):
            pos = np.full((B,), S + i, np.int32)
            jcaches, jdl = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
            tcaches, tdl = tmodel.decode_step(tparams, tcaches, torch.from_numpy(tok),
                                              torch.from_numpy(pos))
            out["logits"].append((np.asarray(jdl), tdl.numpy()))
            tok = np.argmax(np.asarray(jdl)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
        out["routes"] = tdisp.census()
        out["jroutes"] = {(r.kernel, r.backend) for r in jmodel.dispatcher.routes}
        return out
    return _memo(("parity", form, dtype), make)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", FORMS)
def test_packed_prefill_and_decode_match_reference(form, dtype):
    run = _parity_run(form, dtype)
    rtol, atol = (4 * x for x in jreg.get(_row(form)).tol(JDT[dtype]))
    for step, (want, got) in enumerate(run["logits"]):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f"step {step}")
    # every matmul took the form's row, on both sides; nothing went to anemm
    assert {k for k, _ in run["routes"]} == {k for k, _ in run["jroutes"]} == \
        {_row(form), "flash", "decode_attention"}
    assert {b for _, b in run["routes"]} == {"torch"}


def _stream_run(form: str) -> dict:
    """Continuous greedy serving of the packed smoke model on both stacks."""
    def make():
        jcfg, tcfg = _configs("float32")
        jparams = _jpacked(form, "float32")
        jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
        prompts = _prompts(jcfg.vocab)[:len(STREAM_LENS)]
        max_len = max(STREAM_LENS) + GEN
        jcache = JCache()
        jsched = JContinuous(jmodel, jparams, jcfg, n_slots=LANES, max_len=max_len,
                             sampling="greedy", seed=0,
                             stream=JStream(jcache, target=jhal.TPU_V5E))
        jres = jsched.run([JRequest(i, p, GEN) for i, p in enumerate(prompts)])
        tmodel = build_model(tcfg, KernelDispatcher(), device="cpu")
        tcache = ProgramCache()
        tsched = ContinuousSchedule(tmodel, _bridged(form, "float32"), tcfg, n_slots=LANES,
                                    max_len=max_len, sampling="greedy",
                                    stream=ExecutionStream(tcache, device="cpu"))
        tres = tsched.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
        return {"jres": jres, "jsched": jsched, "jcache": jcache, "tres": tres,
                "tsched": tsched, "tcache": tcache}
    return _memo(("stream", form), make)


@pytest.mark.parametrize("form", FORMS)
def test_packed_continuous_streams_token_exact(form):
    run = _stream_run(form)
    assert [r.rid for r in run["tres"]] == [r.rid for r in run["jres"]]
    for j, t in zip(run["jres"], run["tres"]):
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=f"rid {j.rid}")
        assert (t.bucket, t.admitted_step, t.finished_step) == \
            (j.bucket, j.admitted_step, j.finished_step)


@pytest.mark.parametrize("form", FORMS)
def test_packed_dispatches_and_program_cache_match_reference(form):
    run = _stream_run(form)
    jkeys = [r.key for r in run["jsched"].stream.records]
    tkeys = [r.key for r in run["tsched"].stream.records]
    assert _kinds(tkeys) == _kinds(jkeys)
    for name in NAMED_KEYS:
        assert tkeys.count(name) == jkeys.count(name)
    assert (run["tcache"].stats.misses, run["tcache"].stats.hits) == \
        (run["jcache"].stats.misses, run["jcache"].stats.hits)


def test_program_keys_tell_weight_forms_apart():
    """The same model with dense, palette and sparse weights: three programs."""
    tcfg = _configs("float32")[1]
    dense = params_from_numpy(jax.tree.map(np.asarray, _jparams("float32")), tcfg, "cpu")
    model = build_model(tcfg, device="cpu")
    keys = {ProgramCache.key(model.prefill, (p,)) for p in
            (dense, _bridged("int4_palette", "float32"), _bridged("sparse", "float32"))}
    assert len(keys) == 3


def test_cli_serves_int4_palette_on_cpu(capsys):
    out = serve.run(["--smoke", "--device", "cpu", "--batch", str(LANES),
                     "--prompt-lens", ",".join(map(str, LENS)), "--gen", str(GEN),
                     "--weight-form", "int4_palette"])
    text = capsys.readouterr().out
    assert "weight form int4_palette" in text and "int4_palette: 8" in text
    assert out["weight_form"] == "int4_palette" and out["pack_s"] > 0
    assert out["weight_form_census"] == {"int4_palette": 8}
    assert {k for k, _ in out["routes"]} == {"palette", "flash", "decode_attention"}
    assert {b for _, b in out["routes"]} == {"torch"}
    assert set(out["launches"].values()) == {0}
    assert out["tokens"].shape == (len(LENS), GEN)


def test_compress_refuses_a_form_without_a_kernel():
    with pytest.raises(ValueError):
        compress_model_params({"mlp": {"wg": torch.ones(4, 4)}}, "fp16")


@pytest.mark.parametrize("form", FORMS)
def test_tree_slices_a_packed_stack_and_keeps_its_form(form):
    """`tree_map(lambda a: a[i], ...)`, as the layer loop slices its stack,
    goes into the registered node and rebuilds it with its tag; the slice
    decodes to the same layer of the dense weights."""
    stack = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 32, 4, 8))
                             .astype(np.float32))
    spec = FORM_KERNELS[WeightForm(form)]
    w = pack_linear_weight(stack, WeightForm(form), n_contract=1, n_out=2)
    assert sorted(w.payload) == sorted(spec.keys) and w.n_stack == 1
    layer = tree_map(lambda a: a[1], {"mix": {"wq": w}})["mix"]["wq"]
    assert isinstance(layer, DispatchedWeight) and layer.form == WeightForm(form)
    assert (layer.contract_shape, layer.out_shape, layer.n_stack) == ((32,), (4, 8), 0)
    want = pack_linear_weight(stack[1], WeightForm(form), n_contract=1, n_out=2)
    assert torch.equal(layer.dense(), want.dense())
    assert flatten_node(layer)[0] == (form, (32,), (4, 8), "float32")
