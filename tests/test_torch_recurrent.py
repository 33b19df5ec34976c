"""The recurrent families of the port against the JAX package's, on the CPU.

mamba2-1.3b (the SSD mixer) and recurrentgemma-9b (RG-LRU blocks and a
sliding-window MQA block, pattern (rglru, rglru, attn)) at smoke size, from
the reference's own parameters bridged into the port. The reference runs
its plain jnp path for the modules and, for the logits, its model under
`KernelDispatcher(TPU_V5E)`; the port runs on the CPU, where every kernel
call takes its plain version. JAX runs are memoised.

Held: the depthwise causal conv (fp32 tap by tap; within 1e-6, bf16 within
one bf16 rounding), the associative scan's copy against
`jax.lax.associative_scan` (fp32, rtol = atol = 1e-6), `rglru_forward` and
`ssm_forward` in prefill, decode and chunk modes (outputs and caches, fp32
within 2e-5), the windowed prefill cache of a prompt longer than the
window (positions exact, K/V within 2e-5), prefill and decode logits in
fp32 and bf16 at 4x the `anemm` registry tolerance (recurrentgemma's prompt
of 40 rolls its 32-slot ring and the decode steps wrap it), the chunk
program's logits, batch-element independence (after
`tests/test_models.py:180`, 2e-5), the init trees (with an MTP module
too), configs and layer groups.
"""

import _torch_threads  # noqa: F401

import dataclasses
import functools

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
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.model import Model as JModel, build_model as jbuild
from repro.models.transformer import layer_groups as jgroups
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import caches_to_numpy, params_from_numpy
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.launch.scheduler import merge_prefill_caches
from repro_torch.models import attention as attn
from repro_torch.models import dispatched as dsp
from repro_torch.models import rglru, ssm
from repro_torch.models.layers import _FP32_HEADS, fp32_head
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer_groups
from repro_torch.tree import leaves_with_path

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, DECODE_STEPS = 2, 3
# recurrentgemma's prompt runs past its smoke window of 32 slots
PROMPT = {"mamba2-1.3b": 24, "recurrentgemma-9b": 40}
MODULE_TOL = 2e-5


def _configs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype))


def _tol(dtype: str) -> tuple[float, float]:
    rtol, atol = jreg.get("anemm").tol(JDT[dtype])
    return 4 * rtol, 4 * atol


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str = "float32"):
    """(jcfg, jmodel, jparams, the port's bridged params)."""
    jcfg, tcfg = _configs(arch, dtype)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = init_params(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jmodel, jparams, tparams


def _first_mixer(arch: str, kind: str):
    """The reference's and the port's params of the first `kind` layer."""
    jcfg, _, jparams, tparams = reference(arch)
    groups = layer_groups(configs.get_smoke(arch))
    sub = [s for s, (k, _) in enumerate(groups[0][0]) if k == kind][0]
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0][f"sub{sub}"]["mix"])
    tp = {k: v[0] for k, v in tparams["layers"][0][f"sub{sub}"]["mix"].items()}
    return jcfg, jp, tp


def _rows(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The building blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state, dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32) * 0.5
    b = rng.normal(size=(24,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    jd, td = JDT[dtype], getattr(torch, dtype)
    want, want_state = jssm._causal_conv(jnp.asarray(x, jd), jnp.asarray(w, jd),
                                         jnp.asarray(b, jd),
                                         None if st is None else jnp.asarray(st, jd))
    got, got_state = ssm.causal_conv(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                                     torch.from_numpy(b).to(td),
                                     None if st is None else torch.from_numpy(st).to(td))
    assert got.dtype == td and got_state.dtype == td
    np.testing.assert_array_equal(_np(got_state), _jnp(want_state))
    # fp32 within 1e-6; bf16 within one rounding of the output
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(_np(got), _jnp(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 32, 40])
def test_associative_scan_matches_jax(n):
    """The torch copy of the recursion against `jax.lax.associative_scan`
    over the RG-LRU's combine, along axis 1 (rtol = atol = 1e-6)."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, size=(2, n, 16)).astype(np.float32)
    b = rng.normal(size=(2, n, 16)).astype(np.float32)
    want = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda e1, e2: (e1[0] * e2[0], e1[1] * e2[0] + e2[1]), (a, b), axis=1))(
            jnp.asarray(a), jnp.asarray(b))
    got = rglru.associative_scan(rglru._combine, (torch.from_numpy(a), torch.from_numpy(b)),
                                 axis=1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # and the scan is the recurrence h_t = a_t h_{t-1} + b_t
    h = np.zeros((2, 16), np.float32)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
    np.testing.assert_allclose(got[1][:, -1].numpy(), h, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _mixer_modes(arch: str, kind: str):
    """A mixer of `arch` through prefill (S = 12), a decode step and a chunk
    of 5 from the prefill's cache, in both packages."""
    jcfg, jp, tp = _first_mixer(arch, kind)
    tcfg = configs.get_smoke(arch)
    jmix = {"rglru": jrglru.rglru_forward, "ssm": jssm.ssm_forward}[kind]

    @functools.partial(jax.jit, static_argnames="mode")
    def jfwd(p, x, *, mode, cache=None):
        return jmix(jcfg, p, x, mode=mode, cache=cache)

    tfwd = {"rglru": rglru.rglru_forward, "ssm": ssm.ssm_forward}[kind]
    x = _rows((B, 12, jcfg.d_model), 9)
    step = _rows((B, 1, jcfg.d_model), 10)
    chunk = _rows((B, 5, jcfg.d_model), 11)
    out = {}
    jy, jc = jfwd(jp, jnp.asarray(x), mode="prefill")
    with dsp.use_dispatcher(KernelDispatcher()):
        ty, tc = tfwd(tcfg, tp, torch.from_numpy(x), mode="prefill")
        out["prefill"] = (jy, jc, ty, tc)
        jy1, jc1 = jfwd(jp, jnp.asarray(step), mode="decode", cache=jc)
        ty1, tc1 = tfwd(tcfg, tp, torch.from_numpy(step), mode="decode",
                        cache={k: v.clone() for k, v in tc.items()})
        out["decode"] = (jy1, jc1, ty1, tc1)
        jy2, jc2 = jfwd(jp, jnp.asarray(chunk), mode="decode", cache=jc)
        ty2, tc2 = tfwd(tcfg, tp, torch.from_numpy(chunk), mode="decode",
                        cache={k: v.clone() for k, v in tc.items()})
        out["chunk"] = (jy2, jc2, ty2, tc2)
    return out


@pytest.mark.parametrize("mode", ["prefill", "decode", "chunk"])
@pytest.mark.parametrize("arch,kind", [("recurrentgemma-9b", "rglru"), ("mamba2-1.3b", "ssm")])
def test_mixer_modes_match_reference(arch, kind, mode):
    jy, jc, ty, tc = _mixer_modes(arch, kind)[mode]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=MODULE_TOL, atol=MODULE_TOL)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=MODULE_TOL,
                                   atol=MODULE_TOL, err_msg=f"{arch} {mode} cache {name}")


def test_decode_mode_writes_the_cache_in_place():
    """The serving programs bind the resident cache: decode and a chunk
    update its leaves where they lie."""
    for arch, kind in (("recurrentgemma-9b", "rglru"), ("mamba2-1.3b", "ssm")):
        _, _, tp = _first_mixer(arch, kind)
        tcfg = configs.get_smoke(arch)
        init = {"rglru": rglru.init_rglru_cache, "ssm": ssm.init_ssm_cache}[kind]
        fwd = {"rglru": rglru.rglru_forward, "ssm": ssm.ssm_forward}[kind]
        cache = init(tcfg, B, torch.float32, "cpu")
        ids = {k: v.data_ptr() for k, v in cache.items()}
        with dsp.use_dispatcher(KernelDispatcher()):
            for s in (1, 4):
                x = torch.from_numpy(_rows((B, s, tcfg.d_model), s))
                _, new = fwd(tcfg, tp, x, mode="decode", cache=cache)
                assert new is cache and {k: v.data_ptr() for k, v in new.items()} == ids
                assert all(bool(v.abs().sum() > 0) for v in new.values()), arch


def test_softplus_is_logaddexp_past_the_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 20.5, 40.0, 90.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ssm.softplus(x).numpy(), want, rtol=1e-6, atol=1e-6)


def test_windowed_prefill_cache_matches_reference():
    """A prompt of 45 through a window of 32: the last 32 positions, p at
    slot p % 32 (reference `_write_prefill_cache`, :353-364)."""
    jcfg, tcfg = _configs("recurrentgemma-9b")
    s, w = 45, jcfg.attn_window
    rng = np.random.default_rng(4)
    k = rng.normal(size=(B, s, 1, 16)).astype(np.float32)
    v = rng.normal(size=(B, s, 1, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (B, s)).copy()
    want = jattn._write_prefill_cache(jcfg, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = attn._write_prefill_cache(torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(pos), tcfg.attn_window)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    assert sorted(got["pos"][0].tolist()) == list(range(s - w, s))
    assert all(int(p) % w == slot for slot, p in enumerate(got["pos"][0]))
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=MODULE_TOL,
                                   atol=MODULE_TOL)
    ring = attn.init_kv_cache(tcfg, B, 100, torch.float32, "cpu")
    assert tuple(ring["pos"].shape) == (B, w)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def logits_run(arch: str, dtype: str) -> dict:
    """Prefill + teacher-forced decode through both stacks."""
    jcfg, jmodel, jparams, tparams = reference(arch, dtype)
    tdisp = KernelDispatcher()
    tmodel = build_model(_configs(arch, dtype)[1], tdisp, device="cpu")
    s = PROMPT[arch]
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(B, s)).astype(np.int32)
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    steps = [(np.asarray(jlg), tlg.numpy())]
    max_len = s + DECODE_STEPS + 1
    jcaches = jmerge(jmodel.init_cache(B, max_len), jcaches)
    tcaches = merge_prefill_caches(tmodel.init_cache(B, max_len), tcaches)
    jdecode = jax.jit(jmodel.decode_step)
    tok = np.argmax(np.asarray(jlg)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    for i in range(DECODE_STEPS):
        pos = np.full((B,), s + i, np.int32)
        jcaches, jdl = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tcaches, tdl = tmodel.decode_step(tparams, tcaches, torch.from_numpy(tok),
                                          torch.from_numpy(pos))
        steps.append((np.asarray(jdl), tdl.numpy()))
        tok = np.argmax(np.asarray(jdl)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    return {"steps": steps, "routes": tdisp.census(),
            "caches": (jax.tree.map(np.asarray, jcaches), caches_to_numpy(tcaches))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    run = logits_run(arch, dtype)
    for step, (want, got) in enumerate(run["steps"]):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, *_tol(dtype), err_msg=f"{arch} step {step}")
    cfg = configs.get_smoke(arch)
    n_attn = sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers)) \
        if cfg.family != "ssm" else 0
    want_routes = {("anemm", "torch"): run["routes"][("anemm", "torch")]}
    if n_attn:          # windowed layers prefill outside the flash route
        want_routes[("decode_attention", "torch")] = n_attn * DECODE_STEPS
    assert run["routes"] == want_routes


@pytest.mark.parametrize("arch", ARCHS)
def test_decoded_caches_match_reference(arch):
    """After the decode steps every cache leaf agrees (fp32, 2e-5): the
    rings' positions exactly, wrapped past the window for recurrentgemma."""
    jc, tc = logits_run(arch, "float32")["caches"]
    want = dict(JModel.named_leaves(jc))
    got = dict(leaves_with_path(tc))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        if path.endswith("pos"):
            np.testing.assert_array_equal(leaf, want[path], err_msg=path)
        else:
            np.testing.assert_allclose(leaf, want[path], rtol=MODULE_TOL, atol=MODULE_TOL,
                                       err_msg=path)
    if arch == "recurrentgemma-9b":
        pos = [leaf for p, leaf in got.items() if p.endswith("pos")][0]
        last = PROMPT[arch] + DECODE_STEPS - 1
        assert pos.shape[-1] == 32 and pos.max() == last and pos.min() == last - 31


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_reference(arch):
    """A chunk of 8 resumed from a prefill of 16 (the chunk program's call):
    the last token's logits and every cache leaf (fp32, 4x the registry
    tolerance; caches 2e-5)."""
    jcfg, jmodel, jparams, tparams = reference(arch)
    tmodel = build_model(configs.get_smoke(arch), KernelDispatcher(), device="cpu")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, size=(B, 24)).astype(np.int32)
    jc, _ = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens[:, :16])})
    tc, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :16])})
    jc = jmerge(jmodel.init_cache(B, 40), jc)
    tc = merge_prefill_caches(tmodel.init_cache(B, 40), tc)
    pos0 = np.full((B,), 16, np.int32)
    jc, jlg = jax.jit(jmodel.prefill_chunk)(jparams, jc, jnp.asarray(tokens[:, 16:]),
                                            jnp.asarray(pos0))
    tc, tlg = tmodel.prefill_chunk(tparams, tc, torch.from_numpy(tokens[:, 16:]),
                                   torch.from_numpy(pos0))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), *_tol("float32"))
    want = dict(JModel.named_leaves(jax.tree.map(np.asarray, jc)))
    for path, leaf in leaves_with_path(caches_to_numpy(tc)):
        np.testing.assert_allclose(leaf, want[path], rtol=MODULE_TOL, atol=MODULE_TOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_element_independence(arch):
    """A row computed alone equals the same row inside a batch of 4 (after
    `tests/test_models.py:180`, rtol = atol = 2e-5)."""
    _, _, _, tparams = reference(arch)
    tmodel = build_model(configs.get_smoke(arch), KernelDispatcher(), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, tmodel.cfg.vocab, size=(4, 24)).astype(np.int32))

    def run(tk):
        pos = torch.arange(tk.shape[1], dtype=torch.int32)[None].expand(tk.shape)
        with torch.no_grad():
            h, _ = tmodel.forward(tparams, tk, pos, mode="prefill")
        return h.numpy()

    full, solo = run(tokens), run(tokens[:1])
    np.testing.assert_allclose(full[:1], solo, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree(arch):
    """The port's own init: the reference's tree, shapes and dtypes (fp32
    `lam`, `a_log`, `dt_bias`, `d_skip`, `norm_scale`; the conv banks in
    the model's dtype; an SSM layer without `ln2` or an MLP)."""
    jcfg, tcfg = _configs(arch, "bfloat16")
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in JModel.named_leaves(jshape)]
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in leaves_with_path(build_model(tcfg, device="cpu").init(
               torch.Generator().manual_seed(0)))]
    assert got == want
    cache_want = [(p, tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in JModel.named_leaves(
        jax.eval_shape(lambda: jbuild(jcfg).init_cache(3, 50)))]
    cache_got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
                 for p, x in leaves_with_path(build_model(tcfg, device="cpu").init_cache(3, 50))]
    assert cache_got == cache_want


def test_configs_and_layer_groups_equal_the_reference():
    for name in ARCHS:
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jconfigs.get_config(name))
        assert name in configs.ARCH_NAMES
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke, jconfigs.get_smoke)):
            assert layer_groups(get(name)) == jgroups(jget(name))
    # recurrentgemma: 12 whole periods, then its two remaining layers one by one
    assert [n for _, n in layer_groups(configs.get_config("recurrentgemma-9b"))] == [12, 1, 1]
    assert [n for _, n in layer_groups(configs.get_config("mamba2-1.3b"))] == [48]


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_archs_build_and_mla_is_still_refused(arch):
    """The full configs build; with an MTP module (refused by name until MLA
    and MTP were ported, whence the test's name) the smoke config builds
    too, its `mtp` subtree the reference's: one unstacked layer of the last
    layer's signature."""
    build_model(configs.get_config(arch), device="cpu")
    jcfg, tcfg = (dataclasses.replace(c, mtp_depth=1) for c in _configs(arch))
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in JModel.named_leaves(jshape)]
    params = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in leaves_with_path(params)] == want
    assert "layer" in params["mtp"] and "proj" in params["mtp"]


def test_fp32_head_is_made_once_per_head():
    """A dense head's fp32 copy is made once per head parameter (and per
    transpose), equal to the widening the fp32 `anemm` would do, dropped
    with the parameter; a head changed in place afterwards raises."""
    w = torch.randn(8, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    a, t = fp32_head(w, False), fp32_head(w, True)
    assert fp32_head(w, False) is a and fp32_head(w, True) is t
    assert torch.equal(a, w.float()) and torch.equal(t, w.T.float())
    assert a.dtype == torch.float32 and t.is_contiguous() and tuple(t.shape) == (16, 8)
    assert (id(w), False) in _FP32_HEADS and (id(w), True) in _FP32_HEADS
    w.add_(1)
    with pytest.raises(RuntimeError, match="in place"):
        fp32_head(w, False)
    key = (id(w), False)
    del w
    assert key not in _FP32_HEADS
    f32 = torch.ones(4, 4)
    assert fp32_head(f32, False) is f32 and (id(f32), False) not in _FP32_HEADS
