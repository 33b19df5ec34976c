"""MLA and deepseek-v3-671b of the port against the JAX package's, on the CPU.

deepseek-v3-671b smoke (3 layers: one dense, two MoE with a shared expert;
MLA with q_lora = kv_lora = 32, rope 8, nope 8, v 16; an MTP module) from
the reference's own parameters bridged into the port. The modules run the
reference's plain jnp path; the logits run its model under
`KernelDispatcher(TPU_V5E)` (Pallas kernels in interpret mode); the port
runs on the CPU, where every kernel call takes its plain version. JAX runs
are memoised.

Held: the config and the init tree (MTP module included, unstacked) equal
the reference's; `_mla_qkv_latent` and `_mla_forward` in prefill, decode
(one token) and chunk (four tokens) modes, outputs and caches, fp32 within
2e-5 and bf16 within 3e-2 (a bf16 output rounds twice on the absorbed
path); prefill, decode and chunk-program logits at 4x the registry
tolerance of the kernel that streams the weights (`anemm` in fp32 and
bf16, `palette` / `sparse` packed, after
`tests/test_model_dispatch_parity.py:45,178`); the packed-leaf census of
both forms equals the reference's `compress_model_params` (`wq_b` / `wkv_b`
dense); the latent norms and the absorbed decode keep each lane's bits
whatever the number of lanes; the launch count of a forward (5 projections
an MLA layer at prefill, 4 at decode).
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
from repro.models.layers import rms_head_norm as jnorm
from repro.models.model import Model as JModel, build_model as jbuild
from repro.optim.compression import weight_form_census as jcensus
from _reference_params import packed_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.launch.scheduler import merge_prefill_caches
from repro_torch.models import attention as attn
from repro_torch.models import dispatched as dsp
from repro_torch.models.model import build_model
from repro_torch.optim.compression import compress_model_params, weight_form_census
from repro_torch.tree import leaves_with_path

ARCH = "deepseek-v3-671b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
B, S, DECODE_STEPS, CHUNK = 2, 12, 3, 4
MODULE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
FORM_KERNEL = {"fp16": "anemm", "int4_palette": "palette", "sparse": "sparse"}


def _configs(dtype: str = "float32"):
    return (dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype))


def _tol(kernel: str, dtype: str = "float32") -> tuple[float, float]:
    rtol, atol = jreg.get(kernel).tol(JDT[dtype])
    return 4 * rtol, 4 * atol


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def reference(dtype: str = "float32", form: str = "fp16"):
    """(jmodel, jparams, the port's bridged params), dense or packed by the
    reference's `compress_model_params`."""
    jcfg, tcfg = _configs(dtype)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = packed_params(jcfg, form)
    return jmodel, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def logits_run(dtype: str, form: str) -> dict:
    """Prefill, three teacher-forced decode steps and one chunk program
    through both stacks."""
    jcfg, tcfg = _configs(dtype)
    jmodel, jparams, tparams = reference(dtype, form)
    tdisp = KernelDispatcher()
    tmodel = build_model(tcfg, tdisp, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    steps = [("prefill", np.asarray(jlg), tlg.numpy())]
    max_len = S + DECODE_STEPS + CHUNK + 1
    jcaches = jmerge(jmodel.init_cache(B, max_len), jcaches)
    tcaches = merge_prefill_caches(tmodel.init_cache(B, max_len), tcaches)
    tok = np.argmax(np.asarray(jlg)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    jdecode = jax.jit(jmodel.decode_step)        # one compile for every step
    for i in range(DECODE_STEPS):
        pos = np.full((B,), S + i, np.int32)
        jcaches, jdl = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tcaches, tdl = tmodel.decode_step(tparams, tcaches, torch.from_numpy(tok),
                                          torch.from_numpy(pos))
        steps.append((f"decode {i}", np.asarray(jdl), tdl.numpy()))
        tok = np.argmax(np.asarray(jdl)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    chunk = np.random.default_rng(1).integers(0, jcfg.vocab, size=(B, CHUNK)).astype(np.int32)
    pos0 = np.full((B,), S + DECODE_STEPS, np.int32)
    _, jcl = jax.jit(jmodel.prefill_chunk)(jparams, jcaches, jnp.asarray(chunk),
                                           jnp.asarray(pos0))
    _, tcl = tmodel.prefill_chunk(tparams, tcaches, torch.from_numpy(chunk),
                                  torch.from_numpy(pos0))
    steps.append(("chunk", np.asarray(jcl), tcl.numpy()))
    return {"steps": steps, "routes": tdisp.census(), "params": tparams}


# ---------------------------------------------------------------------------
# config and init
# ---------------------------------------------------------------------------


def test_config_equals_the_reference_and_is_registered():
    assert dataclasses.asdict(configs.get_config(ARCH)) == \
        dataclasses.asdict(jconfigs.get_config(ARCH))
    assert dataclasses.asdict(configs.get_smoke(ARCH)) == \
        dataclasses.asdict(jconfigs.get_smoke(ARCH))
    assert configs.ARCH_NAMES == [n for n in jconfigs.ARCH_NAMES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_reference_tree(dtype):
    """Path for path, shape for shape, dtype for dtype: the MLA leaves
    (fp32 `q_norm` / `kv_norm`, 3-D `wq_b` / `wkv_b` / `wo`) and the `mtp`
    subtree (`proj`, `ln_h`, `ln_e`, one unstacked layer of the last
    layer's signature)."""
    jcfg, tcfg = _configs(dtype)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in JModel.named_leaves(jshape)]
    params = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in leaves_with_path(params)]
    assert got == want
    assert params["mtp"]["layer"]["moe"]["wg"].shape == (4, 64, 64)       # no stack axis
    assert params["layers"][1]["sub0"]["mix"]["wkv_b"].shape == (2, 32, 4, 8 + 16)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _mixer(dtype: str):
    """The first MLA mixer's params in both packages, and the configs."""
    jcfg, tcfg = _configs(dtype)
    _, jparams, tparams = reference(dtype)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"][0]["sub0"]["mix"])
    tp = {k: v[0] for k, v in tparams["layers"][0]["sub0"]["mix"].items()}
    return jcfg, tcfg, jp, tp


def _inputs(cfg, dtype: str, s: int, start):
    rng = np.random.default_rng(s)
    x = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    pos = (np.asarray(start)[:, None] + np.arange(s)[None]).astype(np.int32)
    return (jnp.asarray(x, JDT[dtype]), jnp.asarray(pos),
            torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos))


def _close(got, want, dtype: str, what: str) -> None:
    tol = MODULE_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_latent_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _mixer(dtype)
    jx, jpos, tx, tpos = _inputs(tcfg, dtype, 7, [0, 5])
    want = jattn._mla_qkv_latent(jcfg, jp, jx, jpos)
    with dsp.use_dispatcher(KernelDispatcher()):
        got = attn._mla_qkv_latent(tcfg, tp, tx, tpos)
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"), got, want):
        assert g.dtype == tx.dtype and tuple(g.shape) == w.shape, name
        _close(g, w, dtype, name)


def _latent_cache(cfg, dtype: str, max_len: int, lens) -> tuple[dict, dict]:
    """A decode cache in both packages: random latents in each lane's first
    `lens[b]` slots (positions 0..lens[b]-1), the rest empty."""
    rng = np.random.default_rng(9)
    c = {"c_kv": rng.normal(size=(B, max_len, cfg.kv_lora_rank)).astype(np.float32),
         "k_rope": rng.normal(size=(B, max_len, cfg.qk_rope_dim)).astype(np.float32),
         "pos": np.full((B, max_len), -1, np.int32)}
    for b, n in enumerate(lens):
        c["pos"][b, :n] = np.arange(n)
    jc = {k: jnp.asarray(v, jnp.int32 if k == "pos" else JDT[dtype]) for k, v in c.items()}
    tc = {k: torch.from_numpy(v).to(torch.int32 if k == "pos" else getattr(torch, dtype))
          for k, v in c.items()}
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode", "chunk"])
def test_mla_forward_matches_reference(mode, dtype):
    """Outputs and caches of `_mla_forward`: prefill from position 0; one
    decode token, and a chunk of four, after lanes of 9 and 6 cached tokens
    (the absorbed form, each query masked to its own position)."""
    jcfg, tcfg, jp, tp = _mixer(dtype)
    lens = np.array([9, 6])
    s = {"prefill": 9, "decode": 1, "chunk": CHUNK}[mode]
    jx, jpos, tx, tpos = _inputs(tcfg, dtype, s, [0, 0] if mode == "prefill" else lens)
    jcache = tcache = None
    if mode != "prefill":
        jcache, tcache = _latent_cache(tcfg, dtype, 16, lens)
    jmode = "prefill" if mode == "prefill" else "decode"
    want, want_cache = jattn._mla_forward(jcfg, jp, jx, jpos, mode=jmode, cache=jcache)
    with dsp.use_dispatcher(KernelDispatcher()):
        got, got_cache = attn._mla_forward(tcfg, tp, tx, tpos, mode=jmode, cache=tcache)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    _close(got, want, dtype, f"{mode} out")
    assert sorted(got_cache) == sorted(want_cache) == ["c_kv", "k_rope", "pos"]
    np.testing.assert_array_equal(got_cache["pos"].numpy(), np.asarray(want_cache["pos"]))
    for name in ("c_kv", "k_rope"):
        _close(got_cache[name], want_cache[name], dtype, f"{mode} cache {name}")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,form", [("float32", "fp16"), ("bfloat16", "fp16"),
                                        ("float32", "int4_palette"), ("float32", "sparse")])
def test_prefill_decode_and_chunk_logits_match_reference(dtype, form):
    kernel = FORM_KERNEL[form]
    run = logits_run(dtype, form)
    for step, want, got in run["steps"]:
        assert got.dtype == np.float32 and got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, *_tol(kernel, dtype), err_msg=f"{form} {step}")
    # MLA never reaches the attention kernels; wq_b / wkv_b stay dense
    assert {k for k, _ in run["routes"]} == {"anemm"} | {kernel}


@pytest.mark.parametrize("form", ["int4_palette", "sparse"])
def test_packed_census_matches_reference(form):
    """The port packs the bridged dense params into the reference's census:
    `wq_a`, `wkv_a`, `wo`, the MLPs, the expert banks and shared MLPs, the
    MTP module's `proj` and layer, and the head; `wq_b` / `wkv_b` dense."""
    _, jparams, tparams = reference()
    census = weight_form_census(compress_model_params(tparams, form))
    assert census == jcensus(packed_params(_configs()[0], form))
    names = {p.rsplit("/", 1)[-1] for p in census}
    assert {"wq_a", "wkv_a", "wo", "proj", "unembed"} <= names
    assert not names & {"wq_b", "wkv_b", "router"}
    assert "mtp/proj" in census and "mtp/layer/mix/wq_a" in census
    assert len(census) == 26


def test_launches_per_forward():
    """The routed matmuls: 5 an MLA layer at prefill (`wkv_b` expands the
    latent), 4 at decode and in a chunk (the absorbed products run outside
    any kernel), 3 a dense MLP, 3 per expert bank and 3 for the shared MLP,
    and the head."""
    _, tcfg = _configs()
    model = build_model(tcfg, KernelDispatcher(), device="cpu")
    params = reference()[2]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, size=(B, S)).astype(np.int32))
    dense, moe = 3, 3 * tcfg.n_experts + 3
    for mix, run in ((5, lambda c: model.prefill(params, {"tokens": tokens})),
                     (4, lambda c: model.decode_step(params, c, tokens[:, :1],
                                                     torch.full((B,), S, dtype=torch.int32))),
                     (4, lambda c: model.prefill_chunk(params, c, tokens[:, :CHUNK],
                                                       torch.full((B,), S, dtype=torch.int32)))):
        caches = merge_prefill_caches(model.init_cache(B, 2 * S),
                                      model.prefill(params, {"tokens": tokens})[0])
        model.dispatcher.routes.clear()
        run(caches)
        assert model.dispatcher.census() == {("anemm", "torch"): 3 * mix + dense + 2 * moe + 1}


def test_lane_bits_do_not_change_with_the_lane_count():
    """Decode on 8 lanes and on the same 8 lanes twice over (16 rows): the
    first 8 rows' logits are equal bit for bit (a 16-row tree verify must
    pick what 8-row decode picks), and so are the latent norms' rows."""
    _, tcfg = _configs()
    model = build_model(tcfg, KernelDispatcher(), device="cpu")
    params = reference()[2]
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(8, 4)).astype(np.int32))

    def run(repeat: int) -> torch.Tensor:
        caches, rows = model.init_cache(8 * repeat, 8), []
        for step in range(tokens.shape[1]):
            pos = torch.full((8 * repeat,), step, dtype=torch.int32)
            caches, lg = model.decode_step(params, caches, tokens[:, step:step + 1].repeat(
                repeat, 1), pos)
            rows.append(lg[:8])
        return torch.stack(rows)

    assert torch.equal(run(1), run(2))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(16, 1, 1536))
                         .astype(np.float32)) * 3
    scale = torch.from_numpy(np.random.default_rng(4).normal(size=(1536,)).astype(np.float32))
    got = attn.latent_norm(x, scale)
    assert torch.equal(attn.latent_norm(x[:8], scale), got[:8])
    want = np.asarray(jnorm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
