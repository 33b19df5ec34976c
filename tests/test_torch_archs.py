"""The dense GQA archs of the port against the JAX package's, on the CPU.

granite-8b (tied head), phi4-mini-3.8b, command-r-35b (layernorm, tied
head), chameleon-34b (QK-norm) and ane-paper (the paper's own config,
layernorm, GLU with gelu), each at smoke size, from the reference's own
parameters bridged into the port. For the logits the JAX model runs under
`KernelDispatcher(TPU_V5E)` (its Pallas kernels in interpret mode), for the
streams on its plain jnp path (no dispatcher; the Pallas compiles would
cost the file a third more time); the port on the CPU, where every kernel
call takes its plain version.

Prefill logits and three teacher-forced decode steps agree within 4x the
`anemm` registry tolerance (fp32; ane-paper also in float16, its datapath
dtype, which the reference runs on the CPU too); the greedy continuous
streams are token-exact against the reference's `ContinuousSchedule`, and
the port's sequential streams equal them. Also: each init tree equals the
reference's, command-r-35b's chunked prefill equals its unchunked one (the
reference runs the same case, `tests/test_chunked_prefill.py:110`), the
features once refused by name (MLA, MTP heads beside each family) build and
give the reference's logits, and an unknown family is refused. JAX runs are
memoised.
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
from repro.core.dispatch import (ExecutionStream as JStream, KernelDispatcher as JDispatcher,
                                 ProgramCache as JCache)
from repro.kernels import registry as jreg
from repro.launch.scheduler import (ContinuousSchedule as JContinuous, Request as JRequest,
                                    merge_prefill_caches as jmerge)
from repro.models.model import Model as JModel, build_model as jbuild
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (ChunkConfig, ContinuousSchedule, Request,
                                          SequentialSchedule, ServeConfig, build_scheduler,
                                          merge_prefill_caches)
from repro_torch.models.model import build_model
from repro_torch.tree import leaves_with_path

ARCHS = ("granite-8b", "phi4-mini-3.8b", "command-r-35b", "chameleon-34b", "ane-paper")
CASES = [(a, "float32") for a in ARCHS] + [("ane-paper", "float16")]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "float16": jnp.float16}
B, S, DECODE_STEPS = 2, 12, 3
LENS, GEN, LANES = (5, 8, 13), 4, 2


def _configs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype))


def _tol(dtype: str) -> tuple[float, float]:
    rtol, atol = jreg.get("anemm").tol(JDT[dtype])
    return 4 * rtol, 4 * atol


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str = "float32"):
    """(jcfg, jmodel, jparams, the port's bridged params)."""
    jcfg, tcfg = _configs(arch, dtype)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = init_params(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jmodel, jparams, tparams


@functools.lru_cache(maxsize=None)
def logits_run(arch: str, dtype: str) -> dict:
    """Prefill + teacher-forced decode through both stacks."""
    jcfg, jmodel, jparams, tparams = reference(arch, dtype)
    tdisp = KernelDispatcher()
    tmodel = build_model(_configs(arch, dtype)[1], tdisp, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    steps = [(np.asarray(jlg), tlg.numpy())]
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
        steps.append((np.asarray(jdl), tdl.numpy()))
        tok = np.argmax(np.asarray(jdl)[:, -1, :jcfg.vocab], -1).astype(np.int32)[:, None]
    return {"steps": steps, "routes": tdisp.census()}


def _prompts(vocab: int, lens=LENS) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in lens]


@functools.lru_cache(maxsize=None)
def streams(arch: str) -> dict:
    """Greedy streams: the reference's continuous schedule (its plain jnp
    model, no dispatcher: the logits tests hold the dispatched one), the
    port's continuous and sequential ones, on the same prompts."""
    jcfg, _, jparams, tparams = reference(arch)
    tcfg = _configs(arch)[1]
    prompts = _prompts(jcfg.vocab)
    max_len = max(LENS) + GEN
    jsched = JContinuous(jbuild(jcfg), jparams, jcfg, n_slots=LANES, max_len=max_len,
                         sampling="greedy", seed=0, stream=JStream(JCache(), target=jhal.TPU_V5E))
    jres = jsched.run([JRequest(i, p, GEN) for i, p in enumerate(prompts)])
    tmodel = build_model(tcfg, KernelDispatcher(), device="cpu")
    out = {"reference": jres}
    for name, cls, kw in (("continuous", ContinuousSchedule, {"n_slots": LANES}),
                          ("sequential", SequentialSchedule, {})):
        sched = cls(tmodel, tparams, tcfg, max_len=max_len, sampling="greedy",
                    stream=ExecutionStream(ProgramCache(), device="cpu"), **kw)
        out[name] = sched.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
    return out


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_and_decode_logits_match_reference(arch, dtype):
    run = logits_run(arch, dtype)
    for step, (want, got) in enumerate(run["steps"]):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, *_tol(dtype), err_msg=f"{arch} step {step}")
    assert run["routes"] == {("anemm", "torch"): run["routes"][("anemm", "torch")],
                             ("flash", "torch"): 3, ("decode_attention", "torch"): 9}


@pytest.mark.parametrize("schedule", ["continuous", "sequential"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_token_exact_against_reference(arch, schedule):
    run = streams(arch)
    assert [r.rid for r in run[schedule]] == [r.rid for r in run["reference"]]
    for j, t in zip(run["reference"], run[schedule]):
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=f"{arch} rid {j.rid}")
    if schedule == "continuous":
        for j, t in zip(run["reference"], run[schedule]):
            assert (t.bucket, t.admitted_step, t.finished_step) == \
                (j.bucket, j.admitted_step, j.finished_step)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree(arch):
    """The port's own init: the reference's tree, shapes and dtypes (QK-norm's
    fp32 `q_scale` / `k_scale` for chameleon, no `unembed` for a tied head)."""
    jcfg, tcfg = _configs(arch)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape), jnp.dtype(x.dtype).name) for p, x in JModel.named_leaves(jshape)]
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in leaves_with_path(build_model(tcfg, device="cpu").init(
               torch.Generator().manual_seed(0)))]
    assert got == want
    names = {p.rsplit("/", 1)[-1] for p, _, _ in got}
    assert ("q_scale" in names) == tcfg.qk_norm
    assert ("unembed" in names) != tcfg.tie_embeddings


def test_configs_equal_the_reference():
    for name in ARCHS:
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jconfigs.get_config(name))
    assert "ane-paper" not in configs.ARCH_NAMES and configs.get_config("ane-paper").dtype == \
        "float16"
    assert [n for n in jconfigs.ARCH_NAMES if n in configs.ARCH_NAMES] == configs.ARCH_NAMES


def test_rms_head_norm_matches_reference():
    from repro.models.layers import rms_head_norm as jnorm
    from repro_torch.models.layers import rms_head_norm

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    want = np.asarray(jnorm(jnp.asarray(x), jnp.asarray(scale)))
    got = rms_head_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_command_r_chunked_equals_unchunked():
    """command-r-35b smoke (layernorm, tied head): prompts served in chunks
    of 8 give the unchunked tokens."""
    _, _, _, tparams = reference("command-r-35b")
    tcfg = _configs("command-r-35b")[1]
    model = build_model(tcfg, KernelDispatcher(), device="cpu")
    lens, gen = (24, 6, 17, 16, 33), 5
    out = {}
    for chunk in (None, 8):
        config = ServeConfig(schedule="continuous", max_len=max(lens) + gen, n_slots=3,
                             stream=ExecutionStream(ProgramCache(), device="cpu"),
                             chunk=ChunkConfig(prefill_chunk=chunk) if chunk else None)
        sched = build_scheduler(config, model, tparams, tcfg)
        out[chunk] = {r.rid: r.tokens for r in sched.run(
            [Request(i, p, gen) for i, p in enumerate(_prompts(tcfg.vocab, lens))])}
    assert out[8].keys() == out[None].keys()
    for rid in out[None]:
        np.testing.assert_array_equal(out[8][rid], out[None][rid], err_msg=f"rid {rid}")
    assert sched.stats(len(lens))["chunked_prefill"]["n_chunks"] > 0


def _port_config(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


# The features this test once held refused by name (MLA, MTP heads, on their
# own and beside sliding windows, block patterns, the SSM and the hybrid) are
# ported; it keeps its name and its cases: each config builds, its init tree
# is the reference's (the MTP module included) and its smoke prefill and
# decode logits equal the reference's. Only an unknown family is refused.
@pytest.mark.parametrize("cfg", [
    pytest.param(_port_config(jconfigs.get_smoke("deepseek-v3-671b")), id="mla"),
    pytest.param(dataclasses.replace(configs.get_smoke("granite-8b"), mtp_depth=1), id="mtp"),
    pytest.param(dataclasses.replace(configs.get_smoke("granite-8b"), attn_window=8,
                                     mtp_depth=1), id="window"),
    pytest.param(dataclasses.replace(configs.get_smoke("granite-8b"),
                                     block_pattern=("attn", "attn"), mtp_depth=1),
                 id="pattern"),
    pytest.param(dataclasses.replace(configs.get_smoke("mamba2-1.3b"), use_mla=True), id="ssm"),
    pytest.param(dataclasses.replace(configs.get_smoke("recurrentgemma-9b"), mtp_depth=1),
                 id="hybrid"),
    pytest.param(dataclasses.replace(configs.get_smoke("granite-8b"), family="retnet"),
                 id="unknown-family"),
])
def test_unported_features_are_refused_by_name(cfg):
    if cfg.family == "retnet":
        with pytest.raises(NotImplementedError, match="family 'retnet'"):
            build_model(cfg, device="cpu")
        return
    jcfg = jconfigs.ModelConfig(**dataclasses.asdict(cfg))
    jmodel = jbuild(jcfg)
    jparams = init_params(jcfg)
    want = [(p, tuple(x.shape)) for p, x in JModel.named_leaves(jparams)]
    model = build_model(cfg, KernelDispatcher(), device="cpu")
    own = model.init(torch.Generator().manual_seed(0))
    assert [(p, tuple(x.shape)) for p, x in leaves_with_path(own)] == want
    assert ("mtp" in own) == bool(cfg.mtp_depth)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    s = (cfg.attn_window or 8) + 4
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, s)).astype(np.int32)
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tcaches, tlg = model.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), *_tol("float32"))
    jcaches = jmerge(jmodel.init_cache(B, s + 2), jcaches)
    tcaches = merge_prefill_caches(model.init_cache(B, s + 2), tcaches)
    tok = np.argmax(np.asarray(jlg)[:, -1, :cfg.vocab], -1).astype(np.int32)[:, None]
    pos = np.full((B,), s, np.int32)
    _, jdl = jax.jit(jmodel.decode_step)(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
    _, tdl = model.decode_step(tparams, tcaches, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), *_tol("float32"))


def test_cli_serves_ane_paper_and_refuses_a_foreign_cfg(capsys):
    """`--arch ane-paper` is offered as the reference offers it; a given
    `cfg` must be of the `--arch` family."""
    out = serve.run(["--arch", "ane-paper", "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-lens", "8,13", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert {k for k, _ in out["routes"]} == {"anemm", "flash", "decode_attention"}
    cut = dataclasses.replace(configs.get_smoke("granite-8b"), n_layers=1)
    out = serve.run(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-lens", "8,13", "--gen", "3"], cfg=cut)
    assert out["engine"].cfg.n_layers == 1
    with pytest.raises(ValueError, match="not --arch"):
        serve.run(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu"], cfg=cut)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("width", [2048, 3072, 6144, 8192])
def test_wide_norms_match_reference_and_keep_rows(norm, width):
    """Above `ONE_REDUCTION_MAX_WIDTH` a norm's mean is `row_sum`'s pairwise
    tree: the reference's norm within fp32 rounding, and each row's bits the
    same in a call of 8 rows and of 16."""
    from repro.models.layers import apply_norm as jnorm
    from repro_torch.models.layers import apply_norm

    jcfg = dataclasses.replace(jconfigs.get_smoke("granite-8b"), norm=norm, d_model=width)
    tcfg = dataclasses.replace(configs.get_smoke("granite-8b"), norm=norm, d_model=width)
    rng = np.random.default_rng(width)
    x = (rng.normal(size=(16, 1, width)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(width,)).astype(np.float32),
         "bias": rng.normal(size=(width,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items() if norm == "layernorm" or k == "scale"}
    tp = {k: torch.from_numpy(v) for k, v in p.items() if norm == "layernorm" or k == "scale"}
    want = np.asarray(jnorm(jcfg, jp, jnp.asarray(x)))
    got = apply_norm(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(apply_norm(tcfg, tp, torch.from_numpy(x[:8])), got[:8])
