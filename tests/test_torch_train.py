"""The port's training pieces against the JAX package's, on the CPU.

Held against the reference on the same weights (drawn by the port's `init`
from a seed, handed to the reference as numpy and to the port through
`repro_torch.bridge`, so no JAX init is compiled), each JAX run once a
module:

- the data pipeline (`SyntheticLM.batch`, `prompt_batch`, `host_shard`)
  bit for bit;
- `adamw.schedule` at every step 0..total, cosine and constant, within
  1e-7 relative of the reference's jitted schedule; `apply_updates` on a
  random tree in fp32 within 1e-6 relative (params and moments elementwise,
  with 1e-6 of the leaf's largest |value| as the floor where a moment
  cancels to near zero; lr and grad norm), and in bf16 equal after the
  cast;
- `quantize_int8` / `compress_grads` / `decompress_grads` bit for bit
  (codes, scales, residuals);
- `Model.loss` and the gradient of every param leaf against the
  reference's `jax.value_and_grad(model.loss)` on its plain path, at smoke
  in fp32: the loss and each metric within 2e-5 relative; each leaf within
  1e-4 of its largest |value|, for tinyllama, dbrx (the MoE balance loss),
  deepseek-v3-671b (MLA, the MTP loss), mamba2, recurrentgemma and whisper
  (frames through the conv stem). Two floors, stated where they apply: a
  leaf whose gradient is zero in exact arithmetic (a key bias: softmax
  ignores a shift shared by a query's scores) holds rounding noise, so its
  bound is at least 1e-7 of the tree's largest gradient; whisper's stem
  rounds its output to fp16 at the LUT epilogue (ANE mode), and the
  reference's plain `lax.conv` and the port's tap loop differ in the last
  fp32 bit, which moves a stem output by one fp16 step, so the stem's four
  leaves hold to 5e-3 of their largest |value|;
- five `make_train_step` steps on tinyllama smoke at lr 1e-3 against the
  reference's jitted step, without and with int8 compression: losses within
  2e-5 and every param within 1e-5 + 1e-4·|p| (with int8, a code that
  rounds the other way, a gradient an ulp from the reference's landing on
  the other side of a half step, moves its element by up to a code step:
  at most 1e-3 of a leaf's elements may be such, each within the steps'
  learning rate);
- the remat policies (`full`, `dots`, `none`) give the same loss and
  gradients bit for bit.
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
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models.model import Model as JModel, build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, compression
from repro_torch.tree import leaves_with_path, tree_map

B, S = 2, 16
LOSS_ARCHS = ("tinyllama-1.1b", "dbrx-132b", "deepseek-v3-671b", "mamba2-1.3b",
              "recurrentgemma-9b", "whisper-small")
STEM_TOL = 5e-3          # whisper's conv stem (module docstring)
ZERO_GRAD_FLOOR = 1e-7   # of the tree's largest gradient (module docstring)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _configs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype))


def _batch(cfg, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B,) + cfg.frame_shape).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_pipeline_batches_are_the_reference_bit_for_bit():
    for seed, vocab in ((0, 512), (3, 32000)):
        jsrc = jpipe.SyntheticLM(jpipe.DataConfig(vocab=vocab, seq_len=40, global_batch=4,
                                                  seed=seed))
        tsrc = pipeline.SyntheticLM(pipeline.DataConfig(vocab=vocab, seq_len=40,
                                                        global_batch=4, seed=seed))
        for step in (0, 1, 17):
            want, got = jsrc.batch(step), tsrc.batch(step)
            assert want.keys() == got.keys() == {"tokens", "targets"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            for host in range(2):
                for k, v in tsrc.host_shard(got, host, 2).items():
                    np.testing.assert_array_equal(v, jsrc.host_shard(want, host, 2)[k])
            np.testing.assert_array_equal(tsrc.prompt_batch(step, 3, 21),
                                          jsrc.prompt_batch(step, 3, 21))
    pipe = pipeline.make_pipeline(configs.get_smoke("tinyllama-1.1b"), 8, 2, seed=5,
                                  start_step=2)
    try:
        first = next(pipe)
    finally:
        pipe.close()
    np.testing.assert_array_equal(first["tokens"], pipe._source.batch(2)["tokens"])


# ---------------------------------------------------------------------------
# AdamW and int8 compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_schedule_matches_reference(kind):
    cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=7, total_steps=60, schedule_kind=kind)
    jcfg = jadamw.AdamWConfig(peak_lr=3e-4, warmup_steps=7, total_steps=60,
                              schedule_kind=kind)
    steps = np.arange(0, 61, dtype=np.int32)
    # one scalar step a call, as the reference's train step computes it (a
    # vmapped schedule would take XLA's vectorised cos, another rounding)
    jsched = jax.jit(lambda s: jadamw.schedule(jcfg, s))
    want = np.array([float(jsched(jnp.int32(s))) for s in steps], np.float32)
    got = np.array([float(adamw.schedule(cfg, torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    with pytest.raises(ValueError, match="schedule_kind"):
        adamw.schedule(dataclasses.replace(cfg, schedule_kind="linear"), torch.tensor(1))


def _random_tree(rng):
    shapes = {"a": (5, 7), "b": {"c": (300,), "d": (2, 3, 4)}, "e": [(9,), ()]}
    return tree_map(lambda s: np.asarray(rng.normal(size=s), np.float32), shapes,
                    is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(dtype):
    """Three steps of AdamW from zero moments on a random tree (the clip
    engaged on the first), fp32 moments; bf16 params and, for bf16, bf16
    moments too."""
    rng = np.random.default_rng(1)
    p_np = _random_tree(rng)
    g_nps = [tree_map(lambda x: np.asarray(rng.normal(size=x.shape) * 3, np.float32), p_np)
             for _ in range(3)]
    moment = "bfloat16" if dtype == "bfloat16" else "float32"
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moment)
    jcfg = jadamw.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                              moment_dtype=moment)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p_np)
    tp = tree_map(lambda x: torch.from_numpy(x).to(tdt), p_np)
    jstate, tstate = jadamw.init_state(jcfg, jp), adamw.init_state(cfg, tp)
    jstep = jax.jit(lambda p, g, s: jadamw.apply_updates(jcfg, p, g, s))
    for g_np in g_nps:
        jp, jstate, jm = jstep(jp, jax.tree.map(lambda x: jnp.asarray(x, jdt), g_np), jstate)
        tp, tstate, tm = adamw.apply_updates(
            cfg, tp, tree_map(lambda x: torch.from_numpy(x).to(tdt), g_np), tstate)
        assert int(tstate["step"]) == int(jstate["step"])
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for name, want, got in (("p", jp, tp), ("m", jstate["m"], tstate["m"]),
                                ("v", jstate["v"], tstate["v"])):
            for (path, w), (_, g) in zip(JModel.named_leaves(want), leaves_with_path(got)):
                assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
                if dtype == "float32":
                    w32 = _np(w)
                    np.testing.assert_allclose(_np(g), w32, rtol=1e-6,
                                               atol=1e-6 * np.abs(w32).max(),
                                               err_msg=f"{name} {path}")
                else:
                    np.testing.assert_array_equal(_np(g), _np(w), err_msg=f"{name} {path}")
    want_norm = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g_nps[0])))
    got_norm = float(adamw.global_norm(tree_map(torch.from_numpy, g_nps[0])))
    np.testing.assert_allclose(got_norm, want_norm, rtol=1e-6)


def test_int8_codes_and_residuals_are_the_reference_bit_for_bit():
    """Codes, scales and residuals of `compress_grads` over two steps of
    error feedback, a ragged leaf (not a multiple of 256), an all-zero
    block (the 1e-12 scale floor) and halves that round to even."""
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(37, 29)).astype(np.float32),
            "z": np.zeros((300,), np.float32),
            "h": (np.arange(512, dtype=np.float32) - 256) / 2}
    q, s = compression.quantize_int8(torch.from_numpy(tree["h"]))
    jq, js = jcomp.quantize_int8(jnp.asarray(tree["h"]))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jres, tres = None, None
    for step in range(2):
        g = tree_map(lambda x: x * (step + 1), tree)
        jc, jres = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jres)
        tc, tres = compression.compress_grads(tree_map(torch.from_numpy, g), tres)
        for k in tree:
            np.testing.assert_array_equal(tc[k][0].numpy(), np.asarray(jc[k][0]))
            np.testing.assert_array_equal(tc[k][1].numpy(), np.asarray(jc[k][1]))
            np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
        back = compression.decompress_grads(tc, tree_map(torch.from_numpy, g))
        jback = jcomp.decompress_grads(jc, jax.tree.map(jnp.asarray, g))
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    zeros = compression.init_residual(tree_map(torch.from_numpy, tree))
    assert all(float(t.abs().max()) == 0 and t.dtype == torch.float32
               for _, t in leaves_with_path(zeros))


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def init_params(arch: str) -> dict:
    """fp32 smoke params as numpy leaves in the reference's tree layout,
    drawn by the port's `init` (seed 0): both packages take the same
    weights from here, and no JAX init is compiled."""
    _, tcfg = _configs(arch)
    params = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(0))
    return tree_map(lambda t: t.numpy(), params)


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """(the reference's (loss, metrics), its gradient leaves by path):
    `jax.value_and_grad(model.loss)` on its plain path, fp32 smoke."""
    jcfg, _ = _configs(arch)
    jmodel = jbuild(jcfg)
    jparams = jax.tree.map(jnp.asarray, init_params(arch))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()}), \
        {p: np.asarray(g) for p, g in JModel.named_leaves(grads)}


def _port_loss_and_grads(arch: str, remat: str | None = None):
    _, tcfg = _configs(arch)
    if remat is not None:
        tcfg = dataclasses.replace(tcfg, remat=remat)
    params = params_from_numpy(init_params(arch), tcfg, "cpu")
    named = leaves_with_path(params)
    for _, t in named:
        t.requires_grad_(True)
    model = build_model(tcfg, device="cpu")
    loss, metrics = model.loss(params, {k: torch.from_numpy(v)
                                        for k, v in _batch(tcfg).items()})
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return loss.detach(), metrics, {p: g for (p, _), g in zip(named, grads)}, model


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    (want_loss, want_metrics), want = reference(arch)
    loss, metrics, got, model = _port_loss_and_grads(arch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-5)
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        rel = STEM_TOL if "/stem/" in path else 1e-4
        bound = max(rel * np.abs(w).max(), ZERO_GRAD_FLOOR * top)
        assert np.abs(g - w).max() <= bound, (path, np.abs(g - w).max(), bound)
    if arch == "deepseek-v3-671b":
        assert "mtp" in metrics and metrics["moe_aux"] > 0
    if arch == "whisper-small":
        assert model.dispatcher.census()[("conv2d", "torch")] == 2


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-small"])
def test_token_losses_average_to_the_loss_ce(arch):
    """`Model.token_losses` is the training forward's per-token cross
    entropy: (B, S), and its mean is the `ce` of `Model.loss`."""
    _, tcfg = _configs(arch)
    params = params_from_numpy(init_params(arch), tcfg, "cpu")
    model = build_model(tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    with torch.no_grad():
        per_tok = model.token_losses(params, batch)
        _, metrics = model.loss(params, batch)
    assert per_tok.shape == batch["tokens"].shape and per_tok.dtype == torch.float32
    assert torch.equal(per_tok.mean(), metrics["ce"])


def test_serving_sums_no_balance_loss():
    """dbrx smoke (MoE): the training forward returns the balance loss
    summed over layers; prefill and decode return None for it."""
    _, tcfg = _configs("dbrx-132b")
    params = params_from_numpy(init_params("dbrx-132b"), tcfg, "cpu")
    model = build_model(tcfg, device="cpu")
    tokens = torch.from_numpy(_batch(tcfg)["tokens"])
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    with torch.no_grad():
        _, _, aux = model._forward(params, tokens, positions, mode="train")
        _, caches, served = model._forward(params, tokens, positions, mode="prefill")
        _, _, decoded = model._forward(params, tokens[:, -1:], positions[:, -1:],
                                       mode="decode", caches=model.init_cache(b, s + 1))
    assert aux is not None and float(aux) > 0
    assert served is None and decoded is None and caches is not None


def test_remat_policies_give_the_same_values():
    """`full` (the smoke configs' own), `dots` and `none` on dbrx smoke:
    the same loss and gradients, bit for bit."""
    runs = {r: _port_loss_and_grads("dbrx-132b", r) for r in ("full", "dots", "none")}
    loss, _, grads, _ = runs["none"]
    for remat in ("full", "dots"):
        other_loss, _, other, _ = runs[remat]
        assert torch.equal(other_loss, loss), remat
        for path, g in grads.items():
            assert torch.equal(other[path], g), (remat, path)


def test_packed_weights_and_pools_are_forward_only():
    from repro_torch.core.dispatch import KernelDispatcher
    from repro_torch.models import dispatched as dsp
    from repro_torch.optim.compression import compress_model_params

    w = torch.randn(64, 32)
    packed = compress_model_params({"mlp": {"wg": w}}, "int4_palette")["mlp"]["wg"]
    x = torch.randn(3, 64, requires_grad=True)
    with dsp.use_dispatcher(KernelDispatcher()):
        with pytest.raises(ValueError, match="forward-only"):
            dsp.linear(x, packed)
        with torch.no_grad():
            assert dsp.linear(x, packed).shape == (3, 32)
        with pytest.raises(ValueError, match="forward-only"):
            dsp.max_pool(torch.randn(1, 4, 4, 2, requires_grad=True), window=(2, 2))


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

STEP_ARCH, STEPS, LR = "tinyllama-1.1b", 5, 1e-3


@functools.lru_cache(maxsize=None)
def reference_steps(compression_kind: str):
    """The reference's jitted train step, five steps on the pipeline's
    batches: (initial params, losses, final params by path)."""
    jcfg, _ = _configs(STEP_ARCH)
    jmodel = jbuild(jcfg)
    opt = jadamw.AdamWConfig(peak_lr=LR, warmup_steps=2, total_steps=STEPS)
    init = init_params(STEP_ARCH)
    params = jax.tree.map(jnp.asarray, init)
    state = jadamw.init_state(opt, params)
    if compression_kind == "int8":
        state["residual"] = jcomp.init_residual(params)
    step = jax.jit(jtrain.make_train_step(jmodel, opt, compression_kind))
    src = jpipe.SyntheticLM(jpipe.DataConfig(vocab=jcfg.vocab, seq_len=S, global_batch=B))
    losses = []
    for t in range(STEPS):
        params, state, metrics = step(params, state, {k: jnp.asarray(v)
                                                      for k, v in src.batch(t).items()})
        losses.append(float(metrics["loss"]))
    return init, losses, {p: np.asarray(x) for p, x in JModel.named_leaves(params)}


@pytest.mark.parametrize("compression_kind", ["none", "int8"])
def test_train_steps_match_reference(compression_kind):
    init, want_losses, want = reference_steps(compression_kind)
    _, tcfg = _configs(STEP_ARCH)
    model = build_model(tcfg, device="cpu")
    opt = adamw.AdamWConfig(peak_lr=LR, warmup_steps=2, total_steps=STEPS)
    params = params_from_numpy(init, tcfg, "cpu")
    state = adamw.init_state(opt, params)
    if compression_kind == "int8":
        state["residual"] = compression.init_residual(params)
    step = train.make_train_step(model, opt, compression_kind)
    src = pipeline.SyntheticLM(pipeline.DataConfig(vocab=tcfg.vocab, seq_len=S,
                                                   global_batch=B))
    resident = [t for _, t in leaves_with_path(params)]
    losses = []
    for t in range(STEPS):
        params, state, metrics = step(params, state, {k: torch.from_numpy(v)
                                                      for k, v in src.batch(t).items()})
        losses.append(float(metrics["loss"]))
        assert set(metrics) >= {"loss", "ce", "zloss", "moe_aux", "tokens", "lr", "grad_norm"}
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=2e-5)
    got = dict(leaves_with_path(params))
    assert all(a is b for a, b in zip(resident, got.values()))      # updated in place
    assert not any(t.requires_grad for t in got.values())
    for path, w in want.items():
        g = _np(got[path])
        beyond = np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)
        if compression_kind == "none":
            assert not beyond.any(), (path, np.abs(g - w).max())
        else:
            # an int8 code is a rounding of the gradient: a gradient an ulp
            # away (XLA's sums against torch's) lands some codes on the other
            # side of a half step, and such an element's update differs by a
            # code step of its block; at most 1e-3 of a leaf's elements (at
            # most 1.2e-4 measured), each off by less than the steps' whole
            # learning rate
            assert beyond.sum() <= max(1, 1e-3 * w.size), (path, int(beyond.sum()))
            assert (np.abs(g - w)[beyond] < STEPS * LR).all(), path
    assert int(state["step"]) == STEPS
    if compression_kind == "int8":
        assert float(state["residual"]["embed"]["table"].abs().max()) > 0


def test_train_step_refuses_an_unknown_compression():
    with pytest.raises(ValueError, match="grad_compression"):
        train.make_train_step(build_model(configs.get_smoke(STEP_ARCH), device="cpu"),
                              adamw.AdamWConfig(), "fp8")

