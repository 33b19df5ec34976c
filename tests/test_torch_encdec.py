"""The port's encoder-decoder (whisper-small) against the JAX package's, on the CPU.

whisper-small smoke (2 encoder and 3 decoder layers, d 64, frames (48, 80)
through the two-conv stem) in fp32 and bf16, from the reference's own
parameters bridged into the port. The JAX model runs under
`KernelDispatcher(TPU_V5E)` (its Pallas kernels in interpret mode); the port
on the CPU, where every kernel call takes its plain version. The encoder
output must agree within 4x the `conv2d` registry tolerance (as
`benchmarks/bench_encoder.py` holds it), prefill and decode logits and every
leaf of the `{"self", "cross"}` caches within 4x the `anemm` tolerance. The
greedy continuous and sequential streams must be token-exact against the
reference's schedules on the same frames, with the same dispatch kinds and
ProgramCache hits and misses. Also here: the gelu repair (`_ACTS["gelu"]` is
`jax.nn.gelu`'s tanh form) and the plain gelu MLP with biases.
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
from repro.launch.scheduler import (ContinuousSchedule as JContinuous, Request as JRequest,
                                    SequentialSchedule as JSequential,
                                    merge_prefill_caches as jmerge)
from repro.models import dispatched as jdsp
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.model import Model as JModel, build_model as jbuild
from repro.parallel.ctx import CPU_CTX
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import caches_to_numpy, params_from_numpy, tensor_from_numpy
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.kernels import native
from repro_torch.launch import serve
from repro_torch.launch.scheduler import ContinuousSchedule, Request, SequentialSchedule
from repro_torch.launch.scheduler import merge_prefill_caches
from repro_torch.models import dispatched as dsp
from repro_torch.models import encdec, layers
from repro_torch.models.model import build_model
from repro_torch.tree import leaves_with_path

ARCH = "whisper-small"
DTYPES = ("float32", "bfloat16")
B, S, DECODE_STEPS = 2, 12, 3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
NAMED_KEYS = ("admit_slot", "reset_slot", "merge_prefill")
LENS, GEN, LANES = (8, 13, 16, 21, 9), 5, 2


def _tol(kernel: str, dtype: str) -> tuple[float, float]:
    rtol, atol = jreg.get(kernel).tol(JDT[dtype])
    return 4 * rtol, 4 * atol


def _configs(dtype: str):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype)
    return jcfg, tcfg


def _np(x) -> np.ndarray:
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _frames(cfg, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.asarray(rng.normal(size=(n,) + cfg.frame_shape), np.float32)


def _bridge_array(x, dtype: str) -> torch.Tensor:
    """A float32 numpy array cast as the reference casts it, then bit for bit."""
    return tensor_from_numpy(np.asarray(jnp.asarray(x, JDT[dtype])), "cpu")


_RUNS: dict = {}


def _run(dtype: str) -> dict:
    """Encode, prefill and three decode steps through both stacks; memoized."""
    if dtype in _RUNS:
        return _RUNS[dtype]
    jcfg, tcfg = _configs(dtype)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = init_params(jcfg)
    tdisp = KernelDispatcher()
    tmodel = build_model(tcfg, tdisp, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    frames = _frames(jcfg, B, 1)
    jframes = jnp.asarray(frames, JDT[dtype])
    tframes = _bridge_array(frames, dtype)

    with jdsp.use_dispatcher(JDispatcher(jhal.TPU_V5E)):
        jenc = jax.jit(lambda p, f: jencdec.encode(jcfg, p, f, CPU_CTX))(
            jparams["encdec"], jframes)
    with dsp.use_dispatcher(KernelDispatcher()):
        tenc = encdec.encode(tcfg, tparams["encdec"], tframes)
    out = {"encode": (_np(jenc), caches_to_numpy(tenc))}

    jbatch = {"tokens": jnp.asarray(tokens), "frames": jframes}
    jcaches, jlg = jax.jit(jmodel.prefill)(jparams, jbatch)
    tcaches, tlg = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens),
                                            "frames": tframes})
    out["prefill"] = (np.asarray(jlg), tlg.numpy())
    out["prefill_caches"] = (JModel.named_leaves(jcaches),
                             leaves_with_path(caches_to_numpy(tcaches)))

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
def test_encoder_output_matches_reference(dtype):
    want, got = _run(dtype)["encode"]
    assert got.shape == want.shape == (B, 24, 64)
    np.testing.assert_allclose(got, want, *_tol("conv2d", dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_caches_match_reference(dtype):
    run = _run(dtype)
    want, got = run["prefill"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, *_tol("anemm", dtype))
    jleaves, tleaves = run["prefill_caches"]
    assert [p for p, _ in tleaves] == ["cross/k", "cross/v", "self/k", "self/pos", "self/v"]
    _assert_caches_match(jleaves, tleaves, _tol("anemm", dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_reference(dtype):
    run = _run(dtype)
    for i, (want, got) in enumerate(run["decode"]):
        np.testing.assert_allclose(got, want, *_tol("anemm", dtype), err_msg=f"step {i}")
    _assert_caches_match(*run["decode_caches"], _tol("anemm", dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_routes_cover_the_reference_kernels(dtype):
    run = _run(dtype)
    assert {k for k, _ in run["routes"]} == {k for k, _ in run["jroutes"]} == \
        {"anemm", "flash", "decode_attention", "conv2d"}
    assert {b for _, b in run["routes"]} == {"torch"}
    assert {b for _, b in run["jroutes"]} == {"pallas"}


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_matches_reference_tree(dtype):
    """The port's own init and caches: the reference's trees, shapes and dtypes."""
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


def test_full_config_matches_reference():
    jcfg, tcfg = jconfigs.get_config(ARCH), configs.get_config(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.frame_shape == (3000, 80) and tcfg.padded_vocab == 51968


def test_sinusoidal_positions_equal_reference():
    want = np.asarray(jlayers.sinusoidal_positions(1500, 768))
    got = layers.sinusoidal_positions(1500, 768)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lane_writes_of_the_cross_cache_match_reference():
    """Admission, reset and merge of `{"self", "cross"}` caches against the
    reference's on the same numpy trees: the cross K/V (named "k"/"v" but
    full `encoder_len`) is overwritten whole at admission and kept at a
    reset (masked by `pos`, as every time leaf); a leaf without a time axis
    ("state", as an SSM's) is zeroed at a reset, as the reference does."""
    from repro.launch.scheduler import _admit_into_slot_impl, _reset_slot_impl
    from repro_torch.bridge import caches_from_numpy
    from repro_torch.launch.scheduler import admit_into_slot, reset_slot

    _, tcfg = _configs("float32")
    model = build_model(tcfg, device="cpu")
    rng = np.random.default_rng(6)

    def draw(batch: int, time: int) -> dict:
        tree = caches_to_numpy(model.init_cache(batch, 20))
        tree["self"] = {k: v[:, :, :time] for k, v in tree["self"].items()}
        tree = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(a.dtype), tree)
        tree["self"]["state"] = rng.normal(size=(tcfg.n_layers, batch, 4)).astype(np.float32)
        return tree

    dec, pf, short = draw(3, 20), draw(1, 8), draw(3, 8)
    cases = {"admit": (_admit_into_slot_impl, admit_into_slot, pf, 1),
             "reset": (_reset_slot_impl, reset_slot, 2),
             "merge": (jmerge, merge_prefill_caches, short)}
    for name, (jfn, tfn, *args) in cases.items():
        want = jfn(jax.tree.map(jnp.asarray, dec),
                   *(jax.tree.map(jnp.asarray, a) if isinstance(a, dict) else a for a in args))
        got = tfn(caches_from_numpy(dec, "cpu"),
                  *(caches_from_numpy(a, "cpu") if isinstance(a, dict) else a for a in args))
        got = leaves_with_path(caches_to_numpy(got))
        assert [p for p, _ in got] == [p for p, _ in JModel.named_leaves(want)]
        for (path, g), (_, w) in zip(got, JModel.named_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name} {path}")


# ---------------------------------------------------------------------------
# The gelu repair and the plain gelu MLP
# ---------------------------------------------------------------------------


def test_gelu_is_the_tanh_form_of_jax():
    x = np.linspace(-6.0, 6.0, 200_001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = layers._ACTS["gelu"](torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-6


def _bridged_mlp(cfg_j, seed: int, bias: bool = False):
    p = jlayers.init_mlp(jax.random.PRNGKey(seed), cfg_j, cfg_j.d_model, cfg_j.d_ff,
                         jnp.float32)
    if bias:   # biases drawn away from their zero init so they count
        rng = np.random.default_rng(seed)
        p = {**p, "bi": jnp.asarray(rng.normal(size=p["bi"].shape), jnp.float32),
             "bo": jnp.asarray(rng.normal(size=p["bo"].shape), jnp.float32)}
    return p, {k: tensor_from_numpy(np.asarray(v), "cpu") for k, v in p.items()}


@pytest.mark.parametrize("arch,act", [("tinyllama-1.1b", "gelu"), (ARCH, "gelu_mlp")])
def test_apply_mlp_matches_reference_at_fp32(arch, act):
    """The GLU MLP with act="gelu" (tinyllama smoke) and whisper's plain
    gelu MLP with biases, on bridged weights, at rtol = atol = 1e-5."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), act=act)
    tcfg = dataclasses.replace(configs.get_smoke(arch), act=act)
    jp, tp = _bridged_mlp(jcfg, 3, bias=act == "gelu_mlp")
    assert ("bi" in tp) == (act == "gelu_mlp")
    x = np.random.default_rng(4).normal(size=(3, 7, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jlayers.apply_mlp(jcfg, jp, jnp.asarray(x)))
    with dsp.use_dispatcher(KernelDispatcher()):
        got = layers.apply_mlp(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Serving: greedy streams against the reference's schedules
# ---------------------------------------------------------------------------


def _kinds(keys) -> list[str]:
    first: dict[str, int] = {}
    return [k if k in NAMED_KEYS else f"prog{first.setdefault(k, len(first))}" for k in keys]


_SERVE: dict = {}


def _serve_both() -> dict:
    if _SERVE:
        return _SERVE
    jcfg = jconfigs.get_smoke(ARCH)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = init_params(jcfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, size=(L,)).astype(np.int32) for L in LENS]
    frames = list(_frames(jcfg, len(LENS), 2))
    max_len = max(LENS) + GEN
    tcfg = configs.get_smoke(ARCH)
    tmodel = build_model(tcfg, KernelDispatcher(), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for name, jcls, tcls, kw in (("continuous", JContinuous, ContinuousSchedule,
                                  {"n_slots": LANES}),
                                 ("sequential", JSequential, SequentialSchedule, {})):
        jcache, tcache = JCache(), ProgramCache()
        jsched = jcls(jmodel, jparams, jcfg, max_len=max_len, sampling="greedy", seed=0,
                      stream=JStream(jcache, target=jhal.TPU_V5E), **kw)
        jres = jsched.run([JRequest(i, p, GEN, frames=f)
                           for i, (p, f) in enumerate(zip(prompts, frames))])
        tsched = tcls(tmodel, tparams, tcfg, max_len=max_len, sampling="greedy",
                      stream=ExecutionStream(tcache, device="cpu"), **kw)
        tres = tsched.run([Request(i, p, GEN, frames=f)
                           for i, (p, f) in enumerate(zip(prompts, frames))])
        _SERVE[name] = dict(jres=jres, tres=tres, jsched=jsched, tsched=tsched,
                            jcache=jcache, tcache=tcache)
    _SERVE.update(tmodel=tmodel, tparams=tparams, tcfg=tcfg, prompts=prompts,
                  frames=frames, max_len=max_len)
    return _SERVE


@pytest.mark.parametrize("schedule", ["continuous", "sequential"])
def test_streams_token_exact_against_reference(schedule):
    run = _serve_both()[schedule]
    assert [r.rid for r in run["tres"]] == [r.rid for r in run["jres"]] == list(range(5))
    for j, t in zip(run["jres"], run["tres"]):
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=f"rid {j.rid}")
        assert (t.bucket, t.admitted_step, t.finished_step) == \
            (j.bucket, j.admitted_step, j.finished_step)


@pytest.mark.parametrize("schedule", ["continuous", "sequential"])
def test_dispatches_and_program_cache_match_reference(schedule):
    run = _serve_both()[schedule]
    jkeys = [r.key for r in run["jsched"].stream.records]
    tkeys = [r.key for r in run["tsched"].stream.records]
    assert _kinds(tkeys) == _kinds(jkeys)
    assert (run["tcache"].stats.misses, run["tcache"].stats.hits) == \
        (run["jcache"].stats.misses, run["jcache"].stats.hits)


def test_continuous_equals_sequential():
    run = _serve_both()
    for s, c in zip(run["sequential"]["tres"], run["continuous"]["tres"]):
        np.testing.assert_array_equal(s.tokens, c.tokens, err_msg=f"rid {s.rid}")


def test_encdec_refusals():
    """A prompt below the smallest bucket, missing frames, chunked prefill
    and the prefix cache (also under the spec schedule) are refused loudly;
    packed forms and the spec schedule serve (the tests below)."""
    run = _serve_both()
    model, params, cfg = run["tmodel"], run["tparams"], run["tcfg"]
    prompt, frames = run["prompts"][0], run["frames"][0]
    sched = ContinuousSchedule(model, params, cfg, n_slots=1, max_len=run["max_len"],
                               stream=ExecutionStream(device="cpu"))
    with pytest.raises(ValueError, match="bucket"):
        sched.run([Request(0, prompt[:4], 2, frames=frames)])
    with pytest.raises(ValueError, match="frames"):
        sched.run([Request(0, prompt, 2)])
    with pytest.raises(ValueError, match="chunked prefill cannot serve encdec"):
        ContinuousSchedule(model, params, cfg, n_slots=1, max_len=24, prefill_chunk=4)
    with pytest.raises(ValueError, match="prefix cache cannot serve encdec"):
        ContinuousSchedule(model, params, cfg, n_slots=1, max_len=24, prefix_cache=True)
    with pytest.raises(ValueError, match="prefix does not apply to the .spec. schedule"):
        serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--schedule", "spec",
                   "--prefix-cache", "--prompt-lens", "8", "--gen", "2"])


def test_cli_round_trip_on_cpu(capsys):
    """`--arch whisper-small --smoke --device cpu`: two rounds, the second
    compiles nothing; the CLI's tokens equal a continuous run on the same
    seeded weights, prompts and frames."""
    lens = "8,13,16,21"
    out = serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-lens", lens, "--gen", "4", "--requests", "2"])
    text = capsys.readouterr().out
    assert "continuous x greedy: 8 requests" in text
    assert {b for _, b in out["routes"]} == {"torch"}
    assert {k for k, _ in out["routes"]} == {"anemm", "flash", "decode_attention", "conv2d"}
    assert set(out["launches"].values()) == {0}
    assert out["cache_misses"] == 3 and out["cache_hits"] > 0   # buckets 8, 16 + decode

    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lens = [int(x) for x in lens.split(",")]
    prompts = [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in lens]
    frames = [np.asarray(rng.normal(size=cfg.frame_shape), np.float32) for _ in lens]
    sched = ContinuousSchedule(model, params, cfg, n_slots=2, max_len=max(lens) + 4,
                               stream=ExecutionStream(device="cpu"))
    res = sched.run([Request(i, p, 4, frames=f) for i, (p, f) in enumerate(zip(prompts, frames))])
    np.testing.assert_array_equal(out["tokens"], np.stack([r.tokens for r in res]))
    assert set(native.launch_counts().values()) == {0}
