"""whisper-small's packed weight forms and speculative decoding in the port,
against the JAX package's, on the CPU.

whisper-small smoke (2 encoder and 3 decoder layers, frames through the
conv stem), fp32, from the reference's own parameters bridged into the port
(a packed form: the reference's packed payload, bit for bit). Under
`int4_palette` and `sparse` the encoder's `attn`, the decoder's `self_attn`
and `cross_attn`, the `wi` / `wo` MLPs and the head pack (the conv stem
stays dense), and the port's continuous greedy streams are token-exact
against the reference's packed model under its continuous schedule. Under
`--schedule spec` (`self`, and `shrink`: one encoder layer and one decoder
layer of the target's widths, its own stem and encoder on the same frames),
the port's streams equal the reference's sequential streams, each window
makes one verify dispatch and, when it drafts, one draft dispatch. The
tests sit beside `test_torch_encdec.py` so that neither file outgrows a
minute. The reference model runs without a dispatcher of its own (its
plain jnp path; a packed weight still streams through its Pallas row, by
the reference's default dispatcher): the stem's conv in Pallas interpret
mode would double this file's time, and `test_torch_encdec.py` holds the
port against the dispatched reference. JAX runs are memoised.
"""

import _torch_threads  # noqa: F401

import functools

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import ExecutionStream as JStream, ProgramCache as JCache
from repro.launch.scheduler import (ContinuousSchedule as JContinuous, Request as JRequest,
                                    SequentialSchedule as JSequential)
from repro.models.model import build_model as jbuild
from _reference_params import packed_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream, KernelDispatcher,
                                       ProgramCache)
from repro_torch.launch import serve
from repro_torch.launch.scheduler import ContinuousSchedule, Request
from repro_torch.launch.speculative import SpeculativeSchedule, draft_of
from repro_torch.optim.compression import weight_form_census
from repro_torch.models.model import build_model

ARCH = "whisper-small"
LENS, GEN, LANES, DEPTH = (8, 13, 9), 4, 2, 3
FORMS = {"int4_palette": "palette", "sparse": "sparse"}


def _inputs(vocab: int, frame_shape) -> tuple[list, list]:
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in LENS]
    frames = [np.asarray(rng.normal(size=frame_shape), np.float32) for _ in LENS]
    return prompts, frames


@functools.lru_cache(maxsize=None)
def reference(form: str) -> tuple:
    """The reference's model and (packed) params, the port's bridged ones,
    and the reference's greedy streams: continuous for a packed form,
    sequential for the dense model."""
    jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    jmodel = jbuild(jcfg)
    jparams = packed_params(jcfg, form)
    prompts, frames = _inputs(jcfg.vocab, jcfg.frame_shape)
    stream = JStream(JCache(), target=jhal.TPU_V5E)
    kw = {"n_slots": LANES} if form != "fp16" else {}
    cls = JContinuous if form != "fp16" else JSequential
    sched = cls(jmodel, jparams, jcfg, max_len=max(LENS) + GEN, sampling="greedy", seed=0,
                stream=stream, **kw)
    res = sched.run([JRequest(i, p, GEN, frames=f)
                     for i, (p, f) in enumerate(zip(prompts, frames))])
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return tparams, {r.rid: r.tokens for r in res}


def _requests(cfg) -> list[Request]:
    prompts, frames = _inputs(cfg.vocab, cfg.frame_shape)
    return [Request(i, p, GEN, frames=f) for i, (p, f) in enumerate(zip(prompts, frames))]


@pytest.mark.parametrize("form", FORMS)
def test_packed_streams_token_exact_against_reference(form):
    tparams, want = reference(form)
    cfg = configs.get_smoke(ARCH)
    census = weight_form_census(tparams)
    assert sorted(census) == sorted(
        [f"encdec/enc/attn/{w}" for w in ("wk", "wo", "wq", "wv")]
        + [f"encdec/dec/{a}/{w}" for a in ("cross_attn", "self_attn")
           for w in ("wk", "wo", "wq", "wv")]
        + [f"encdec/{s}/mlp/{w}" for s in ("enc", "dec") for w in ("wi", "wo")]
        + ["embed/unembed"])
    assert set(census.values()) == {form}
    disp = KernelDispatcher()
    model = build_model(cfg, disp, device="cpu")
    sched = ContinuousSchedule(model, tparams, cfg, n_slots=LANES, max_len=max(LENS) + GEN,
                               sampling="greedy", stream=ExecutionStream(ProgramCache(),
                                                                         device="cpu"))
    got = {r.rid: r.tokens for r in sched.run(_requests(cfg))}
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"{form} rid {rid}")
    assert {k for k, _ in disp.census()} == {FORMS[form], "flash", "decode_attention",
                                             "conv2d"}


@pytest.mark.parametrize("draft", ["self", "shrink"])
def test_spec_streams_equal_the_sequential_reference(draft):
    tparams, want = reference("fp16")
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, KernelDispatcher(), device="cpu")
    cache = ProgramCache()
    sched = SpeculativeSchedule(model, tparams, cfg, n_slots=LANES, max_len=max(LENS) + GEN,
                                sampling="greedy",
                                stream=AsyncExecutionStream(cache, device="cpu"),
                                draft=draft, draft_depth=DEPTH)
    got = {r.rid: r.tokens for r in sched.run(_requests(cfg))}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"{draft} rid {rid}")
    st = sched.stats(len(LENS))
    assert st["verify_dispatches"] == sched.n_windows > 0
    assert st["draft_dispatches"] == sched.n_windows - sched.bonus_windows
    if draft == "self":
        assert st["accepted"] == st["proposed"] > 0
    else:
        dcfg = sched.drafter.cfg
        assert dcfg == draft_of(cfg) and (dcfg.n_layers, dcfg.n_encoder_layers) == (1, 1)
        assert set(sched.drafter.params["encdec"]) == set(tparams["encdec"])


def test_cli_serves_packed_and_spec_whisper(capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-lens", "8,13", "--gen", "3"]
    cont = serve.run(argv)
    spec = serve.run(argv + ["--schedule", "spec", "--draft", "shrink"])
    np.testing.assert_array_equal(spec["tokens"], cont["tokens"])
    assert {k for k, _ in spec["routes"]} == {"anemm", "flash", "decode_attention", "conv2d",
                                              "specdec"}
    packed = serve.run(argv + ["--weight-form", "sparse"])
    assert packed["weight_form_census"] == {"sparse": 17}
    assert "anemm" not in {k for k, _ in packed["routes"]}
