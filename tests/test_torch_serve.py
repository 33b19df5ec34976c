"""The port's serving path against the JAX package's, on the CPU.

tinyllama smoke (fp32), seed 0, prompt lengths 5, 8, 13, 16, 21 on 2 lanes,
6 tokens each: decode-only admission (5 < the smallest bucket), bucket-exact
prompts (8, 16), teacher-forced catch-up (13, 21) and lane reuse. The
reference's parameters are bridged into the port. The port's continuous
greedy streams must be token-exact against the JAX `ContinuousSchedule`,
with the same sequence of stream dispatches (program keys and the named lane
writes) and the same ProgramCache hits and misses.
"""

import _torch_threads  # noqa: F401

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import (ExecutionStream as JStream, KernelDispatcher as JDispatcher,
                                 ProgramCache as JCache)
from repro.launch.scheduler import ContinuousSchedule as JContinuous, Request as JRequest
from repro.models.model import build_model as jbuild
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher, ProgramCache
from repro_torch.kernels import native
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (ContinuousSchedule, Request, SequentialSchedule,
                                          bucket_for, default_buckets)
from repro_torch.models.model import build_model

ARCH = "tinyllama-1.1b"
LENS = (5, 8, 13, 16, 21)
GEN, LANES = 6, 2
NAMED_KEYS = ("admit_slot", "reset_slot", "merge_prefill")


def _prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in LENS]


def _kinds(keys) -> list[str]:
    """Record keys as kinds: the named lane writes as named, each program key
    as the order in which it first appeared ("prog0", "prog1", ...)."""
    first: dict[str, int] = {}
    out = []
    for k in keys:
        if k in NAMED_KEYS:
            out.append(k)
        else:
            out.append(f"prog{first.setdefault(k, len(first))}")
    return out


_RUN: dict = {}


def _reference_and_port() -> dict:
    if _RUN:
        return _RUN
    jcfg = jconfigs.get_smoke(ARCH)
    jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
    jparams = init_params(jcfg)
    prompts = _prompts(jcfg.vocab)
    max_len = max(LENS) + GEN
    jcache = JCache()
    jsched = JContinuous(jmodel, jparams, jcfg, n_slots=LANES, max_len=max_len,
                         sampling="greedy", seed=0,
                         stream=JStream(jcache, target=jhal.TPU_V5E))
    jres = jsched.run([JRequest(i, p, GEN) for i, p in enumerate(prompts)])

    tcfg = configs.get_smoke(ARCH)
    tmodel = build_model(tcfg, KernelDispatcher(), device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tcache = ProgramCache()
    tsched = ContinuousSchedule(tmodel, tparams, tcfg, n_slots=LANES, max_len=max_len,
                                sampling="greedy",
                                stream=ExecutionStream(tcache, device="cpu"))
    tres = tsched.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
    seq = SequentialSchedule(tmodel, tparams, tcfg, max_len=max_len,
                             stream=ExecutionStream(ProgramCache(), device="cpu"))
    sres = seq.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
    _RUN.update(jres=jres, jsched=jsched, jcache=jcache, tres=tres, tsched=tsched,
                tcache=tcache, sres=sres)
    return _RUN


def test_continuous_streams_token_exact_against_reference():
    run = _reference_and_port()
    assert [r.rid for r in run["tres"]] == [r.rid for r in run["jres"]] == list(range(5))
    for j, t in zip(run["jres"], run["tres"]):
        np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=f"rid {j.rid}")
        assert (t.bucket, t.admitted_step, t.finished_step) == \
            (j.bucket, j.admitted_step, j.finished_step)
    assert [r.bucket for r in run["tres"]] == [0, 8, 8, 16, 16]


def test_dispatch_records_and_program_cache_match_reference():
    run = _reference_and_port()
    jkeys = [r.key for r in run["jsched"].stream.records]
    tkeys = [r.key for r in run["tsched"].stream.records]
    assert _kinds(tkeys) == _kinds(jkeys)
    for name in NAMED_KEYS:
        assert tkeys.count(name) == jkeys.count(name)
    assert (run["tcache"].stats.misses, run["tcache"].stats.hits) == \
        (run["jcache"].stats.misses, run["jcache"].stats.hits)
    stats = run["tsched"].stats(len(LENS))
    assert stats["n_dispatches"] == len(jkeys)
    recs = run["tsched"].stream.records
    assert [r.seq for r in recs] == list(range(len(recs)))
    assert all(r.work_s >= 0 and r.floor_s > 0 for r in recs)


def test_sequential_equals_continuous():
    run = _reference_and_port()
    for s, t in zip(run["sres"], run["tres"]):
        np.testing.assert_array_equal(s.tokens, t.tokens, err_msg=f"rid {s.rid}")


def test_buckets():
    assert default_buckets(40) == (8, 16, 32)
    assert bucket_for(24, (8, 16, 32)) == 16
    assert bucket_for(5, (8, 16, 32)) == 0


def test_cli_round_trip_on_cpu(capsys):
    argv = ["--smoke", "--device", "cpu", "--batch", str(LANES),
            "--prompt-lens", ",".join(map(str, LENS)), "--gen", str(GEN),
            "--requests", "2"]
    out = serve.run(argv)
    text = capsys.readouterr().out
    assert "continuous x greedy: 10 requests" in text and "kernel launches" in text
    assert out["tokens"].shape == (len(LENS), GEN)
    assert {b for _, b in out["routes"]} == {"torch"}
    assert set(out["launches"].values()) == {0}
    # round 2 compiles nothing: 3 programs (2 prefill buckets + decode)
    assert out["cache_misses"] == 3 and out["cache_hits"] > 0

    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in LENS]
    sched = ContinuousSchedule(model, params, cfg, n_slots=LANES, max_len=max(LENS) + GEN,
                               stream=ExecutionStream(device="cpu"))
    res = sched.run([Request(len(LENS) + i, p, GEN) for i, p in enumerate(prompts)])
    np.testing.assert_array_equal(out["tokens"], np.stack([r.tokens for r in res]))


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default --device cuda is valid")
    with pytest.raises(SystemExit) as e:
        serve.run(["--smoke"])
    assert e.value.code not in (0, None)
    assert set(native.launch_counts().values()) == {0}
