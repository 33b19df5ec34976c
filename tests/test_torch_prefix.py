"""Prefix-cached serving in the port against the JAX package's, on the CPU.

tinyllama smoke (fp32), the reference's parity harness
(`tests/test_serve_scheduler.py:607`): prompts 24, 6, 17, 16 on 3 lanes, 6
tokens each, a pool of 64 blocks of 8 tokens, two identical rounds (the
first all cold, the second admitted from resident blocks), with the dense
weights and with int4-palette weights (the reference's payload, bridged).
The reference's parameters are bridged into the port. Per round the port's
greedy streams must equal the reference's and the port's sequential run;
the pool's stats (hits, misses, hit tokens, inserted blocks, evictions,
copy-on-write copies, free blocks), the sequence of stream dispatches
(program keys and the named lane and pool writes) and the ProgramCache
counts must equal the reference's; no page table is held at the end and
`audit()` holds.

Behaviour (after `tests/test_serve_scheduler.py:670-740`): requests that
share a system prompt hit within one round and save whole dispatches; the
speculative schedule and an encoder-decoder refuse the pool, the sequential
schedule drops its knobs; the CLI round trip; and a pool small enough to
evict, with one eviction cost function handed to both sides (the H100's and
the modelled TPU's re-prefill costs can tie differently, so the injected
function is the fair comparison).
"""

import warnings

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
from repro.optim.compression import compress_model_params as jcompress
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream,
                                       KernelDispatcher, ProgramCache)
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (ContinuousSchedule, Request, SequentialSchedule)
from repro_torch.launch.speculative import SpeculativeSchedule
from repro_torch.models.model import build_model

ARCH = "tinyllama-1.1b"
LENS = (24, 6, 17, 16)
GEN, LANES, ROUNDS = 6, 3, 2
NAMED = ("admit_slot", "reset_slot", "merge_prefill", "prefix_admit", "pool_insert")
STATS = ("hits", "misses", "hit_tokens", "inserted_blocks", "evictions", "cow_copies",
         "free_blocks")

_MEMO: dict = {}


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _kinds(keys) -> list[str]:
    """Record keys as kinds: the named writes as named, each program key as
    the order in which it first appeared."""
    first: dict[str, int] = {}
    return [k if k in NAMED else f"prog{first.setdefault(k, len(first))}" for k in keys]


def _models(form: str):
    """(reference model, its params, port model, bridged params)."""
    def make():
        jcfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
        jmodel = jbuild(jcfg, dispatcher=JDispatcher(jhal.TPU_V5E))
        jparams = _memo("jparams", lambda: jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
        if form != "fp16":
            jparams = jcompress(jparams, form)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        return jmodel, jparams, build_model(tcfg, KernelDispatcher(), device="cpu"), tparams
    return _memo(("models", form), make)


def _prompts(lens=LENS, seed=1) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=(n,)).astype(np.int32) for n in lens]


def _reference(form: str, prompts, rounds=ROUNDS, n_slots=LANES, evict_cost_fn=None, **kw):
    jmodel, jparams, _, _ = _models(form)
    cfg = jconfigs.get_smoke(ARCH)
    cache = JCache()
    sched = JContinuous(jmodel, jparams, cfg, n_slots=n_slots,
                        max_len=max(p.size for p in prompts) + GEN, sampling="greedy",
                        seed=0, stream=JStream(cache, target=jhal.TPU_V5E), **kw)
    if evict_cost_fn is not None:
        sched.pool.evict_cost_fn = evict_cost_fn
    outs = [sched.run([JRequest(i, p, GEN) for i, p in enumerate(prompts)])
            for _ in range(rounds)]
    return outs, sched, cache


def _port(form: str, prompts, rounds=ROUNDS, n_slots=LANES, evict_cost_fn=None, **kw):
    _, _, tmodel, tparams = _models(form)
    cfg = configs.get_smoke(ARCH)
    cache = ProgramCache()
    sched = ContinuousSchedule(tmodel, tparams, cfg, n_slots=n_slots,
                               max_len=max(p.size for p in prompts) + GEN,
                               stream=ExecutionStream(cache, device="cpu"), **kw)
    if evict_cost_fn is not None:
        sched.pool.evict_cost_fn = evict_cost_fn
    outs = [sched.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
            for _ in range(rounds)]
    return outs, sched, cache


def _parity_run(form: str) -> dict:
    def make():
        prompts = _prompts()
        pool_kw = dict(prefix_cache=True, prefix_blocks=64, prefix_block_size=8)
        jouts, jsched, jcache = _reference(form, prompts, **pool_kw)
        touts, tsched, tcache = _port(form, prompts, **pool_kw)
        _, _, tmodel, tparams = _models(form)
        seq = SequentialSchedule(tmodel, tparams, configs.get_smoke(ARCH),
                                 max_len=max(LENS) + GEN,
                                 stream=ExecutionStream(ProgramCache(), device="cpu"))
        sres = seq.run([Request(i, p, GEN) for i, p in enumerate(prompts)])
        return dict(jouts=jouts, jsched=jsched, jcache=jcache, touts=touts, tsched=tsched,
                    tcache=tcache, sres=sres)
    return _memo(("parity", form), make)


@pytest.mark.parametrize("form", ["fp16", "int4_palette"])
def test_prefix_streams_equal_reference_and_sequential(form):
    run = _parity_run(form)
    for r, (jres, tres) in enumerate(zip(run["jouts"], run["touts"])):
        for j, t, s in zip(jres, tres, run["sres"]):
            np.testing.assert_array_equal(t.tokens, j.tokens,
                                          err_msg=f"{form} round {r} rid {j.rid}")
            np.testing.assert_array_equal(t.tokens, s.tokens,
                                          err_msg=f"{form} round {r} rid {j.rid}")
            assert (t.bucket, t.admitted_step, t.finished_step) == \
                (j.bucket, j.admitted_step, j.finished_step)
    # round 2 really admitted from resident blocks
    assert run["tsched"].pool.stats["hits"] > 0 and run["tsched"].pool.stats["hit_tokens"] > 0


@pytest.mark.parametrize("form", ["fp16", "int4_palette"])
def test_prefix_stats_dispatches_and_programs_equal_reference(form):
    run = _parity_run(form)
    tstats = run["tsched"].stats(len(LENS) * ROUNDS)["prefix_cache"]
    jstats = run["jsched"].stats(len(LENS) * ROUNDS)["prefix_cache"]
    assert {k: tstats[k] for k in STATS} == {k: jstats[k] for k in STATS}
    tkeys = [r.key for r in run["tsched"].stream.records]
    jkeys = [r.key for r in run["jsched"].stream.records]
    assert _kinds(tkeys) == _kinds(jkeys)
    assert {k: tkeys.count(k) for k in NAMED} == {k: jkeys.count(k) for k in NAMED}
    assert tkeys.count("prefix_admit") == tstats["hits"] > 0
    assert (run["tcache"].stats.misses, run["tcache"].stats.hits) == \
        (run["jcache"].stats.misses, run["jcache"].stats.hits)
    pool = run["tsched"].pool
    assert pool.owners() == set()
    pool.audit()
    assert pool.resident() == run["jsched"].pool.resident()


def test_prefix_shares_within_one_round():
    """Requests with one common system prompt hit the pool inside a single
    round, with the reference's counts, and save whole dispatches against
    the pool-less run."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 512, size=(16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, size=(3 + i,)).astype(np.int32)])
               for i in range(4)]
    base, bsched, _ = _port("fp16", prompts, rounds=1, n_slots=2)
    pooled, psched, _ = _port("fp16", prompts, rounds=1, n_slots=2, prefix_cache=True,
                              prefix_block_size=8)
    jpooled, jsched, _ = _reference("fp16", prompts, rounds=1, n_slots=2, prefix_cache=True,
                                    prefix_block_size=8)
    for b, p, j in zip(base[0], pooled[0], jpooled[0]):
        np.testing.assert_array_equal(b.tokens, p.tokens)
        np.testing.assert_array_equal(p.tokens, j.tokens)
    assert (psched.pool.stats["hits"], psched.pool.stats["misses"]) == (3, 1)
    assert psched.pool.stats == jsched.pool.stats
    assert len(psched.stream.records) < len(bsched.stream.records)
    assert [r.key for r in psched.stream.records if r.key in NAMED] == \
        [r.key for r in jsched.stream.records if r.key in NAMED]


def test_prefix_eviction_with_one_cost_function():
    """A pool of 5 blocks under eviction pressure (a shared 16-token system
    prompt between prompts of 33, 24 and 17 tokens), the same cost function
    injected on both sides: the same evictions, stats, streams and
    dispatches."""
    def cost(n_tokens: int) -> float:
        return 1e-5 + 1e-7 * n_tokens
    rng = np.random.default_rng(9)
    system = rng.integers(0, 512, size=(16,)).astype(np.int32)
    prompts = []
    for shared, n in ((True, 3), (False, 33), (True, 6), (False, 24), (True, 9), (False, 17)):
        tail = rng.integers(0, 512, size=(n,)).astype(np.int32)
        prompts.append(np.concatenate([system, tail]) if shared else tail)
    pool_kw = dict(prefix_cache=True, prefix_blocks=5, prefix_block_size=8,
                   evict_cost_fn=cost)
    jouts, jsched, _ = _reference("fp16", prompts, **pool_kw)
    touts, tsched, _ = _port("fp16", prompts, **pool_kw)
    for jres, tres in zip(jouts, touts):
        for j, t in zip(jres, tres):
            np.testing.assert_array_equal(t.tokens, j.tokens, err_msg=f"rid {j.rid}")
    assert tsched.pool.stats == jsched.pool.stats
    assert tsched.pool.stats["evictions"] > 0 and tsched.pool.stats["hits"] > 0
    assert _kinds([r.key for r in tsched.stream.records]) == \
        _kinds([r.key for r in jsched.stream.records])
    assert tsched.pool.resident() == jsched.pool.resident()
    tsched.pool.audit()


def test_prefix_refusals():
    cfg = configs.get_smoke(ARCH)
    _, _, model, params = _models("fp16")
    # speculative: the pool pages the target's cache only — loud
    with pytest.raises(ValueError, match="prefix"):
        SpeculativeSchedule(model, params, cfg, n_slots=1, max_len=16,
                            stream=AsyncExecutionStream(device="cpu"), prefix_cache=True)
    # sequential drops the knobs (no slot admission to route through)
    with pytest.warns(UserWarning, match="prefix"):
        seq = SequentialSchedule(model, params, cfg, max_len=16,
                                 stream=ExecutionStream(device="cpu"), prefix_cache=True,
                                 prefix_blocks=8)
    assert not hasattr(seq, "pool")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SequentialSchedule(model, params, cfg, max_len=16,
                           stream=ExecutionStream(device="cpu"), prefix_cache=False)
    # encdec: the cross-attention cache depends on per-request frames
    ecfg = configs.get_smoke("whisper-small")
    emodel = build_model(ecfg, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        ContinuousSchedule(emodel, None, ecfg, n_slots=1, max_len=16,
                           stream=ExecutionStream(device="cpu"), prefix_cache=True)


def test_prefix_cli_round_trip(capsys):
    """`--prefix-cache` end to end: the same tokens with the pool on and off,
    the pool's stats in the result and the report, round 2 from resident
    blocks; spec refuses, sequential drops the knobs."""
    # 17 = 2 whole blocks of matchable prefix (the match limit is L-1)
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "17", "--gen", "4",
            "--requests", "2"]
    off = serve.run(argv)
    on = serve.run(argv + ["--prefix-cache"])
    text = capsys.readouterr().out
    np.testing.assert_array_equal(on["tokens"], off["tokens"])
    for a, b in zip(on["round_tokens"], off["round_tokens"]):
        np.testing.assert_array_equal(a, b)
    assert "prefix_cache" not in off
    pc = on["prefix_cache"]
    assert (pc["hits"], pc["misses"], pc["hit_tokens"]) == (2, 2, 32)
    assert pc["free_blocks"] == 64 - pc["inserted_blocks"]
    assert "prefix cache: 2 hits / 2 misses, 32 prefill tokens skipped" in text
    # a miss adds pool_insert, a hit replaces prefill + admit_slot
    assert on["n_dispatches"] == off["n_dispatches"] + pc["misses"] - pc["hits"]
    assert {b for _, b in on["routes"]} == {"torch"}
    with pytest.raises(ValueError, match="prefix"):
        serve.run(argv + ["--schedule", "spec", "--prefix-cache"])
    with pytest.warns(UserWarning, match="prefix"):
        seq = serve.run(argv + ["--schedule", "sequential", "--prefix-cache"])
    assert "prefix_cache" not in seq
    np.testing.assert_array_equal(seq["tokens"], off["tokens"])
    with pytest.raises(ValueError, match="encdec"):
        serve.run(["--arch", "whisper-small", "--smoke", "--device", "cpu", "--batch", "1",
                   "--prompt-len", "8", "--gen", "2", "--prefix-cache"])


def test_serve_prompt_rounds():
    """`run(prompts=...)` serves the given rounds: two rounds sharing a
    system prompt hit within and across them, and give the tokens a
    scheduler run of the same requests gives."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, 512, size=(16,)).astype(np.int32)
    rounds = [[np.concatenate([system, rng.integers(0, 512, size=(n,)).astype(np.int32)])
               for n in (1, 5, 9)] for _ in range(2)]
    argv = ["--smoke", "--device", "cpu", "--batch", "3", "--gen", "3", "--prefix-cache"]
    out = serve.run(argv, prompts=rounds)
    assert len(out["round_tokens"]) == 2 and out["tokens"].shape == (3, 3)
    assert out["prefix_cache"]["misses"] == 1 and out["prefix_cache"]["hits"] == 5
    assert [r.rid for r in out["results"]] == [3, 4, 5]
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    sched = ContinuousSchedule(model, params, cfg, n_slots=3, max_len=25 + 3,
                               stream=ExecutionStream(device="cpu"))
    for r, prompts in enumerate(rounds):
        res = sched.run([Request(r * 3 + i, p, 3) for i, p in enumerate(prompts)])
        np.testing.assert_array_equal(out["round_tokens"][r], np.stack([x.tokens for x in res]))
    with pytest.raises(ValueError, match="rounds"):
        serve.run(argv, prompts=[rounds[0], rounds[1][:2]])
