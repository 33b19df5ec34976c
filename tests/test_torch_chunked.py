"""The port's chunked prefill and typed serve configuration, against the JAX
package on the CPU.

After every test of `tests/test_chunked_prefill.py` for the families the
port serves (dense; the others wait for their port): tinyllama smoke on the
reference's parameters bridged into the port, the reference's runs in JAX
(memoised for the module). A prompt admitted as chunk programs (decode-mode
forwards of C tokens into the lane's row of the staging cache, then one
lane write) gives exactly the unchunked streams, greedy and categorical,
under the continuous and slo schedules, and the reference's chunked
dispatches, chunk counts and ProgramCache counts; one chunk program serves
every prompt; the chunk spans tile [0, target) and each pays the measured
floor; decode dispatches run between chunks; chunked cold admissions fill
the prefix pool and later prompts hit it; `ServeConfig` refuses a section
on a schedule it does not apply to; the spec schedule and an
encoder-decoder refuse chunking. `prefill_chunk` itself is held against the
reference's model method. The reference's deprecated `make_scheduler` shim
is not ported.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import (ExecutionStream as JStream, KernelDispatcher as JDispatcher,
                                 ProgramCache as JCache)
from repro.launch.scheduler import (ChunkConfig as JChunk, PrefixConfig as JPrefix,
                                    Request as JRequest, ServeConfig as JServe,
                                    build_scheduler as jbuild_scheduler)
from repro.models.model import build_model as jbuild
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import AsyncExecutionStream, ExecutionStream, ProgramCache
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (ChunkConfig, PrefixConfig, Request, ServeConfig,
                                          SLOConfig, SpecConfig, build_scheduler)
from repro_torch.launch.speculative import SpeculativeSchedule
from repro_torch.models.model import build_model

ARCH = "tinyllama-1.1b"
V5E = jhal.TPU_V5E
# heterogeneous on purpose: below one chunk (reset admission), chunk-exact,
# ragged last chunk, and a multi-chunk prompt
CHUNK_LENS = [24, 6, 17, 16, 33]


def _requests(cls, vocab, lens, gen, seed=1):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, size=(L,)).astype(np.int32), gen)
            for i, L in enumerate(lens)]


_REF: dict = {}


def reference_model():
    if "model" not in _REF:
        jcfg = jconfigs.get_smoke(ARCH)
        jmodel = jbuild(jcfg, dispatcher=JDispatcher(V5E))
        _REF["model"] = (jcfg, jmodel, init_params(jcfg))
    return _REF["model"]


def reference(schedule, lens, gen, *, chunk=None, prefix=None, n_slots=3, rounds=1,
              sampling="greedy", seed=0) -> dict:
    """A reference run through its `ServeConfig` (memoised): the results of
    each round, the stats, the dispatch keys and the ProgramCache counts."""
    key = (schedule, tuple(lens), gen, chunk, tuple(sorted((prefix or {}).items())),
           n_slots, rounds, sampling, seed)
    if key not in _REF:
        jcfg, jmodel, jparams = reference_model()
        cache = JCache()
        config = JServe(schedule=schedule, max_len=max(lens) + gen, n_slots=n_slots,
                        sampling=sampling, seed=seed, stream=JStream(cache, target=V5E),
                        prefix=JPrefix(**prefix) if prefix else None,
                        chunk=JChunk(prefill_chunk=chunk) if chunk else None)
        sched = jbuild_scheduler(config, jmodel, jparams, jcfg)
        outs = [{r.rid: r for r in sched.run(_requests(JRequest, jcfg.vocab, lens, gen))}
                for _ in range(rounds)]
        _REF[key] = {"rounds": outs, "stats": sched.stats(len(lens)),
                     "keys": [r.key for r in sched.stream.records],
                     "cache": (cache.stats.hits, cache.stats.misses)}
    return _REF[key]


def port_params():
    if "port" not in _REF:
        _, _, jparams = reference_model()
        _REF["port"] = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         configs.get_smoke(ARCH), "cpu")
    return _REF["port"]


def port(schedule, lens, gen, *, chunk=None, prefix=None, n_slots=3, rounds=1,
         sampling="greedy", seed=0, slo=None, requests=None):
    """The port's run through its `ServeConfig`: (results of each round, or
    the one round's, and the schedule)."""
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu") if schedule == "slo" \
        else ExecutionStream(cache, device="cpu")
    config = ServeConfig(schedule=schedule, max_len=max(lens) + gen, n_slots=n_slots,
                         sampling=sampling, seed=seed, stream=stream, slo=slo,
                         prefix=PrefixConfig(**prefix) if prefix else None,
                         chunk=ChunkConfig(prefill_chunk=chunk) if chunk else None)
    sched = build_scheduler(config, model, port_params(), cfg)
    outs = [{r.rid: r for r in sched.run(requests or _requests(Request, cfg.vocab, lens, gen))}
            for _ in range(rounds)]
    if isinstance(stream, AsyncExecutionStream):
        stream.close()
    return (outs[0] if rounds == 1 else outs), sched


def same_tokens(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens, err_msg=f"rid {rid}")


NAMED_KEYS = ("admit_slot", "reset_slot", "merge_prefill", "prefix_admit", "pool_insert")


def _kinds(keys) -> list[str]:
    """Dispatch keys, program keys renamed by first appearance."""
    first: dict[str, int] = {}
    return [k if k in NAMED_KEYS else f"prog{first.setdefault(k, len(first))}" for k in keys]


# ---------------------------------------------------------------------------
# prefill_chunk against the reference's
# ---------------------------------------------------------------------------


def test_prefill_chunk_matches_reference():
    """Two chunks of 8 into a decode-shaped cache, from the reference's
    params: the logits of each chunk and the cache within 2e-3 of the
    reference's `prefill_chunk` (fp32), and the positions equal."""
    jcfg, jmodel, jparams = reference_model()
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    jc, tc = jmodel.init_cache(2, 24), model.init_cache(2, 24)
    for c0 in (0, 8):
        pos0 = np.full((2,), c0, np.int32)
        jc, jlg = jmodel.prefill_chunk(jparams, jc, jnp.asarray(tokens[:, c0:c0 + 8]),
                                       jnp.asarray(pos0))
        tc, tlg = model.prefill_chunk(port_params(), tc, torch.from_numpy(tokens[:, c0:c0 + 8]),
                                      torch.from_numpy(pos0))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=2e-3, atol=2e-3)
    for jl, tl in zip(jax.tree.leaves(jc), [c["sub0"][n] for c in tc for n in ("k", "pos", "v")]):
        if tl.dtype == torch.int32:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        else:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# Token-exact parity: chunked vs unchunked vs sequential
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_matches_unchunked_continuous(chunk):
    want = reference("sequential", CHUNK_LENS, 6)["rounds"][0]
    base, _ = port("continuous", CHUNK_LENS, 6)
    out, sched = port("continuous", CHUNK_LENS, 6, chunk=chunk)
    same_tokens(base, want)
    same_tokens(out, want)
    st = sched.stats(len(CHUNK_LENS))
    assert st["chunked_prefill"]["n_chunks"] > 0
    if chunk == 8:       # the reference's chunked run, dispatch for dispatch
        ref = reference("continuous", CHUNK_LENS, 6, chunk=8)
        same_tokens(out, ref["rounds"][0])
        assert st["chunked_prefill"] == ref["stats"]["chunked_prefill"]
        assert _kinds([r.key for r in sched.stream.records]) == _kinds(ref["keys"])
        assert (sched.cache.stats.hits, sched.cache.stats.misses) == ref["cache"]
        assert [out[r].admitted_step for r in out] == \
            [ref["rounds"][0][r].admitted_step for r in out]


def test_chunked_matches_sequential_under_slo():
    want = reference("sequential", CHUNK_LENS, 6)["rounds"][0]
    out, sched = port("slo", CHUNK_LENS, 6, chunk=8, slo=SLOConfig(slo_ms=1e6))
    same_tokens(out, want)
    assert sched.stats(len(CHUNK_LENS))["chunked_prefill"]["n_chunks"] > 0


def test_categorical_streams_schedule_invariant_chunked():
    """Categorical, seed 7: chunked and unchunked continuous and chunked slo
    streams equal the reference's unchunked continuous ones."""
    want = reference("continuous", [26, 9], 5, n_slots=2, sampling="categorical",
                     seed=7)["rounds"][0]
    for schedule, chunk in (("continuous", None), ("continuous", 8), ("slo", 8)):
        out, _ = port(schedule, [26, 9], 5, chunk=chunk, n_slots=2, sampling="categorical",
                      seed=7)
        same_tokens(out, want)


# ---------------------------------------------------------------------------
# Compile economics and floor accounting
# ---------------------------------------------------------------------------


def test_one_program_per_chunk_size():
    """Heterogeneous prompts run one chunk program and one decode program:
    the staging cache is decode-shaped for every prompt and lane."""
    _, sched = port("continuous", CHUNK_LENS, 4, chunk=8)
    assert len(sched._chunk_keys) == 1 and len(sched._chunk_memo) == 1
    _, base = port("continuous", CHUNK_LENS, 4)
    assert sched.cache.stats.misses <= base.cache.stats.misses


def test_chunk_spans_tile_the_prefix_and_pay_floors():
    _, sched = port("continuous", [33], 3, chunk=8)
    spans = sorted(r.span for r in sched.stream.records if r.span is not None)
    target = 8 * ((33 - 1) // 8)
    assert spans[0][0] == 0 and spans[-1][1] == target
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 == b0, "chunk spans must tile without gap or overlap"
    chunk_recs = [r for r in sched.stream.records if r.span is not None]
    assert len(chunk_recs) == len(spans) == target // 8
    assert all(r.key in sched._chunk_keys for r in chunk_recs)
    assert all(r.floor_s == sched.stream.floor_s > 0.0 for r in chunk_recs)


@pytest.mark.parametrize("schedule", ["continuous", "slo"])
def test_decode_windows_run_between_chunks(schedule):
    """A long prompt arriving while another lane decodes does not stall it:
    decode dispatches run between the chunk dispatches."""
    cfg = configs.get_smoke(ARCH)
    reqs = _requests(Request, cfg.vocab, [6, 64], 8)
    reqs[1] = Request(1, reqs[1].prompt, 8, arrival=2)
    out, sched = port(schedule, [6, 64], 8, chunk=8, n_slots=2, requests=reqs)
    recs = sched.stream.records
    chunks = [r.seq for r in recs if r.span is not None]
    decode_keys = sched._decode_keys if schedule == "slo" else \
        {k for _, k in sched._decode_memo.values()}
    decodes = [r.seq for r in recs if r.key in decode_keys]
    assert len(chunks) == 7
    assert [s for s in decodes if chunks[0] < s < chunks[-1]], \
        "no decode dispatch ran between the first and last chunk"
    unchunked, _ = port("continuous", [6, 64], 8, n_slots=2, requests=reqs)
    same_tokens(out, unchunked)


# ---------------------------------------------------------------------------
# Prefix-pool interop
# ---------------------------------------------------------------------------


def test_chunked_cold_insert_then_prefix_hits():
    """Chunked cold admissions insert whole blocks from the staging row;
    the chain anchors at the chunk boundary (24 = 6 blocks of 4), so later
    rounds admit from residency, token-exact, with the reference's counts."""
    prefix = dict(blocks=64, block_size=4)
    rounds, sched = port("continuous", [26, 26, 26], 4, chunk=8, n_slots=1, rounds=2,
                         prefix=prefix)
    base, _ = port("continuous", [26, 26, 26], 4, n_slots=1, rounds=2)
    for rnd, brnd in zip(rounds, base):
        same_tokens(rnd, brnd)
    assert sched.pool.stats["hits"] >= 3 and sched.pool.stats["misses"] >= 1
    ref = reference("continuous", [26, 26, 26], 4, chunk=8, n_slots=1, rounds=2,
                    prefix=prefix)
    for rnd, jrnd in zip(rounds, ref["rounds"]):
        same_tokens(rnd, jrnd)
    got = sched.stats(6)["prefix_cache"]
    assert {k: got[k] for k in ("hits", "misses", "hit_tokens")} == \
        {k: ref["stats"]["prefix_cache"][k] for k in ("hits", "misses", "hit_tokens")}
    assert _kinds([r.key for r in sched.stream.records]) == _kinds(ref["keys"])
    sched.pool.audit()


# ---------------------------------------------------------------------------
# ServeConfig: sections that do not apply; refusals
# ---------------------------------------------------------------------------


def test_serve_config_rejects_inapplicable_sections():
    with pytest.raises(ValueError, match="does not apply"):
        ServeConfig(schedule="sequential", max_len=16,
                    chunk=ChunkConfig(prefill_chunk=4)).validate()
    with pytest.raises(ValueError, match="does not apply"):
        ServeConfig(schedule="continuous", max_len=16, slo=SLOConfig(slo_ms=5.0)).validate()
    with pytest.raises(ValueError, match="does not apply"):
        ServeConfig(schedule="slo", max_len=16, spec=SpecConfig(draft_depth=2)).validate()
    with pytest.raises(ValueError, match="does not apply"):
        ServeConfig(schedule="spec", max_len=16, prefix=PrefixConfig()).validate()
    with pytest.raises(ValueError, match="block_size"):
        ServeConfig(schedule="continuous", max_len=16, chunk=ChunkConfig(prefill_chunk=6),
                    prefix=PrefixConfig(block_size=4)).validate()
    with pytest.raises(ValueError, match="schedule"):
        ServeConfig(schedule="beam", max_len=16).validate()
    with pytest.raises(ValueError, match="prefill_chunk"):
        ChunkConfig(prefill_chunk=0)
    with pytest.raises(ValueError, match="empty"):
        ChunkConfig()


def test_scheduler_kwargs_and_build():
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    config = ServeConfig(schedule="spec", max_len=32, n_slots=2, sampling="categorical",
                         seed=5, spec=SpecConfig(draft_depth=2, draft="self", max_in_flight=3))
    sched = build_scheduler(config, model, params, cfg)
    assert isinstance(sched, SpeculativeSchedule)
    assert (sched.draft_depth, sched.drafter.kind, sched.stream.max_in_flight) == (2, "self", 3)
    assert (sched.sampler.mode, sched.sampler.seed) == ("categorical", 5)
    sched.stream.close()
    seq = build_scheduler(ServeConfig(schedule="sequential", max_len=32, buckets=(4, 8)),
                          model, params, cfg)
    assert seq.buckets == (4, 8) and not hasattr(seq, "pool")


def test_chunking_rejected_where_it_cannot_apply():
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunk"):
        SpeculativeSchedule(model, params, cfg, n_slots=1, max_len=16, prefill_chunk=4)
    ecfg = configs.get_smoke("whisper-small")
    emodel = build_model(ecfg, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        build_scheduler(ServeConfig(schedule="continuous", max_len=16,
                                    chunk=ChunkConfig(prefill_chunk=4)),
                        emodel, emodel.init(torch.Generator().manual_seed(0)), ecfg)


def test_serve_cli_prefill_chunk(capsys):
    """`--prefill-chunk` end to end: the unchunked tokens, the chunk note in
    the report, two programs over both rounds; a section of another
    schedule refused."""
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-lens", "17,30",
            "--gen", "4", "--requests", "2"]
    base = serve.run(argv)
    for schedule in ("continuous", "slo"):
        out = serve.run(argv + ["--schedule", schedule, "--prefill-chunk", "8"])
        np.testing.assert_array_equal(out["tokens"], base["tokens"])
        cp = out["chunked_prefill"]
        assert cp == {"prefill_chunk": 8, "n_chunks": 2 * (2 + 3), "chunk_tokens": 2 * 40}
        assert out["cache_misses"] == 2          # one chunk and one decode program
    assert "chunked prefill C=8: 10 chunks / 80 prompt tokens" in capsys.readouterr().out
    with pytest.raises(ValueError, match="does not apply"):
        serve.run(argv + ["--schedule", "sequential", "--prefill-chunk", "8"])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_one_capture_per_chunk_width_on_the_card():
    """On the card the chunk program is one CUDA graph whichever lane is
    pending: captures = misses, no recapture, over prompts on every lane."""
    from repro_torch.kernels import native

    native.build()
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    config = ServeConfig(schedule="continuous", max_len=64, n_slots=3,
                         chunk=ChunkConfig(prefill_chunk=8))
    sched = build_scheduler(config, model, params, cfg)
    reqs = _requests(Request, cfg.vocab, [33, 20, 41, 17, 26], 4)
    for _ in range(2):
        sched.run([Request(r.rid, r.prompt, 4) for r in reqs])
    st = sched.cache.stats
    assert len(sched._chunk_keys) == 1
    assert (st.captures, st.recaptures) == (st.misses, 0)
