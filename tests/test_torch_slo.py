"""The port's SLO schedule (pipelined decode, sampling inside the decode
program, the cost-model admission gate) against the JAX package, on the CPU.

tinyllama smoke with the reference's parameters bridged into the port; the
reference's schedules run in JAX (memoised for the module). After the
reference's `test_slo_*` cases and its slo parametrisations
(`tests/test_serve_scheduler.py:117-140,143,290,423-505,655,721,787`):
greedy and categorical streams of the port's `slo` schedule token-exact
against the reference's sequential schedule and the port's continuous one,
with the reference SLO schedule's dispatches and ProgramCache counts;
mid-flight admission; a gate that defers but never starves; an open gate
that admits as the continuous schedule does; the prefix tier under slo;
whisper-small smoke under slo; the stream's record invariants; the CLI.
"""

import _torch_threads  # noqa: F401

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import (AsyncExecutionStream as JAsync, ExecutionStream as JStream,
                                 KernelDispatcher as JDispatcher, ProgramCache as JCache)
from repro.launch.scheduler import (Request as JRequest, SequentialSchedule as JSequential,
                                    SLOSchedule as JSLO)
from repro.models.model import build_model as jbuild
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import AsyncExecutionStream, ExecutionStream, ProgramCache
from repro_torch.launch import serve
from repro_torch.launch.scheduler import (ContinuousSchedule, PrefixConfig, Request,
                                          SequentialSchedule, ServeConfig, SLOConfig,
                                          SLOSchedule, build_scheduler)
from repro_torch.models.model import build_model

ARCH = "tinyllama-1.1b"
V5E = jhal.TPU_V5E
PARITY_LENS = [24, 6, 17, 16]
SAMPLINGS = ("greedy", "categorical")


def _requests(cls, vocab, lens, gen, arrivals=None, seed=1):
    rng = np.random.default_rng(seed)
    arrivals = arrivals or [0] * len(lens)
    return [cls(i, rng.integers(0, vocab, size=(L,)).astype(np.int32), gen, arrival=a)
            for i, (L, a) in enumerate(zip(lens, arrivals))]


# ---------------------------------------------------------------------------
# The reference's runs (memoised) and the port's, on the same weights
# ---------------------------------------------------------------------------

_REF: dict = {}


def reference_model():
    if "model" not in _REF:
        jcfg = jconfigs.get_smoke(ARCH)
        jmodel = jbuild(jcfg, dispatcher=JDispatcher(V5E))
        _REF["model"] = (jcfg, jmodel, init_params(jcfg))
    return _REF["model"]


def reference(schedule: str, lens, gen, *, n_slots=3, arrivals=None, sampling="greedy",
              **kw) -> dict:
    """The reference's `schedule` ("sequential" or "slo") run: {rid: result}
    and, for slo, its dispatch count and ProgramCache (hits, misses)."""
    key = (schedule, tuple(lens), gen, n_slots, tuple(arrivals or ()), sampling,
           tuple(sorted(kw.items())))
    if key not in _REF:
        jcfg, jmodel, jparams = reference_model()
        cache = JCache()
        if schedule == "sequential":
            sched = JSequential(jmodel, jparams, jcfg, max_len=max(lens) + gen,
                                sampling=sampling, seed=0, stream=JStream(cache, target=V5E))
        else:
            sched = JSLO(jmodel, jparams, jcfg, n_slots=n_slots, max_len=max(lens) + gen,
                         sampling=sampling, seed=0, stream=JAsync(cache, target=V5E), **kw)
        res = sched.run(_requests(JRequest, jcfg.vocab, lens, gen, arrivals))
        _REF[key] = {"results": {r.rid: r for r in res},
                     "n_dispatches": len(sched.stream.records),
                     "cache": (cache.stats.hits, cache.stats.misses),
                     "deferred": getattr(sched, "deferred_admissions", None)}
    return _REF[key]


def port_params():
    if "port" not in _REF:
        _, _, jparams = reference_model()
        cfg = configs.get_smoke(ARCH)
        _REF["port"] = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return _REF["port"]


def port(schedule: str, lens, gen, *, n_slots=3, arrivals=None, sampling="greedy",
         rounds=1, **kw):
    """The port's `schedule` on the reference's weights: ({rid: result} of
    each round, the schedule)."""
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu") if schedule == "slo" \
        else ExecutionStream(cache, device="cpu")
    if schedule == "sequential":
        sched = SequentialSchedule(model, port_params(), cfg, max_len=max(lens) + gen,
                                   sampling=sampling, stream=stream, **kw)
    else:
        cls = SLOSchedule if schedule == "slo" else ContinuousSchedule
        sched = cls(model, port_params(), cfg, n_slots=n_slots, max_len=max(lens) + gen,
                    sampling=sampling, stream=stream, **kw)
    outs = [{r.rid: r for r in sched.run(_requests(Request, cfg.vocab, lens, gen, arrivals))}
            for _ in range(rounds)]
    if isinstance(stream, AsyncExecutionStream):
        stream.close()
    return (outs[0] if rounds == 1 else outs), sched


def same_tokens(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens, err_msg=f"rid {rid}")


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_slo_streams_match_reference(sampling):
    """Greedy and categorical slo streams equal the reference's sequential
    ones and the port's continuous and sequential ones, with the buckets of
    the continuous run, and the reference slo run's dispatches and
    ProgramCache counts (one fused step program)."""
    want = reference("sequential", PARITY_LENS, 6, sampling=sampling)["results"]
    slo, sched = port("slo", PARITY_LENS, 6, sampling=sampling)
    cont, _ = port("continuous", PARITY_LENS, 6, sampling=sampling)
    seq, _ = port("sequential", PARITY_LENS, 6, sampling=sampling)
    same_tokens(slo, want)
    same_tokens(cont, want)
    same_tokens(seq, want)
    for rid in cont:
        assert slo[rid].bucket == cont[rid].bucket
    assert slo[1].bucket == 0 and slo[3].bucket == 16
    assert len(sched._decode_keys) == 1
    if sampling == "greedy":      # the schedule's dispatches do not depend on sampling
        ref = reference("slo", PARITY_LENS, 6)
        same_tokens(slo, ref["results"])
        assert [slo[r].admitted_step for r in slo] == \
            [ref["results"][r].admitted_step for r in slo]
        assert len(sched.stream.records) == ref["n_dispatches"]
        assert (sched.cache.stats.hits, sched.cache.stats.misses) == ref["cache"]


def test_slo_midflight_admission_parity():
    """A request arriving later joins a freed lane; windows stop at the
    arrival step (reference :456)."""
    lens, arrivals = [16, 12, 14], [0, 0, 2]
    want = reference("sequential", lens, 8, arrivals=arrivals)["results"]
    slo, _ = port("slo", lens, 8, n_slots=2, arrivals=arrivals)
    same_tokens(slo, want)
    assert slo[2].admitted_step > 0


def test_slo_gate_defers_but_never_starves():
    """An unreachable SLO sheds load: admissions beyond the first wait while
    the engine is busy (counted), yet every request is served with the
    sequential streams (reference :423)."""
    lens = [12, 10, 9]
    want = reference("sequential", lens, 4)["results"]
    slo, sched = port("slo", lens, 4, slo_ms=1e-4)
    same_tokens(slo, want)
    assert sched.deferred_admissions > 0
    assert min(slo[1].admitted_step, slo[2].admitted_step) > slo[0].admitted_step


def test_slo_gate_open_matches_continuous_admissions():
    """A generous SLO admits exactly like the continuous schedule
    (reference :442)."""
    lens = [12, 10, 9]
    slo, sched = port("slo", lens, 4, slo_ms=1e6)
    cont, _ = port("continuous", lens, 4)
    assert sched.deferred_admissions == 0
    for rid in cont:
        assert slo[rid].admitted_step == cont[rid].admitted_step
        np.testing.assert_array_equal(slo[rid].tokens, cont[rid].tokens)
    same_tokens(slo, reference("sequential", lens, 4)["results"])
    assert sched.predicted_token_latency_s() > 0.0


def test_slo_prefix_tier():
    """The prefix pool under slo (reference :655): the cold round and the
    warm (prefix-hit) round both equal the sequential streams, the warm
    round hit, every page table was released, the pool audits clean."""
    (cold, warm), sched = port("slo", PARITY_LENS, 6, rounds=2, prefix_cache=True,
                               prefix_blocks=64, prefix_block_size=8)
    want = reference("sequential", PARITY_LENS, 6)["results"]
    same_tokens(cold, want)
    same_tokens(warm, want)
    assert sched.pool.stats["hits"] > 0 and sched.pool.stats["hit_tokens"] > 0
    for rid in cold:
        assert warm[rid].bucket == cold[rid].bucket
    assert sched.pool.owners() == set()
    sched.pool.audit()


def test_slo_whisper_smoke_greedy():
    """whisper-small smoke under slo, greedy (reference :143): the port's
    sequential and continuous streams on the same frames (held against the
    reference's in `test_torch_encdec.py`), the continuous admissions."""
    cfg = configs.get_smoke("whisper-small")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    lens = [16, 9, 12]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in lens]
    frames = [np.asarray(rng.normal(size=cfg.frame_shape), np.float32) for _ in lens]
    outs = {}
    for name, cls in (("slo", SLOSchedule), ("continuous", ContinuousSchedule),
                      ("sequential", SequentialSchedule)):
        kw = {} if name == "sequential" else {"n_slots": 2}
        sched = cls(model, params, cfg, max_len=24, **kw,
                    stream=(AsyncExecutionStream if name == "slo" else ExecutionStream)(
                        device="cpu"))
        outs[name] = {r.rid: r for r in sched.run(
            [Request(i, prompts[i], 4, frames=frames[i]) for i in range(3)])}
    same_tokens(outs["slo"], outs["sequential"])
    same_tokens(outs["continuous"], outs["sequential"])
    assert [outs["slo"][r].admitted_step for r in range(3)] == \
        [outs["continuous"][r].admitted_step for r in range(3)]
    with pytest.raises(ValueError, match="bucket"):
        SLOSchedule(model, params, cfg, n_slots=1, max_len=24).run(
            [Request(0, prompts[0][:4], 2, frames=frames[0])])


# ---------------------------------------------------------------------------
# The stream, the refusals, the CLI
# ---------------------------------------------------------------------------


def test_slo_stream_invariants():
    """Records in submission order, the measured floor on every one, the
    in-flight depth inside the window, the lane count as the decode batch,
    each step's record under the fused program's key (reference :290)."""
    _, sched = port("slo", [16, 9], 4, n_slots=2)
    recs = sched.stream.records
    seqs = [r.seq for r in recs]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    for r in recs:
        assert r.floor_s == sched.stream.floor_s and r.work_s >= 0.0
        assert r.complete_ts >= r.submit_ts > 0.0
        assert 0 <= r.inflight_depth < sched.stream.max_in_flight
    assert max(r.batch for r in recs) == 2
    steps = [r for r in recs if r.key in sched._decode_keys]
    assert steps and all(r.span is None for r in recs)
    st = sched.stats(2)
    assert st["max_in_flight"] == sched.stream.max_in_flight
    assert st["deferred_admissions"] == 0 and 0.0 <= st["mean_inflight_depth"]


def test_slo_refusals_and_config():
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="AsyncExecutionStream"):
        SLOSchedule(model, params, cfg, n_slots=1, max_len=16,
                    stream=ExecutionStream(device="cpu"))
    own = SLOSchedule(model, params, cfg, n_slots=1, max_len=16, max_in_flight=3)
    assert isinstance(own.stream, AsyncExecutionStream) and own.stream.max_in_flight == 3
    own.stream.close()
    sched = build_scheduler(ServeConfig(schedule="slo", max_len=16, n_slots=2,
                                        slo=SLOConfig(slo_ms=5.0, max_in_flight=4),
                                        prefix=PrefixConfig(block_size=4)),
                            model, params, cfg)
    assert isinstance(sched, SLOSchedule) and sched.slo_s == 5e-3
    assert sched.stream.max_in_flight == 4 and sched.pool.block_size == 4
    sched.stream.close()


def test_serve_cli_slo_schedule(capsys):
    """`--schedule slo` end to end (reference :787): the continuous CLI
    run's tokens, a warm second round, the SLO notes in the report; an
    unreachable `--slo-ms` defers admissions and keeps the tokens."""
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4",
            "--requests", "2"]
    out = serve.run(argv + ["--schedule", "slo"])
    cont = serve.run(argv + ["--schedule", "continuous"])
    np.testing.assert_array_equal(out["tokens"], cont["tokens"])
    assert out["cache_hits"] > 0
    assert out["deferred_admissions"] == 0 and out["max_in_flight"] == 8
    tight = serve.run(argv + ["--schedule", "slo", "--slo-ms", "1e-4"])
    assert tight["deferred_admissions"] > 0
    np.testing.assert_array_equal(tight["tokens"], cont["tokens"])
    text = capsys.readouterr().out
    assert "slo x greedy" in text and "deferred admissions, pred p99 token" in text
    cat = serve.run(argv + ["--schedule", "slo", "--sampling", "categorical"])
    cat_cont = serve.run(argv + ["--schedule", "continuous", "--sampling", "categorical"])
    np.testing.assert_array_equal(cat["tokens"], cat_cont["tokens"])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_slo_on_the_card_equals_continuous(sampling):
    """On the card (smoke model, its own weights): the slo streams, whose
    draws run inside the step's CUDA graph, equal the continuous schedule's,
    whose draws run eagerly on the same device; captures = misses, no
    recapture, over two rounds."""
    from repro_torch.kernels import native

    native.build()
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    outs = {}
    for schedule in ("continuous", "slo"):
        sched = build_scheduler(ServeConfig(schedule=schedule, max_len=40, n_slots=3,
                                            sampling=sampling, seed=3), model, params, cfg)
        for _ in range(2):
            res = sched.run(_requests(Request, cfg.vocab, PARITY_LENS, 6))
        outs[schedule] = {r.rid: r for r in res}
        st = sched.cache.stats
        assert (st.captures, st.recaptures) == (st.misses, 0)
        if schedule == "slo":
            sched.stream.close()
    same_tokens(outs["slo"], outs["continuous"])
