"""The port's speculative decoding (chain windows) and async stream, on the CPU.

Streams against the JAX package: tinyllama smoke (fp32, fp16 weight form),
prompt lengths 24, 6, 17, 16 on 3 lanes, 6 tokens each, draft depth 3 — the
reference's `_check_parity` setting (`tests/test_serve_scheduler.py:101`).
The reference's parameters are bridged into the port, and so are its shrink
drafter's. The port's greedy `spec` streams, with the self drafter and with
the shrink drafter, must be token-exact against the reference
`SequentialSchedule`, and the port's schedule must make the reference
`SpeculativeSchedule`'s windows, proposals, acceptances, draft / verify
records and ProgramCache hits and misses.

The reference's own speculative cases follow, on the port alone (accept-all
bounds, an adversarial drafter, the depth clamp, mid-flight admission, two
floors per window, the shrink rule, bad setups, the CLI), and the
`AsyncExecutionStream` contract (after `tests/test_serve_scheduler.py:317-420`),
none of it timing-dependent. Tree windows: `test_torch_spec_tree.py`.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import (AsyncExecutionStream as JAsync, ExecutionStream as JStream,
                                 KernelDispatcher as JDispatcher, ProgramCache as JCache)
from repro.launch.scheduler import Request as JRequest, SequentialSchedule as JSequential
from repro.launch.speculative import SpeculativeSchedule as JSpec
from repro.models.model import build_model as jbuild
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream, KernelDispatcher,
                                       ProgramCache)
from repro_torch.kernels import native
from repro_torch.launch import serve
from repro_torch.launch.scheduler import Request, SequentialSchedule
from repro_torch.launch.speculative import (Drafter, SpeculativeSchedule, _positional_leaves,
                                            draft_of)
from repro_torch.models.model import build_model

ARCH = "tinyllama-1.1b"
PARITY_LENS = (24, 6, 17, 16)
GEN, LANES, DEPTH = 6, 3, 3
V5E = jhal.TPU_V5E


def _prompts(vocab: int, lens) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in lens]


# ---------------------------------------------------------------------------
# The reference's runs, bridged (memoised: the JAX runs take seconds each)
# ---------------------------------------------------------------------------

_REF: dict = {}


def reference_model():
    if "model" not in _REF:
        jcfg = jconfigs.get_smoke(ARCH)
        jmodel = jbuild(jcfg, dispatcher=JDispatcher(V5E))
        _REF["model"] = (jcfg, jmodel, jmodel.init(jax.random.PRNGKey(0)))
    return _REF["model"]


def reference_spec(draft: str, branches: int) -> dict:
    """The reference SpeculativeSchedule on the parity setting, with its
    counts and its drafter's params as numpy."""
    key = ("spec", draft, branches)
    if key not in _REF:
        jcfg, jmodel, jparams = reference_model()
        cache = JCache()
        sched = JSpec(jmodel, jparams, jcfg, n_slots=LANES, max_len=max(PARITY_LENS) + GEN,
                      sampling="greedy", seed=0, stream=JAsync(cache, target=V5E),
                      draft=draft, draft_depth=DEPTH, draft_branches=branches)
        res = sched.run([JRequest(i, p, GEN)
                         for i, p in enumerate(_prompts(jcfg.vocab, PARITY_LENS))])
        st = sched.stats(len(PARITY_LENS))
        _REF[key] = {
            "tokens": {r.rid: r.tokens for r in res},
            "counts": spec_counts(st, cache),
            "drafter_params": jax.tree.map(np.asarray, sched.drafter.params),
        }
    return _REF[key]


def reference_sequential() -> dict:
    if "seq" not in _REF:
        jcfg, jmodel, jparams = reference_model()
        sched = JSequential(jmodel, jparams, jcfg, max_len=max(PARITY_LENS) + GEN,
                            sampling="greedy", seed=0, stream=JStream(JCache(), target=V5E))
        res = sched.run([JRequest(i, p, GEN)
                         for i, p in enumerate(_prompts(jcfg.vocab, PARITY_LENS))])
        _REF["seq"] = {r.rid: r.tokens for r in res}
    return _REF["seq"]


def spec_counts(stats: dict, cache) -> dict:
    keys = ("n_windows", "proposed", "accepted", "draft_dispatches", "verify_dispatches",
            "n_dispatches", "emitted_tokens")
    return {**{k: stats[k] for k in keys},
            "cache": (cache.stats.hits, cache.stats.misses)}


def port_params():
    if "port" not in _REF:
        _, _, jparams = reference_model()
        cfg = configs.get_smoke(ARCH)
        _REF["port"] = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return _REF["port"]


def port_spec(draft: str, branches: int):
    """The port's SpeculativeSchedule on the parity setting, its shrink
    drafter on the reference drafter's params. Returns (tokens, counts,
    schedule)."""
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, KernelDispatcher(), device="cpu")   # a fresh route census
    params = port_params()
    drafter = None
    if draft == "shrink":
        dparams = params_from_numpy(reference_spec(draft, branches)["drafter_params"],
                                    draft_of(cfg), "cpu")
        drafter = Drafter.shrink(cfg, dispatcher=model.dispatcher, device="cpu",
                                 params=dparams)
    cache = ProgramCache()
    sched = SpeculativeSchedule(model, params, cfg, n_slots=LANES,
                                max_len=max(PARITY_LENS) + GEN,
                                stream=AsyncExecutionStream(cache, device="cpu"),
                                draft=draft, drafter=drafter, draft_depth=DEPTH,
                                draft_branches=branches)
    res = sched.run([Request(i, p, GEN)
                     for i, p in enumerate(_prompts(cfg.vocab, PARITY_LENS))])
    return {r.rid: r.tokens for r in res}, spec_counts(sched.stats(len(PARITY_LENS)), cache), \
        sched


def check_against_reference(draft: str, branches: int):
    tokens, counts, sched = port_spec(draft, branches)
    ref = reference_spec(draft, branches)
    for rid, want in ref["tokens"].items():
        np.testing.assert_array_equal(tokens[rid], want, err_msg=f"rid {rid}")
    assert counts == ref["counts"]
    assert sched.window_kinds["chain"] + sched.window_kinds["tree"] == sched.n_windows
    assert counts["draft_dispatches"] == sched.n_windows - sched.bonus_windows
    return tokens, sched


@pytest.mark.parametrize("draft", ["self", "shrink"])
def test_spec_chain_matches_reference(draft):
    tokens, sched = check_against_reference(draft, 1)
    for rid, want in reference_sequential().items():
        np.testing.assert_array_equal(tokens[rid], want, err_msg=f"rid {rid}")
    assert sched.window_kinds["tree"] == 0
    if draft == "self":
        assert sched.acceptance_rate == 1.0
    else:      # random-init shrink drafter: the rollback really ran
        assert sched.accepted < sched.proposed
    # every verify ran the chain row, on the CPU its plain version
    census = sched.model.dispatcher.census()
    assert census[("specdec", "torch")] == sched.n_windows
    assert ("specdec_tree", "torch") not in census
    assert set(native.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# The reference's speculative cases, on the port
# ---------------------------------------------------------------------------


def _serve(schedule, lens, gen, *, n_slots=3, arrivals=None, **kw):
    """The port's smoke tinyllama (its own random weights) through one schedule."""
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, KernelDispatcher(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = ProgramCache()
    arrivals = arrivals or [0] * len(lens)
    reqs = [Request(i, p, gen, arrival=a)
            for i, (p, a) in enumerate(zip(_prompts(cfg.vocab, lens), arrivals))]
    max_len = max(lens) + gen
    if schedule == "sequential":
        sched = SequentialSchedule(model, params, cfg, max_len=max_len,
                                   stream=ExecutionStream(cache, device="cpu"))
    else:
        sched = SpeculativeSchedule(model, params, cfg, n_slots=n_slots, max_len=max_len,
                                    stream=AsyncExecutionStream(cache, device="cpu"), **kw)
    return {r.rid: r for r in sched.run(reqs)}, sched


def _same_tokens(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid].tokens, b[rid].tokens, err_msg=f"rid {rid}")


def test_spec_accept_all_bounds_when_drafter_is_target():
    """Two accept-all windows: depth 4 (5 tokens) and depth 3 (the budget cap)
    per lane, 18 tokens in all (reference :860)."""
    _, sched = _serve("spec", [16, 16], 10, n_slots=2, draft="self", draft_depth=4)
    assert sched.acceptance_rate == 1.0 and sched.proposed > 0
    st = sched.stats(2)
    assert st["emitted_tokens"] == 18
    assert st["verify_dispatches"] == st["n_windows"] == 2
    assert st["draft_dispatches"] == 2


def test_spec_adversarial_drafter_still_correct():
    """Independently drawn drafter weights: proposals are nearly always
    wrong, the stream never changes (reference :877)."""
    cfg = configs.get_smoke(ARCH)
    adversary = Drafter.shrink(cfg, dispatcher=KernelDispatcher(), device="cpu", seed=123)
    spec, sched = _serve("spec", [12, 9], 6, n_slots=2, drafter=adversary, draft_depth=4)
    seq, _ = _serve("sequential", [12, 9], 6)
    _same_tokens(spec, seq)
    assert sched.acceptance_rate < 0.5
    assert sched.accepted < sched.proposed


def test_spec_depth_clamped_to_cache_geometry():
    spec, sched = _serve("spec", [12, 9], 6, n_slots=2, draft="self", draft_depth=50)
    seq, _ = _serve("sequential", [12, 9], 6)
    _same_tokens(spec, seq)
    assert sched._min_positional_size() == 12 + 6     # full-cache slots


def test_spec_midflight_admission_parity():
    lens, arrivals = [16, 12, 14], [0, 0, 2]
    spec, _ = _serve("spec", lens, 8, n_slots=2, arrivals=arrivals, draft="self",
                     draft_depth=3)
    seq, _ = _serve("sequential", lens, 8, arrivals=arrivals)
    _same_tokens(spec, seq)
    assert spec[2].admitted_step > 0


def test_spec_stream_records_two_floors_per_window():
    _, sched = _serve("spec", [16, 16], 10, n_slots=2, draft="self", draft_depth=4)
    recs = sched.stream.records
    assert_record_invariants(sched.stream, window=sched.stream.max_in_flight)
    draft_recs = [r for r in recs if r.key in sched._draft_keys]
    verify_recs = [r for r in recs if r.key in sched._verify_keys]
    assert len(verify_recs) == sched.n_windows == 2
    assert len(draft_recs) == 2
    for r in draft_recs + verify_recs:
        assert r.floor_s == sched.stream.floor_s > 0.0
        assert r.batch == 2
    draft_seqs = sorted(r.seq for r in draft_recs)
    verify_seqs = sorted(r.seq for r in verify_recs)
    assert all(d < v for d, v in zip(draft_seqs, verify_seqs))
    assert sum(1 for r in recs if r.key == "spec_admit_slot") == 2


@pytest.mark.parametrize("branches", [1, 2])
def test_spec_window_reraises_a_program_error(monkeypatch, branches):
    """A program that raises inside a window (here its verify/accept call)
    surfaces with its own error, not as a failed unpack of its missing
    outputs."""
    from repro_torch.kernels.specdec import ops as specdec_ops

    def fail(*args, **kw):
        raise RuntimeError("verify/accept launch failed")

    monkeypatch.setattr(specdec_ops, "verify_accept", fail)
    monkeypatch.setattr(specdec_ops, "verify_accept_tree", fail)
    with pytest.raises(RuntimeError, match="verify/accept launch failed"):
        _serve("spec", [16, 16], 6, n_slots=2, draft="self", draft_depth=3,
               draft_branches=branches)


def test_spec_zero_window_stats_guard():
    spec, sched = _serve("spec", [16, 16], 1, n_slots=2, draft="shrink", draft_depth=4)
    seq, _ = _serve("sequential", [16, 16], 1)
    _same_tokens(spec, seq)
    assert sched.proposed == 0 and sched.n_windows == 0
    assert sched.acceptance_rate == 0.0
    st = sched.stats(2)
    assert st["drafter_trained"] is False
    assert all(np.isfinite(v) for v in st.values() if isinstance(v, float))


def test_draft_of_shrink_rule():
    cfg = configs.get_smoke(ARCH)
    dcfg = draft_of(cfg)
    assert dcfg.n_layers == 1
    assert (dcfg.vocab, dcfg.d_model, dcfg.mtp_depth) == (cfg.vocab, cfg.d_model, 0)
    assert dcfg.name.endswith("-draft")
    from repro.launch.speculative import draft_of as jdraft_of
    for arch in configs.ARCH_NAMES:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_smoke, jconfigs.get_smoke)):
            assert dataclasses.asdict(draft_of(get(arch))) == \
                dataclasses.asdict(jdraft_of(jget(arch)))


def test_spec_rejects_bad_setups():
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    kw = {"n_slots": 1, "max_len": 16}

    def make(**more):
        stream = more.pop("stream", None) or AsyncExecutionStream(device="cpu")
        return SpeculativeSchedule(model, params, cfg, stream=stream, **kw, **more)

    with pytest.raises(ValueError, match="AsyncExecutionStream"):
        make(stream=ExecutionStream(device="cpu"))
    with pytest.raises(ValueError, match="draft_depth"):
        make(draft_depth=0)
    with pytest.raises(ValueError, match="draft"):
        make(draft="ngram")
    with pytest.raises(ValueError, match="draft_branches"):
        make(draft_branches=0)
    with pytest.raises(ValueError, match="prefill"):
        make(prefill_chunk=8)
    with pytest.raises(ValueError, match="paged KV pool"):
        make(prefix_cache=True)
    bad = Drafter(model, params, dataclasses.replace(cfg, vocab=cfg.vocab * 2), kind="self")
    with pytest.raises(ValueError, match="vocab"):
        make(drafter=bad)
    with pytest.raises(ValueError, match="param"):
        Drafter.shrink(cfg, device="cpu", params=params)   # a 2-layer tree


def test_rollback_refuses_non_positional_cache_leaves():
    caches = [{"sub0": {"k": torch.zeros(1, 2, 4, 1, 2), "state": torch.zeros(1, 2, 3)}}]
    with pytest.raises(NotImplementedError, match="SSM"):
        _positional_leaves(caches)


def test_serve_cli_spec_schedule():
    """`--schedule spec` end to end on the CPU: a second round hits the
    program cache, the tokens are the continuous CLI run's (reference :1028)."""
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "6",
            "--requests", "2"]
    cont = serve.run(argv + ["--schedule", "continuous"])
    out = serve.run(argv + ["--schedule", "spec", "--draft", "self", "--draft-depth", "2"])
    np.testing.assert_array_equal(out["tokens"], cont["tokens"])
    assert out["cache_hits"] > 0
    assert out["acceptance_rate"] == 1.0
    assert out["n_windows"] > 0 and out["verify_dispatches"] > 0
    assert {b for _, b in out["routes"]} == {"torch"}
    assert set(out["launches"].values()) == {0}
    shr = serve.run(argv + ["--schedule", "spec", "--draft", "shrink", "--draft-depth", "2"])
    np.testing.assert_array_equal(shr["tokens"], cont["tokens"])
    assert shr["acceptance_rate"] < 1.0


# ---------------------------------------------------------------------------
# AsyncExecutionStream
# ---------------------------------------------------------------------------


def assert_record_invariants(stream, *, window=None):
    """Monotone submission order, non-negative work, the measured floor on
    every record, submit <= complete, in-flight depth inside the window."""
    recs = stream.records
    assert recs
    seqs = [r.seq for r in recs]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    for r in recs:
        assert r.work_s >= 0.0 and r.floor_s == stream.floor_s
        assert r.work_s == pytest.approx(max(0.0, r.wall_s - r.floor_s))
        assert r.complete_ts >= r.submit_ts > 0.0
        if window is None:
            assert r.inflight_depth == 0
        else:
            assert 0 <= r.inflight_depth < window


def test_async_stream_rejects_bad_window():
    with pytest.raises(ValueError, match="max_in_flight"):
        AsyncExecutionStream(ProgramCache(), device="cpu", max_in_flight=0)


def test_async_stream_submit_chain_and_records():
    """submit() returns outputs that chain into the next encoded op; records
    retire in submission order; the depth stays inside the window."""
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu", max_in_flight=2)
    prog, _ = cache.compile(lambda c, x: (c + x, (c + x).sum()), torch.zeros(32, 32),
                            torch.ones(32, 32))
    c, x = torch.zeros(32, 32), torch.ones(32, 32)
    sums = []
    for i in range(6):
        stream.encode_operation(prog, (c, x), f"op{i}", batch=i + 1)
        c, s = stream.submit()[0]
        sums.append(s)
    stream.sync()
    assert stream.in_flight_depth == 0
    assert [float(v) for v in sums] == [1024.0 * (i + 1) for i in range(6)]
    recs = stream.records
    assert [r.key for r in recs] == [f"op{i}" for i in range(6)]
    assert [r.batch for r in recs] == list(range(1, 7))
    assert [r.seq for r in recs] == list(range(6))
    assert_record_invariants(stream, window=2)
    completes = [r.complete_ts for r in recs]
    assert completes == sorted(completes)
    drainer = stream._drainer
    stream.close()
    assert drainer is not None and not drainer.is_alive()


def test_async_stream_stress_keeps_every_record_in_order():
    """Many submissions through a small window with the interpreter
    switching threads as often as it can: the drain thread and the host
    share the pending queue and the record list, and no record may be lost
    or reordered."""
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu", max_in_flight=3)
    prog, _ = cache.compile(lambda x: x + 1, torch.zeros(8))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        x = torch.zeros(8)
        for i in range(300):
            stream.encode_operation(prog, (x,), f"op{i}")
            (x,) = stream.submit()
            assert stream.in_flight_depth <= 3
        stream.sync()
    finally:
        sys.setswitchinterval(old)
        stream.close()
    assert torch.equal(x, torch.full((8,), 300.0))
    assert [r.seq for r in stream.records] == list(range(300))
    assert [r.key for r in stream.records] == [f"op{i}" for i in range(300)]
    assert all(0 <= r.inflight_depth < 3 for r in stream.records)


def test_async_execute_sync_keeps_base_contract():
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu")
    prog, key = cache.compile(lambda x: x + 1, torch.zeros(4))
    stream.encode_operation(prog, (torch.zeros(4),), key)
    stream.encode_operation(prog, (torch.ones(4),), key)
    outs = stream.execute_sync()
    assert isinstance(outs, list) and len(outs) == 2
    assert torch.equal(outs[1], torch.full((4,), 2.0))
    assert stream.execute_sync() == []
    stream.encode_operation(prog, (torch.zeros(4),), "async-op")
    stream.submit()
    stream.encode_operation(prog, (torch.zeros(4),), "sync-op")
    stream.execute_sync()
    seqs = [r.seq for r in stream.records]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert [r.key for r in stream.records[-2:]] == ["async-op", "sync-op"]
    assert stream.records[-1].inflight_depth == 0
    stream.close()


def test_async_stream_surfaces_errors_at_sync():
    """An error raised inside a submitted program surfaces at sync(), not
    in submit(), and the stream stays usable afterwards."""
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu")
    prog, key = cache.compile(lambda x: x @ torch.ones(3, 3), torch.zeros(3, 3))
    stream.encode_operation(prog, (torch.zeros(5, 5),), "boom")
    outs = stream.submit()
    assert outs == [None]
    with pytest.raises(RuntimeError):
        stream.sync()
    stream.encode_operation(prog, (torch.zeros(3, 3),), key)
    assert torch.equal(stream.execute_sync()[0], torch.zeros(3, 3))
    assert [r.key for r in stream.records] == ["boom", key]
    stream.close()
