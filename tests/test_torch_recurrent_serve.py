"""Serving the recurrent families on the CPU: the reference's regressions.

mamba2-1.3b and recurrentgemma-9b at smoke size, from the reference's own
parameters bridged into the port (the port's own init where only the port
runs). The reference runs its plain jnp model (no dispatcher) under its
`SequentialSchedule`, memoised per setting. Every stream is token-exact:

  * sequential, continuous and slo against the reference
    (`tests/test_serve_scheduler.py:96-97`: prompt lengths 24, 6, 17, 16 on
    3 lanes, 6 tokens; one prompt below the smallest bucket);
  * the merge keeps every recurrent leaf verbatim (:529);
  * speculative chain and tree windows with the shrink drafter, which
    rejects, against the sequential streams: recurrentgemma's prompt of 28
    plus 14 tokens overruns its 32-slot ring, mamba2's rollback is purely
    recurrent (:894-909); a drafter that agrees often, and not always,
    drives the rollback to a state inside the window; the depth clamp to
    the ring (:924-936);
  * chunked = unchunked (`tests/test_chunked_prefill.py:109`), also under
    slo;
  * the prefix pool: the insert / gather round trip bit for bit for the
    hybrid (paged K/V and anchored recurrent state) and pure SSM (anchors
    only) (`tests/test_kv_pool.py:471`), and pooled streams = pool-less;
  * an int4_palette serve of recurrentgemma-smoke whose packed-leaf census
    is the reference's (the RG-LRU mixers stay dense, as
    `repro/optim/compression.py:58-76` leaves them) and whose streams equal
    the sequential ones; the CLI on both archs.
"""

import _torch_threads  # noqa: F401

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import hal as jhal
from repro.core.dispatch import ExecutionStream as JStream, ProgramCache as JCache
from repro.launch.scheduler import Request as JRequest, SequentialSchedule as JSequential
from repro.models.model import build_model as jbuild
from repro.optim.compression import (compress_model_params as jcompress,
                                     weight_form_census as jcensus)
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream, KernelDispatcher,
                                       ProgramCache)
from repro_torch.launch import serve
from repro_torch.launch.kv_pool import PagedKVPool
from repro_torch.launch.scheduler import (ChunkConfig, ContinuousSchedule, PrefixConfig,
                                          Request, SequentialSchedule, ServeConfig,
                                          SLOConfig, build_scheduler, merge_prefill_caches)
from repro_torch.launch.speculative import Drafter, SpeculativeSchedule
from repro_torch.models.model import build_model
from repro_torch.optim.compression import compress_model_params, weight_form_census
from repro_torch.tree import leaves_with_path

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
PARITY_LENS, GEN, LANES = (24, 6, 17, 16), 6, 3
# the reference's rejection cases: (prompt lengths, tokens)
SPEC_CASES = {"recurrentgemma-9b": ((28, 20), 14), "mamba2-1.3b": ((16, 9), 8)}
CHUNK_LENS, CHUNK_GEN = (24, 6, 17, 16, 33), 5


def _prompts(vocab: int, lens) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in lens]


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """(jcfg, jparams, the port's bridged params)."""
    jcfg = jconfigs.get_smoke(arch)
    jparams = init_params(jcfg)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            configs.get_smoke(arch), "cpu")


@functools.lru_cache(maxsize=None)
def reference_streams(arch: str, lens: tuple, gen: int) -> dict:
    """The reference's sequential greedy streams, its plain jnp model."""
    jcfg, jparams, _ = reference(arch)
    sched = JSequential(jbuild(jcfg), jparams, jcfg, max_len=max(lens) + gen,
                        sampling="greedy", seed=0, stream=JStream(JCache(), target=jhal.TPU_V5E))
    return {r.rid: r.tokens for r in sched.run(
        [JRequest(i, p, gen) for i, p in enumerate(_prompts(jcfg.vocab, lens))])}


def _model(arch: str):
    cfg = configs.get_smoke(arch)
    return cfg, build_model(cfg, KernelDispatcher(), device="cpu")


def _serve(arch: str, schedule: str, lens, gen, *, params=None, n_slots=LANES, **kw):
    """The port's schedule on the bridged params: ({rid: result}, schedule)."""
    cfg, model = _model(arch)
    params = reference(arch)[2] if params is None else params
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cpu") if schedule in ("slo", "spec") \
        else ExecutionStream(cache, device="cpu")
    cls = {"sequential": SequentialSchedule, "continuous": ContinuousSchedule,
           "spec": SpeculativeSchedule}.get(schedule)
    if cls is None:
        config = ServeConfig(schedule=schedule, max_len=max(lens) + gen, n_slots=n_slots,
                             stream=stream, slo=SLOConfig(), **kw)
        sched = build_scheduler(config, model, params, cfg)
    else:
        slots = {} if schedule == "sequential" else {"n_slots": n_slots}
        sched = cls(model, params, cfg, max_len=max(lens) + gen, stream=stream, **slots, **kw)
    res = sched.run([Request(i, p, gen) for i, p in enumerate(_prompts(cfg.vocab, lens))])
    if schedule in ("slo", "spec"):
        stream.close()
    return {r.rid: r for r in res}, sched


def _same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want)
    for rid in want:
        tokens = got[rid].tokens if hasattr(got[rid], "tokens") else got[rid]
        np.testing.assert_array_equal(tokens, want[rid], err_msg=f"{what} rid {rid}")


# ---------------------------------------------------------------------------
# Schedules against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["sequential", "continuous", "slo"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_token_exact_against_reference(arch, schedule):
    got, _ = _serve(arch, schedule, PARITY_LENS, GEN)
    _same(got, reference_streams(arch, PARITY_LENS, GEN), f"{arch} {schedule}")
    if schedule != "sequential":
        # the sub-bucket prompt went through decode-only admission
        assert got[1].bucket == 0 and got[3].bucket == 16


@pytest.mark.parametrize("arch", ARCHS)
def test_merge_preserves_recurrent_state(arch):
    """Every recurrent leaf crosses the merge verbatim (and is not zero);
    the unwritten tail of a KV ring stays invalid."""
    cfg, model = _model(arch)
    s, max_len = 12, 20
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(1, s)).astype(np.int32))
    pf, _ = model.prefill(reference(arch)[2], {"tokens": tokens})
    merged = merge_prefill_caches(model.init_cache(1, max_len), pf)
    src = dict(leaves_with_path(pf))
    n_recurrent = 0
    for path, leaf in leaves_with_path(merged):
        name = path.rsplit("/", 1)[-1]
        if name == "pos":
            assert torch.equal(leaf[..., :s], src[path])
            assert bool((leaf[..., s:] == -1).all())
        elif name in ("k", "v"):
            assert torch.equal(leaf[:, :, :s], src[path])
        else:
            n_recurrent += 1
            assert torch.equal(leaf, src[path]) and bool(leaf.abs().sum() > 0), path
    assert n_recurrent == {"mamba2-1.3b": 3, "recurrentgemma-9b": 4}[arch]


# ---------------------------------------------------------------------------
# Speculative rollback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_rollback_on_rejection(arch, branches):
    """The shrink drafter (random weights) rejects nearly everything, so
    every window rolls back: recurrentgemma's rejected writes wrap its ring
    and must restore the old entries; mamba2's rollback keeps a per-step
    copy of its state."""
    lens, gen = SPEC_CASES[arch]
    spec, sched = _serve(arch, "spec", lens, gen, n_slots=2, draft="shrink", draft_depth=3,
                         draft_branches=branches)
    _same(spec, reference_streams(arch, lens, gen), f"{arch} spec x{branches}")
    assert sched.accepted < sched.proposed           # the rollback path ran
    assert sched.window_kinds["tree" if branches > 1 else "chain"] > 0


def _near_drafter(arch: str) -> Drafter:
    """The target itself with its head perturbed: it proposes the target's
    token often, and not always, so windows keep part of their proposals
    and roll the rest back to a state inside the window."""
    cfg, model = _model(arch)
    params = reference(arch)[2]
    gen = torch.Generator().manual_seed(5)
    head = params["embed"]["unembed"]
    noisy = head + 0.35 * head.std() * torch.randn(head.shape, generator=gen)
    dparams = {**params, "embed": {**params["embed"], "unembed": noisy}}
    return Drafter(model, dparams, cfg, kind="near", trained=True)


@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_partial_acceptance_keeps_the_accepted_state(arch, branches):
    lens, gen = SPEC_CASES[arch]
    spec, sched = _serve(arch, "spec", lens, gen, n_slots=2, drafter=_near_drafter(arch),
                         draft_depth=3, draft_branches=branches)
    _same(spec, reference_streams(arch, lens, gen), f"{arch} near drafter x{branches}")
    assert 0 < sched.accepted < sched.proposed and sched.partial_accepts > 0


def test_spec_depth_clamped_to_ring_window():
    """A draft depth past recurrentgemma's 32-slot ring is clamped to 31;
    mamba2 has no positional leaf, so only the cache end clamps it."""
    spec, sched = _serve("recurrentgemma-9b", "spec", (28, 20), 10, n_slots=2, draft="shrink",
                         draft_depth=100)
    _same(spec, reference_streams("recurrentgemma-9b", (28, 20), 10), "depth 100")
    assert sched._min_positional_size() == 32
    _, sched = _serve("mamba2-1.3b", "spec", (16, 9), 8, n_slots=2, draft="shrink",
                      draft_depth=100)
    assert sched._min_positional_size() == 16 + 8


# ---------------------------------------------------------------------------
# Chunked prefill and the prefix pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["continuous", "slo"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_matches_unchunked(arch, schedule):
    """The chunk program carries the RG-LRU's h, the SSM's state and conv
    tails and the ring from chunk to chunk in its staging row."""
    base, _ = _serve(arch, "continuous", CHUNK_LENS, CHUNK_GEN)
    if schedule == "slo":
        out, sched = _serve(arch, schedule, CHUNK_LENS, CHUNK_GEN,
                            chunk=ChunkConfig(prefill_chunk=8))
    else:
        out, sched = _serve(arch, schedule, CHUNK_LENS, CHUNK_GEN, prefill_chunk=8)
    _same(out, {rid: r.tokens for rid, r in base.items()}, f"{arch} chunked {schedule}")
    _same(base, reference_streams(arch, CHUNK_LENS, CHUNK_GEN), f"{arch} unchunked")
    assert sched.stats(len(CHUNK_LENS))["chunked_prefill"]["n_chunks"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_pool_roundtrip_is_bitwise(arch):
    """Prefill state through the arena and the anchor, gathered back: bit
    for bit the prefill cache (after `tests/test_kv_pool.py:471`). The
    hybrid pages its K/V and anchors its recurrent state; pure SSM pages
    nothing."""
    cfg, model = _model(arch)
    s, max_len, bs = 16, 32, 8
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(1, s)).astype(np.int32)
    pf, _ = model.prefill(reference(arch)[2], {"tokens": torch.from_numpy(prompt)})
    dec = model.init_cache(2, max_len)
    pool = PagedKVPool(8, bs)
    pool.bind(dec, max_len=max_len)
    assert bool(pool._paged_paths) == (arch == "recurrentgemma-9b")
    pool.validate_prefill(pf, s)
    keys, new_bids, first = pool.reserve(prompt[0])
    assert len(keys) == s // bs and first == 0
    pool.arenas = pool.insert_blocks(pool.arenas, pf, torch.as_tensor(new_bids), first)
    pool.set_anchor(keys[-1], pool.anchor_leaves(pf))
    got = pool.assemble_prefix(dec, pool.arenas, torch.as_tensor(pool.bids_of(keys)),
                               pool.anchor_of(keys[-1]))
    want = dict(leaves_with_path(pf))
    n_anchor = 0
    for path, leaf in leaves_with_path(got):
        assert torch.equal(leaf, want[path]), f"{arch} {path}: the round trip is not bitwise"
        n_anchor += path not in pool._paged_paths
    assert n_anchor == {"mamba2-1.3b": 3, "recurrentgemma-9b": 4}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_pooled_streams_equal_pool_less(arch):
    """Two rounds of the same prompts: the second admits from resident
    blocks (recurrent state from the anchors) and serves the same tokens."""
    lens = (17, 24, 16)
    cfg, model = _model(arch)
    params = reference(arch)[2]
    outs = {}
    for pooled in (False, True):
        config = ServeConfig(schedule="continuous", max_len=max(lens) + GEN, n_slots=2,
                             stream=ExecutionStream(ProgramCache(), device="cpu"),
                             prefix=PrefixConfig(blocks=16, block_size=8) if pooled else None)
        sched = build_scheduler(config, model, params, cfg)
        outs[pooled] = [{r.rid: r.tokens for r in sched.run(
            [Request(10 * rnd + i, p, GEN) for i, p in enumerate(_prompts(cfg.vocab, lens))])}
            for rnd in range(2)]
        if pooled:
            stats = sched.stats(6)["prefix_cache"]
            assert stats["hits"] >= 2 and stats["hit_tokens"] > 0
    for rnd, (pooled, plain) in enumerate(zip(outs[True], outs[False])):
        _same(pooled, plain, f"{arch} pooled round {rnd}")


# ---------------------------------------------------------------------------
# Packed weights and the CLI
# ---------------------------------------------------------------------------


def test_int4_palette_census_matches_reference_and_serves():
    """The port packs recurrentgemma-smoke's bridged params into the
    reference's packed-leaf census (attention, MLPs and the head; the RG-LRU
    mixers dense), then serves them token-exact against its sequential
    schedule, the mixers through `anemm` and the rest through `palette`."""
    arch = "recurrentgemma-9b"
    _, jparams, params = reference(arch)
    packed = compress_model_params(params, "int4_palette")
    census = weight_form_census(packed)
    assert census == jcensus(jcompress(jparams, "int4_palette"))
    assert not [p for p in census if "/mix/" in p and p.rsplit("/", 1)[-1] not in
                ("wq", "wk", "wv", "wo")]
    assert len(census) == 4 + 3 * 3 + 1        # the attention layer, three MLPs, the head
    lens, gen = (13, 8, 21), 4
    cont, sched = _serve(arch, "continuous", lens, gen, params=packed, n_slots=2)
    seq, _ = _serve(arch, "sequential", lens, gen, params=packed)
    _same(cont, {rid: r.tokens for rid, r in seq.items()}, "int4_palette")
    routes = {k for k, _ in sched.model.dispatcher.census()}
    assert routes == {"anemm", "palette", "decode_attention"}


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_recurrent_archs(arch):
    out = serve.run(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-lens", "5,8,13,40", "--gen", "4", "--requests", "2"])
    assert out["tokens"].shape == (4, 4)
    np.testing.assert_array_equal(out["round_tokens"][0], out["round_tokens"][1])
    routes = {k for k, _ in out["routes"]}
    assert routes == ({"anemm"} if arch == "mamba2-1.3b" else {"anemm", "decode_attention"})
    assert all(b == "torch" for _, b in out["routes"])


def test_spec_cli_drafts_one_pattern_period():
    out = serve.run(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu", "--batch",
                     "2", "--prompt-lens", "8,13", "--gen", "5", "--schedule", "spec",
                     "--draft", "shrink", "--draft-branches", "2"])
    engine = out["engine"]
    assert engine.drafter.cfg.n_layers == 3 and engine.drafter.cfg.block_pattern
    assert out["tokens"].shape == (2, 5)
    assert dataclasses.asdict(engine.cfg) == dataclasses.asdict(
        configs.get_smoke("recurrentgemma-9b"))
