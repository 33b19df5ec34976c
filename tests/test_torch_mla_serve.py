"""Serving deepseek-v3-671b (MLA) on the CPU: the latent cache through every
schedule.

deepseek-v3-671b smoke from the reference's own parameters bridged into the
port. The reference runs its plain jnp model (no dispatcher) under its
`SequentialSchedule`, memoised per setting. Every stream is token-exact:

  * sequential, continuous and slo against the reference (prompt lengths
    24, 6, 17, 16 on 3 lanes, 6 tokens; one prompt below the smallest
    bucket, admitted decode-only);
  * admission writes `c_kv` / `k_rope` / `pos` into a lane and leaves the
    other lanes alone, and a decode-only reset invalidates the lane;
  * chunked = unchunked (`tests/test_chunked_prefill.py:108-121`: prefill
    runs the expanded form, a chunk the absorbed one), also under slo;
  * speculative chain and tree windows with the shrink drafter (one dense
    MLA layer, no MTP), which rejects, against the sequential streams;
  * the prefix pool: `c_kv` and `k_rope` page; the insert / gather round
    trip is bit for bit, and pooled streams equal pool-less ones;
  * an int4_palette serve equal to its own sequential streams; the CLI.
"""

import _torch_threads  # noqa: F401

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
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream, KernelDispatcher,
                                       ProgramCache)
from repro_torch.launch import serve
from repro_torch.launch.kv_pool import PagedKVPool
from repro_torch.launch.scheduler import (ChunkConfig, ContinuousSchedule, PrefixConfig,
                                          Request, SequentialSchedule, ServeConfig,
                                          SLOConfig, admit_into_slot, build_scheduler,
                                          reset_slot)
from repro_torch.launch.speculative import SpeculativeSchedule
from repro_torch.models.model import build_model
from repro_torch.optim.compression import compress_model_params
from repro_torch.tree import leaves_with_path

ARCH = "deepseek-v3-671b"
PARITY_LENS, GEN, LANES = (24, 6, 17, 16), 6, 3
SPEC_LENS, SPEC_GEN = (20, 11), 9
CHUNK_LENS, CHUNK_GEN = (24, 6, 17, 16, 33), 5


def _prompts(vocab: int, lens) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in lens]


@functools.lru_cache(maxsize=None)
def reference():
    """(jcfg, jparams, the port's bridged params)."""
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = init_params(jcfg)
    return jcfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            configs.get_smoke(ARCH), "cpu")


@functools.lru_cache(maxsize=None)
def reference_streams(lens: tuple, gen: int) -> dict:
    """The reference's sequential greedy streams, its plain jnp model."""
    jcfg, jparams, _ = reference()
    sched = JSequential(jbuild(jcfg), jparams, jcfg, max_len=max(lens) + gen,
                        sampling="greedy", seed=0, stream=JStream(JCache(), target=jhal.TPU_V5E))
    return {r.rid: r.tokens for r in sched.run(
        [JRequest(i, p, gen) for i, p in enumerate(_prompts(jcfg.vocab, lens))])}


def _model():
    cfg = configs.get_smoke(ARCH)
    return cfg, build_model(cfg, KernelDispatcher(), device="cpu")


def _serve(schedule: str, lens, gen, *, params=None, n_slots=LANES, **kw):
    """The port's schedule on the bridged params: ({rid: result}, schedule)."""
    cfg, model = _model()
    params = reference()[2] if params is None else params
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
def test_greedy_streams_token_exact_against_reference(schedule):
    got, _ = _serve(schedule, PARITY_LENS, GEN)
    _same(got, reference_streams(PARITY_LENS, GEN), schedule)
    if schedule != "sequential":
        # the sub-bucket prompt went through decode-only admission
        assert got[1].bucket == 0 and got[3].bucket == 16


def test_admission_and_reset_write_one_lane():
    """A batch-1 prefill cache admitted into lane 1 of a 3-lane decode cache:
    its latents and positions land in lane 1's first slots, the lane's
    stale tail is invalidated, other lanes are untouched; a decode-only
    reset sets the lane's `pos` to -1 and leaves its latents (masked)."""
    cfg, model = _model()
    params = reference()[2]
    s, max_len = 9, 20
    tokens = torch.from_numpy(_prompts(cfg.vocab, (s,))[0][None])
    pf, _ = model.prefill(params, {"tokens": tokens})
    dec = model.init_cache(3, max_len)
    for _, leaf in leaves_with_path(dec):
        leaf.fill_(7)
    before = {p: t.clone() for p, t in leaves_with_path(dec)}
    admit_into_slot(dec, pf, 1)
    src = dict(leaves_with_path(pf))
    names = set()
    for path, leaf in leaves_with_path(dec):
        name = path.rsplit("/", 1)[-1]
        names.add(name)
        assert torch.equal(leaf[:, 0], before[path][:, 0]) and \
            torch.equal(leaf[:, 2], before[path][:, 2]), path
        assert torch.equal(leaf[:, 1, :s], src[path][:, 0]), path
        if name == "pos":
            assert bool((leaf[:, 1, s:] == -1).all())
    assert names == {"c_kv", "k_rope", "pos"}
    reset_slot(dec, 1)
    for path, leaf in leaves_with_path(dec):
        if path.endswith("/pos"):
            assert bool((leaf[:, 1] == -1).all())
        else:
            assert torch.equal(leaf[:, 1, :s], src[path][:, 0]), path


@pytest.mark.parametrize("schedule", ["continuous", "slo"])
def test_chunked_matches_unchunked(schedule):
    """Prompts admitted as chunks of 8 (the absorbed form over the staging
    row's latent cache) serve the tokens of the expanded-form prefill."""
    base, _ = _serve("continuous", CHUNK_LENS, CHUNK_GEN)
    if schedule == "slo":
        out, sched = _serve(schedule, CHUNK_LENS, CHUNK_GEN, chunk=ChunkConfig(prefill_chunk=8))
    else:
        out, sched = _serve(schedule, CHUNK_LENS, CHUNK_GEN, prefill_chunk=8)
    _same(out, {rid: r.tokens for rid, r in base.items()}, f"chunked {schedule}")
    _same(base, reference_streams(CHUNK_LENS, CHUNK_GEN), "unchunked")
    assert sched.stats(len(CHUNK_LENS))["chunked_prefill"]["n_chunks"] > 0


# ---------------------------------------------------------------------------
# Speculative rollback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branches", [1, 2])
def test_spec_rollback_on_rejection(branches):
    """The shrink drafter (one dense MLA layer, random weights) rejects, so
    windows roll back their `c_kv` / `k_rope` / `pos` writes; the streams
    are the sequential ones."""
    spec, sched = _serve("spec", SPEC_LENS, SPEC_GEN, n_slots=2, draft="shrink",
                         draft_depth=3, draft_branches=branches)
    _same(spec, reference_streams(SPEC_LENS, SPEC_GEN), f"spec x{branches}")
    dcfg = sched.drafter.cfg
    assert (dcfg.n_layers, dcfg.mtp_depth, dcfg.use_mla) == (1, 0, True)
    assert not dcfg.layer_is_moe(0)
    assert sched.accepted < sched.proposed           # the rollback path ran
    assert sched.window_kinds["tree" if branches > 1 else "chain"] > 0


# ---------------------------------------------------------------------------
# The prefix pool
# ---------------------------------------------------------------------------


def test_pool_roundtrip_is_bitwise():
    """A prefill's latent cache through the arena, gathered back: bit for
    bit (after `tests/test_kv_pool.py:471`); `c_kv`, `k_rope` and `pos`
    page, nothing is anchored."""
    cfg, model = _model()
    s, max_len, bs = 16, 32, 8
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(1, s)).astype(np.int32)
    pf, _ = model.prefill(reference()[2], {"tokens": torch.from_numpy(prompt)})
    dec = model.init_cache(2, max_len)
    pool = PagedKVPool(8, bs)
    pool.bind(dec, max_len=max_len)
    assert {p.rsplit("/", 1)[-1] for p in pool._paged_paths} == {"c_kv", "k_rope", "pos"}
    pool.validate_prefill(pf, s)
    keys, new_bids, first = pool.reserve(prompt[0])
    assert len(keys) == s // bs and first == 0
    pool.arenas = pool.insert_blocks(pool.arenas, pf, torch.as_tensor(new_bids), first)
    pool.set_anchor(keys[-1], pool.anchor_leaves(pf))
    got = pool.assemble_prefix(dec, pool.arenas, torch.as_tensor(pool.bids_of(keys)),
                               pool.anchor_of(keys[-1]))
    want = dict(leaves_with_path(pf))
    for path, leaf in leaves_with_path(got):
        assert path in pool._paged_paths
        assert torch.equal(leaf, want[path]), f"{path}: the round trip is not bitwise"


def test_pooled_streams_equal_pool_less():
    """Two rounds of the same prompts: the second admits from resident
    latent blocks and serves the same tokens."""
    lens = (17, 24, 16)
    cfg, model = _model()
    params = reference()[2]
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
        _same(pooled, plain, f"pooled round {rnd}")


# ---------------------------------------------------------------------------
# Packed weights and the CLI
# ---------------------------------------------------------------------------


def test_int4_palette_serves():
    """deepseek-smoke packed by the port: continuous streams equal its own
    sequential ones; `wq_b` / `wkv_b` through `anemm`, the rest `palette`."""
    packed = compress_model_params(reference()[2], "int4_palette")
    lens, gen = (13, 8, 21), 4
    cont, sched = _serve("continuous", lens, gen, params=packed, n_slots=2)
    seq, _ = _serve("sequential", lens, gen, params=packed)
    _same(cont, {rid: r.tokens for rid, r in seq.items()}, "int4_palette")
    assert {k for k, _ in sched.model.dispatcher.census()} == {"anemm", "palette"}


def test_cli_serves_deepseek():
    out = serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                     "--prompt-lens", "5,8,13,40", "--gen", "4", "--requests", "2"])
    assert out["tokens"].shape == (4, 4)
    np.testing.assert_array_equal(out["round_tokens"][0], out["round_tokens"][1])
    assert set(out["routes"]) == {("anemm", "torch")}
    assert out["engine"].cfg.use_mla and out["engine"].cfg.mtp_depth == 1
    spec = serve.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-lens", "5,8,13,40", "--gen", "4", "--schedule", "spec",
                      "--draft", "shrink", "--draft-branches", "2"])
    np.testing.assert_array_equal(spec["tokens"], out["tokens"])
