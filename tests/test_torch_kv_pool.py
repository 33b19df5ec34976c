"""The port's paged KV pool and paged decode against the JAX package's, on the CPU.

Host half: the port's `PagedKVPool` and the reference's take the same steps.
A seeded random-op interpreter (after `tests/test_kv_pool.py`'s) drives both
pools with the same ops, under plain LRU and under one shared eviction cost
function, and after every op the two must agree on keys, arena rows,
refcounts, anchors, depths, the free list, the LRU order, the page tables,
the stats and what each op returned; both must pass their `audit()`. The
reference's unit cases (geometry, chain hashing, matching, release, eviction,
copy-on-write, cost-aware eviction, depth) run on the port's pool as
parametrised cases, with the reference's pool beside it.

Device half: insert -> assemble round trips bit for bit on tinyllama-smoke
caches, the arena rows written from the reference's own prefill cache equal
the reference pool's, malformed prefill trees fail loud with the leaf's
path, and a copy-on-write divergence copies the arena row.

Paged decode: the port's plain `paged_decode_attention` against the
reference's Pallas kernel (interpret mode) on the reference's ragged cases,
with and without sliding windows, and bit for bit against the plain
monolithic decode on the gathered pages. The CUDA kernel runs only on the
card: the `cuda`-marked tests at the end hold it against its plain version
and bit for bit against `decode_attention(bk=bs)`, and skip here.
"""

import _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.core import costmodel as jcost
from repro.kernels import compat
from repro.kernels.flash import decode_attention as jdec
from repro.launch.kv_pool import PagedKVPool as JPool
from repro.models.model import build_model as jbuild
from _reference_params import init_params
from repro_torch import configs
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.core.dispatch import ExecutionStream, KernelDispatcher
from repro_torch.kernels import native
from repro_torch.kernels.flash.decode_attention import (decode_attention,
                                                        decode_attention_ref, gather_pages,
                                                        gathered_positions,
                                                        paged_decode_attention,
                                                        paged_decode_attention_ref)
from repro_torch.launch.kv_pool import TIME_MERGE_LEAVES, PagedKVPool
from repro_torch.launch.scheduler import ContinuousSchedule
from repro_torch.models.model import build_model
from repro_torch.tree import leaves_with_path, map_with_path

ARCH = "tinyllama-1.1b"
POOLS = {"port": PagedKVPool, "reference": JPool}


def toks(*xs):
    return np.asarray(xs, np.int32)


def snapshot(pool) -> dict:
    """Everything the host half decides, in a form both pools share."""
    return {
        "nodes": {k: (n.parent, n.bid, n.tokens.tolist(), n.lane_refs, n.children,
                      n.anchored, n.depth) for k, n in pool._nodes.items()},
        "free": list(pool._free),
        "lru": list(pool._lru),
        "tables": {o: list(t) for o, t in pool._tables.items()},
        "stats": dict(pool.stats),
    }


# ---------------------------------------------------------------------------
# Host half: the reference's unit cases, on both pools
# ---------------------------------------------------------------------------


def case_geometry(Pool):
    with pytest.raises(ValueError, match="n_blocks"):
        Pool(0, 4)
    with pytest.raises(ValueError, match="block_size"):
        Pool(4, 0)
    return Pool(3, 2)


def case_chain_hash(Pool):
    pool = Pool(8, 2)
    k1, _, _ = pool.reserve(toks(1, 2, 5, 6))
    k2, _, _ = pool.reserve(toks(3, 4, 5, 6))
    assert k1[0] != k2[0] and k1[1] != k2[1]
    again, new, _ = pool.reserve(toks(1, 2, 5, 6))
    assert again == k1 and new == []
    assert pool.free_blocks() == 8 - 4
    return pool


def case_match(Pool):
    pool = Pool(8, 2)
    keys, _, _ = pool.reserve(toks(1, 2, 3, 4, 5, 6))
    assert pool.match(toks(1, 2, 3, 4, 9, 9)) == keys[:2]
    assert pool.match(toks(1, 2, 3, 4, 5, 6, 7)) == keys
    assert pool.match(toks(9, 9)) == []
    assert pool.anchored_match(toks(1, 2, 3, 4)) == []
    pool.set_anchor(keys[1], None)
    assert pool.anchored_match(toks(1, 2, 3, 4, 5, 6)) == keys[:2]
    assert pool.anchored_match(toks(1, 2, 3, 4, 5, 6), limit=3) == []
    assert pool.anchored_match(toks(1, 2, 3, 4, 5, 6), limit=5) == keys[:2]
    return pool


def case_release(Pool):
    pool = Pool(8, 2)
    a, _, _ = pool.reserve(toks(1, 2, 3, 4))
    pool.acquire("r0", a)
    b, _, _ = pool.reserve(toks(1, 2, 9, 9))
    pool.acquire("r1", b)
    assert a[0] == b[0] and a[1] != b[1]
    assert pool.refcount(a[0]) == 2 + 2
    assert pool.release("r1") == [b[1]]
    assert b[1] in pool.resident()
    assert set(pool.release("r0")) == {a[1]}
    pool.acquire("r2", a)
    with pytest.raises(ValueError, match="already holds"):
        pool.acquire("r2", a[:1])
    with pytest.raises(KeyError):
        pool.acquire("r3", ["deadbeef"])
    return pool


def case_referenced_never_evicted(Pool):
    pool = Pool(4, 2)
    a, _, _ = pool.reserve(toks(1, 2, 3, 4))
    pool.acquire("r0", a)
    pool.reserve(toks(5, 6, 7, 8))
    keys, new, _ = pool.reserve(toks(9, 9, 8, 8))
    assert len(keys) == 2 and len(new) == 2 and pool.stats["evictions"] == 2
    assert all(k in pool.resident() for k in a)
    pool.acquire("r1", keys)
    assert pool.reserve(toks(4, 4, 4, 4))[:2] == ([], [])
    return pool


def case_lru_cascade(Pool):
    pool = Pool(2, 2)
    a, _, _ = pool.reserve(toks(1, 2, 3, 4))
    assert pool.refcount(a[0]) == 1 and pool.refcount(a[1]) == 0
    b, new, _ = pool.reserve(toks(7, 7, 8, 8))
    assert len(b) == len(new) == 2 and pool.stats["evictions"] == 2
    assert pool.resident() == set(b)
    return pool


def case_cow(Pool):
    pool = Pool(8, 2)
    a, _, _ = pool.reserve(toks(1, 2, 3, 4))
    pool.acquire("r0", a)
    pool.fork("r0", "r1")
    shared_bid = pool.bids_of(a[1:])[0]
    new_key = pool.write("r1", 1, toks(8, 9))
    assert new_key != a[1] and pool.bids_of([new_key])[0] != shared_bid
    assert pool.table("r0") == a and pool.table("r1") == [a[0], new_key]
    assert pool.write("r0", 1, toks(3, 4)) == a[1]
    pool.release("r1")
    c, _, _ = pool.reserve(toks(1, 2, 3, 4, 5, 6))
    pool.acquire("r2", c)
    k = pool.write("r2", 0, toks(7, 7))
    assert pool.table("r2") == [k]
    with pytest.raises(IndexError, match="cannot write"):
        pool.write("r2", 5, toks(1, 2))
    with pytest.raises(ValueError, match="one block"):
        pool.write("r2", 0, toks(1, 2, 3))
    return pool


def case_lru_control(Pool):
    pool = Pool(3, 2)
    a, _, _ = pool.reserve(toks(1, 2, 3, 4))
    b, _, _ = pool.reserve(toks(5, 6))
    pool.reserve(toks(7, 7))
    assert a[1] not in pool.resident() and b[0] in pool.resident()
    return pool


def case_cost_aware(Pool):
    pool = Pool(3, 2, evict_cost_fn=lambda n_tokens: float(n_tokens))
    a, _, _ = pool.reserve(toks(1, 2, 3, 4))
    b, _, _ = pool.reserve(toks(5, 6))
    pool.reserve(toks(7, 7))
    assert b[0] not in pool.resident() and all(k in pool.resident() for k in a)
    assert pool.stats["evictions"] == 1
    return pool


def case_cost_aware_skips_referenced(Pool):
    pool = Pool(2, 2, evict_cost_fn=lambda n: float(n))
    a, _, _ = pool.reserve(toks(1, 2))
    pool.acquire("r0", a)
    b, _, _ = pool.reserve(toks(3, 4))
    pool.reserve(toks(5, 5))
    assert a[0] in pool.resident() and b[0] not in pool.resident()
    return pool


def case_depth(Pool):
    pool = Pool(8, 2)
    keys, _, _ = pool.reserve(toks(1, 2, 3, 4, 5, 6))
    assert [pool._nodes[k].depth for k in keys] == [1, 2, 3]
    pool.acquire("r0", keys)
    k = pool.write("r0", 1, toks(8, 9))
    assert pool._nodes[k].depth == 2
    return pool


CASES = {f.__name__.removeprefix("case_"): f for f in (
    case_geometry, case_chain_hash, case_match, case_release,
    case_referenced_never_evicted, case_lru_cascade, case_cow, case_lru_control,
    case_cost_aware, case_cost_aware_skips_referenced, case_depth)}


@pytest.mark.parametrize("name", list(CASES))
def test_pool_case_matches_reference(name):
    port, ref = CASES[name](PagedKVPool), CASES[name](JPool)
    port.audit()
    assert snapshot(port) == snapshot(ref)


# ---------------------------------------------------------------------------
# Host half: the seeded random-op interpreter, both pools in lockstep
# ---------------------------------------------------------------------------

#: tiny geometry and alphabet (the reference's): collisions, shared
#: prefixes and eviction pressure on every run
N_BLOCKS, BLOCK, ALPHABET = 6, 2, 3


def _ops_from_rng(rng: np.random.Generator, n: int) -> list[tuple]:
    """The reference's op draws (`tests/test_kv_pool.py:322`)."""
    ops = []
    for _ in range(n):
        r = rng.integers(0, 4)
        if r == 0:
            L = int(rng.integers(1, 5)) * BLOCK
            ops.append(("insert", rng.integers(0, ALPHABET, size=(L,)).tolist(),
                        bool(rng.integers(0, 2))))
        elif r == 1:
            ops.append(("release", int(rng.integers(0, 8))))
        elif r == 2:
            ops.append(("fork", int(rng.integers(0, 8))))
        else:
            ops.append(("write", int(rng.integers(0, 8)), int(rng.integers(0, 4)),
                        rng.integers(0, ALPHABET, size=(BLOCK,)).tolist()))
    return ops


def _apply(pool, owners: dict, next_owner: int, op: tuple):
    """One op of the reference's interpreter; returns (what it returned,
    next owner id). `owners` maps an owner id to its keys."""
    kind = op[0]
    if kind == "insert":
        keys, new, first = pool.reserve(np.asarray(op[1], np.int32))
        if keys and op[2]:
            pool.set_anchor(keys[-1], None)
            pool.acquire(("o", next_owner), keys)
            owners[next_owner] = keys
            next_owner += 1
        return (keys, new, first), next_owner
    if not owners:
        return None, next_owner
    oid = sorted(owners)[op[1] % len(owners)]
    if kind == "release":
        owners.pop(oid)
        return pool.release(("o", oid)), next_owner
    if kind == "fork":
        pool.fork(("o", oid), ("o", next_owner))
        owners[next_owner] = list(owners[oid])
        return None, next_owner + 1
    table = pool.table(("o", oid))
    if not table:
        return None, next_owner
    out = pool.write(("o", oid), op[2] % len(table), np.asarray(op[3], np.int32))
    owners[oid] = pool.table(("o", oid))
    return out, next_owner


def _shared_cost(n_tokens: int) -> float:
    """One eviction cost function for both pools: a floor plus work that
    grows with the chain, as the scheduler's re-prefill estimate does."""
    return 1e-5 + 1e-7 * n_tokens


@pytest.mark.parametrize("policy", ["lru", "cost"])
@pytest.mark.parametrize("seed", range(20))
def test_pool_fuzz_matches_reference_op_for_op(seed, policy):
    kw = {"evict_cost_fn": _shared_cost} if policy == "cost" else {}
    port, ref = PagedKVPool(N_BLOCKS, BLOCK, **kw), JPool(N_BLOCKS, BLOCK, **kw)
    state = {"port": ({}, 0), "reference": ({}, 0)}
    for step, op in enumerate(_ops_from_rng(np.random.default_rng(seed), 40)):
        outs = {}
        for name, pool in (("port", port), ("reference", ref)):
            owners, nxt = state[name]
            outs[name], nxt = _apply(pool, owners, nxt, op)
            state[name] = (owners, nxt)
        assert outs["port"] == outs["reference"], f"op {step} {op}"
        port.audit()
        ref.audit()
        assert snapshot(port) == snapshot(ref), f"op {step} {op}"
    for oid in sorted(state["port"][0]):
        assert port.release(("o", oid)) == ref.release(("o", oid))
        port.audit()
    assert snapshot(port) == snapshot(ref)
    assert port.owners() == set()


def test_scheduler_re_prefill_cost_feeds_pool():
    """The continuous schedule prices an eviction with the cost model on
    the model's target (the H100's rates) plus the measured floor: deeper
    chains cost more, every cost includes the floor, and each equals the
    reference cost model's counts over the same rates."""
    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, KernelDispatcher(), device="cpu")
    sched = ContinuousSchedule(model, None, cfg, n_slots=2, max_len=32,
                               stream=ExecutionStream(device="cpu"), prefix_cache=True,
                               prefix_blocks=8, prefix_block_size=4)
    assert sched.pool.evict_cost_fn is not None
    c8, c64 = sched._re_prefill_cost(8), sched._re_prefill_cost(64)
    assert 0 < sched.stream.floor_s < c8 <= c64
    assert sched._re_prefill_cost(1 << 20) > c64
    t = model.dispatcher.target
    jcfg = jconfigs.get_smoke(ARCH)
    for n in (1, 8, 64, 1 << 20):
        shape = JShape("re_prefill", n, 1, "prefill")
        work = max((jcost.model_flops(jcfg, shape) + jcost.attention_flops(jcfg, shape))
                   / t.peak_flops, jcost.weight_bytes(jcfg) / t.hbm_bandwidth)
        assert sched._re_prefill_cost(n) == sched.stream.floor_s + work, n


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------

_MEMO: dict = {}


def _reference_prefill(s: int = 16):
    """The reference's smoke tinyllama and one batch-1 prefill cache."""
    if "pf" not in _MEMO:
        cfg = jconfigs.get_smoke(ARCH)
        model = jbuild(cfg)
        params = init_params(cfg)
        prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(1, s)).astype(np.int32)
        pf, _ = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(prompt)})
        _MEMO["pf"] = (model, params, prompt, pf)
    return _MEMO["pf"]


def _bridge_tree(jtree):
    leaves = {compat.tree_path_str(p): tensor_from_numpy(np.asarray(v), "cpu")
              for p, v in compat.tree_flatten_with_path(jtree)[0]}
    return leaves


def _port_tree_like(port_tree, leaves: dict):
    return map_with_path(lambda p, _: leaves[p], port_tree)


def test_pool_roundtrip_is_bitwise_and_rows_equal_reference():
    """Prefill state routed through the arena and gathered back is the
    prefill cache bit for bit; the arena rows written from the reference's
    own prefill cache equal the reference pool's rows."""
    jmodel, jparams, prompt, jpf = _reference_prefill()
    s, max_len, bs = prompt.shape[1], 32, 8
    jpool = JPool(8, bs)
    jpool.bind(jmodel.init_cache(2, max_len), max_len=max_len)
    keys, new_bids, first = jpool.reserve(prompt[0])
    jpool.arenas = jpool.insert_blocks(jpool.arenas, jpf, jnp.asarray(new_bids, jnp.int32),
                                       first)

    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg, device="cpu")
    dec = model.init_cache(2, max_len)
    pf = _port_tree_like(dec, _bridge_tree(jpf))
    pool = PagedKVPool(8, bs)
    pool.bind(dec, max_len=max_len)
    assert pool._paged_paths == {"0/sub0/k", "0/sub0/v", "0/sub0/pos"}
    assert pool._paged_paths == jpool._paged_paths
    pool.validate_prefill(pf, s)
    tkeys, tnew, tfirst = pool.reserve(prompt[0])
    assert (tkeys, tnew, tfirst) == (keys, new_bids, first)
    bids = torch.as_tensor(tnew, dtype=torch.long)
    assert pool.insert_blocks(pool.arenas, pf, bids, tfirst) is pool.arenas
    pool.set_anchor(tkeys[-1], pool.anchor_leaves(pf))
    for loc, arena in pool.arenas.items():
        np.testing.assert_array_equal(arena.numpy(), np.asarray(jpool.arenas[loc]),
                                      err_msg=loc)
    assembled = pool.assemble_prefix(dec, pool.arenas,
                                     torch.as_tensor(pool.bids_of(tkeys), dtype=torch.long),
                                     pool.anchor_of(tkeys[-1]))
    got, want = dict(leaves_with_path(assembled)), dict(leaves_with_path(pf))
    assert list(got) == list(want)
    for loc in got:
        assert torch.equal(got[loc], want[loc]), loc

    # the port's own prefill, through the same round trip
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    own, _ = model.prefill(params, {"tokens": torch.from_numpy(prompt)})
    pool2 = PagedKVPool(8, bs)
    pool2.bind(dec, max_len=max_len)
    keys2, new2, first2 = pool2.reserve(prompt[0])
    pool2.insert_blocks(pool2.arenas, own, torch.as_tensor(new2), first2)
    back = pool2.assemble_prefix(dec, pool2.arenas, torch.as_tensor(pool2.bids_of(keys2)), {})
    for (loc, a), (_, b) in zip(leaves_with_path(back), leaves_with_path(own)):
        assert torch.equal(a, b), loc


def test_pool_cow_write_copies_the_arena_row():
    cfg = configs.get_smoke(ARCH)
    dec = build_model(cfg, device="cpu").init_cache(1, 16)
    pool = PagedKVPool(4, 4)
    pool.bind(dec, max_len=16)
    for i, arena in enumerate(pool.arenas.values()):
        arena.copy_(torch.arange(arena.numel()).reshape(arena.shape).to(arena.dtype) + i)
    keys, _, _ = pool.reserve(toks(1, 2, 3, 4))
    pool.acquire("r0", keys)
    pool.fork("r0", "r1")
    old_bid = pool.bids_of(keys)[0]
    new_key = pool.write("r1", 0, toks(4, 3, 2, 1))
    new_bid = pool.bids_of([new_key])[0]
    assert new_bid != old_bid and pool.stats["cow_copies"] == 1
    for arena in pool.arenas.values():
        assert torch.equal(arena[new_bid], arena[old_bid])
    pool.audit()


def test_pool_bind_classifies_ring_leaves_as_anchor():
    dec = {"attn": {"k": torch.zeros((1, 2, 32, 2, 4)), "v": torch.zeros((1, 2, 32, 2, 4)),
                    "pos": torch.zeros((1, 2, 32), dtype=torch.int32)},
           "win": {"k": torch.zeros((1, 2, 8, 2, 4)),
                   "pos": torch.zeros((1, 2, 8), dtype=torch.int32)},
           "ssm": {"state": torch.zeros((1, 2, 16, 4))}}
    pool = PagedKVPool(4, 4)
    pool.bind(dec, max_len=32)
    assert pool._paged_paths == {"attn/k", "attn/v", "attn/pos"}
    assert pool._anchor_paths == {"win/k", "win/pos", "ssm/state"}
    for loc, arena in pool.arenas.items():
        assert tuple(arena.shape[:3]) == (4, 1, 4), loc
        assert arena.dtype == dec["attn"][loc.split("/")[1]].dtype
    assert sorted(TIME_MERGE_LEAVES) == ["c_kv", "k", "k_rope", "pos", "v"]
    # the anchor is a copy: a later in-place write to the prefill tree
    # does not reach it
    pf = {"attn": {"k": torch.zeros((1, 1, 8, 2, 4)), "v": torch.zeros((1, 1, 8, 2, 4)),
                   "pos": torch.zeros((1, 1, 8), dtype=torch.int32)},
          "win": {"k": torch.ones((1, 1, 8, 2, 4)),
                  "pos": torch.zeros((1, 1, 8), dtype=torch.int32)},
          "ssm": {"state": torch.ones((1, 1, 16, 4))}}
    anchor = pool.anchor_leaves(pf)
    pf["ssm"]["state"].zero_()
    assert set(anchor) == {"win/k", "win/pos", "ssm/state"}
    assert bool((anchor["ssm/state"] == 1).all())


def test_pool_validate_prefill_fails_loud_with_path():
    dec = {"g0": {"sub0": {"k": torch.zeros((2, 3, 16, 2, 8)),
                           "pos": torch.zeros((2, 3, 16), dtype=torch.int32),
                           "h": torch.zeros((2, 3, 5))}}}
    pool = PagedKVPool(4, 4)
    pool.bind(dec, max_len=16)
    assert pool._paged_paths == {"g0/sub0/k", "g0/sub0/pos"}

    def ok():
        return {"g0": {"sub0": {"k": torch.zeros((2, 1, 8, 2, 8)),
                                "pos": torch.zeros((2, 1, 8), dtype=torch.int32),
                                "h": torch.ones((2, 1, 5))}}}
    pool.validate_prefill(ok(), 8)
    for shape, match in (((2, 1, 8, 2), r"g0/sub0/k.*rank"),
                         ((2, 1, 6, 2, 8), r"g0/sub0/k.*time extent"),
                         ((2, 1, 8, 3, 8), r"g0/sub0/k.*arena row"),
                         ((2, 2, 8, 2, 8), r"g0/sub0/k.*batch")):
        bad = ok()
        bad["g0"]["sub0"]["k"] = torch.zeros(shape)
        with pytest.raises(ValueError, match=match):
            pool.validate_prefill(bad, 8)
    bad = ok()
    del bad["g0"]["sub0"]["h"]
    with pytest.raises(ValueError, match=r"structure diverges.*g0/sub0/h"):
        pool.validate_prefill(bad, 8)
    with pytest.raises(ValueError, match=r"g0/sub0/h.*anchor"):
        pool.assemble_prefix(dec, pool.arenas, torch.zeros((1,), dtype=torch.long), {})
    # staging caches may run past the prefix
    staged = ok()
    staged["g0"]["sub0"]["k"] = torch.zeros((2, 1, 16, 2, 8))
    pool.validate_prefill(staged, 8, staging=True)


def test_pool_validate_names_the_bad_smoke_leaf():
    """On tinyllama-smoke caches: a leaf one token short, rank-collapsed or
    with a halved head dim raises with its path before any arena write."""
    _, _, prompt, jpf = _reference_prefill()
    s = prompt.shape[1]
    cfg = configs.get_smoke(ARCH)
    dec = build_model(cfg, device="cpu").init_cache(1, 32)
    pf = _port_tree_like(dec, _bridge_tree(jpf))
    pool = PagedKVPool(8, 8)
    pool.bind(dec, max_len=32)
    pool.validate_prefill(pf, s)
    target = "0/sub0/k"

    def mangle(fn):
        return map_with_path(lambda p, v: fn(v) if p == target else v, pf)
    with pytest.raises(ValueError, match=r"0/sub0/k.*time extent"):
        pool.validate_prefill(mangle(lambda v: v[:, :, : s - 1]), s)
    with pytest.raises(ValueError, match=r"0/sub0/k.*rank"):
        pool.validate_prefill(mangle(lambda v: v[..., 0]), s)
    with pytest.raises(ValueError, match=r"0/sub0/k"):
        pool.validate_prefill(mangle(lambda v: v[..., : v.shape[-1] // 2]), s)
    assert all(not bool(a.any()) for a in pool.arenas.values() if a.dtype != torch.int32)


# ---------------------------------------------------------------------------
# Paged decode: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _paged_case(rng, *, b=3, h=4, kvh=2, n=24, bs=8, nb=4, d=16, lens=(25, 8, 0)):
    """The reference's ragged operands (`tests/test_kv_pool.py:385`): a
    partial last block, a block-exact lane and an empty lane, on permuted
    arena rows."""
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((n, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((n, bs, kvh, d)).astype(np.float32)
    perm = rng.permutation(n)
    bt = np.full((b, nb), -1, np.int32)
    pos = np.full((n, bs), -1, np.int32)
    for i, L in enumerate(lens):
        for j in range((L + bs - 1) // bs):
            bid = int(perm[i * nb + j])
            bt[i, j] = bid
            valid = min(bs, L - j * bs)
            pos[bid, :valid] = np.arange(j * bs, j * bs + valid)
    cur = np.maximum(np.asarray(lens, np.int32) - 1, 0)
    return q, k, v, pos, bt, cur


@pytest.mark.parametrize("lens", [(25, 8, 0), (30, 21, 5), (16, 0, 0)],
                         ids=["ragged", "ring", "empty_lanes"])
@pytest.mark.parametrize("window", [None, 9, 4, 8, 32])
def test_paged_plain_matches_pallas(lens, window):
    args = _paged_case(np.random.default_rng(0), lens=lens)
    want = np.asarray(jdec.paged_decode_attention(*map(jnp.asarray, args), window=window))
    got = paged_decode_attention(*map(torch.from_numpy, args), window=window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ref = paged_decode_attention_ref(*map(torch.from_numpy, args), window=window).numpy()
    np.testing.assert_array_equal(got, ref)
    assert native.launch_counts()["paged_decode_attention"] == 0


def test_paged_plain_is_the_gathered_monolithic_decode():
    """The gather is a pure relayout: the plain paged decode equals the plain
    monolithic decode on the gathered pages bit for bit, for any `bk` (which
    the plain version ignores); the gathered operands equal the
    reference's."""
    q, k, v, pos, bt, cur = map(torch.from_numpy,
                                _paged_case(np.random.default_rng(1), lens=(30, 21, 5)))
    kg, vg, pg = gather_pages(k, bt), gather_pages(v, bt), gathered_positions(pos, bt)
    np.testing.assert_array_equal(kg.numpy(), np.asarray(jdec.gather_pages(
        jnp.asarray(k.numpy()), jnp.asarray(bt.numpy()))))
    jpos = jnp.where(jnp.repeat(jnp.asarray(bt.numpy()) >= 0, 8, axis=1),
                     jdec.gather_pages(jnp.asarray(pos.numpy()), jnp.asarray(bt.numpy())), -1)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jpos))
    for window in (None, 9):
        paged = paged_decode_attention(q, k, v, pos, bt, cur, window=window)
        for bk in (None, 8, 16, 64):
            mono = decode_attention(q, kg, vg, pg, cur, window=window, bk=bk)
            assert torch.equal(paged, mono), (window, bk)
        assert torch.equal(paged, decode_attention_ref(q, kg, vg, pg, cur, window=window))


def test_paged_reads_a_layer_slice_in_place():
    """A layer's slice `arena[:, l]` of a stacked (N, stack, bs, KV, d)
    arena gives what the same slice copied out gives."""
    rng = np.random.default_rng(4)
    q, k, v, pos, bt, cur = map(torch.from_numpy, _paged_case(rng))
    stack_k = torch.stack([torch.randn_like(k), k, torch.randn_like(k)], dim=1)
    stack_v = torch.stack([v, torch.randn_like(v), v], dim=1)
    stack_p = torch.stack([pos, pos, pos], dim=1)
    got = paged_decode_attention(q, stack_k[:, 1], stack_v[:, 1], stack_p[:, 1], bt, cur)
    assert torch.equal(got, paged_decode_attention(q, k, stack_v[:, 1].contiguous(), pos,
                                                   bt, cur))


@pytest.mark.parametrize("case", ["q_rank", "kv_mismatch", "pos_shape", "tables_batch",
                                  "tables_dtype", "pos_dtype", "q_fp16", "window_0",
                                  "meta_device", "device_mismatch"])
def test_paged_wrapper_refuses_bad_operands(case):
    q, k, v, pos, bt, cur = map(torch.from_numpy, _paged_case(np.random.default_rng(5)))
    window = None
    if case == "q_rank":
        q = q[None]
    elif case == "kv_mismatch":
        v = v[:, :4]
    elif case == "pos_shape":
        pos = pos[:, :4]
    elif case == "tables_batch":
        bt = bt[:2]
    elif case == "tables_dtype":
        bt = bt.long()
    elif case == "pos_dtype":
        pos = pos.long()
    elif case == "q_fp16":
        # fp16 is on the surface since the fp16 decode kernel; an fp16 q
        # against fp32 arenas is not
        q = q.half()
    elif case == "window_0":
        window = 0
    elif case == "meta_device":
        q, k, v, pos, bt, cur = (t.to("meta") for t in (q, k, v, pos, bt, cur))
    elif case == "device_mismatch":
        cur = cur.to("meta")
    with pytest.raises((ValueError, TypeError)):
        paged_decode_attention(q, k, v, pos, bt, cur, window=window)


def test_decode_bk_is_ignored_by_the_plain_version():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.normal(size=(2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 40, 2, 16)).astype(np.float32))
    pos = torch.arange(40, dtype=torch.int32)[None].repeat(2, 1)
    cur = torch.tensor([39, 20], dtype=torch.int32)
    base = decode_attention(q, k, v, pos, cur)
    for bk in (8, 16, 32, 64, 24):
        assert torch.equal(decode_attention(q, k, v, pos, cur, bk=bk), base)


# ---------------------------------------------------------------------------
# On the card: the paged kernel against its plain version and decode(bk=bs)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 5])
def test_cuda_paged_kernel_matches_plain_and_decode_bk(window, cuda_device):
    from repro_torch.kernels import registry

    spec = registry.get("paged_decode_attention")
    names = ("q", "k_arena", "v_arena", "pos_arena", "block_tables", "current")
    rng = np.random.default_rng(0)
    for dt in spec.dtypes:
        for case in spec.cases:
            i = spec.make_inputs(case, dt, rng, cuda_device)
            before = native.launch_counts()["paged_decode_attention"]
            got = paged_decode_attention(*(i[k] for k in names), window=window)
            torch.cuda.synchronize()
            assert native.launch_counts()["paged_decode_attention"] == before + 1
            want = paged_decode_attention_ref(*(i[k] for k in names), window=window)
            rtol, atol = spec.tol(dt)
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
            t = i["block_tables"]
            mono = decode_attention(i["q"], gather_pages(i["k_arena"], t),
                                    gather_pages(i["v_arena"], t),
                                    gathered_positions(i["pos_arena"], t), i["current"],
                                    window=window, bk=i["k_arena"].shape[1])
            assert torch.equal(got, mono), (case.name, dt)


@pytest.mark.cuda
def test_cuda_paged_kernel_reads_a_stacked_arena_slice(cuda_device):
    q, k, v, pos, bt, cur = (torch.from_numpy(x).to(cuda_device) for x in
                             _paged_case(np.random.default_rng(7), lens=(30, 21, 5)))
    stack_k = torch.stack([torch.randn_like(k), k], dim=1)
    stack_v = torch.stack([torch.randn_like(v), v], dim=1)
    stack_p = torch.stack([pos, pos], dim=1)
    got = paged_decode_attention(q, stack_k[:, 1], stack_v[:, 1], stack_p[:, 1], bt, cur)
    assert torch.equal(got, paged_decode_attention(q, k, v, pos, bt, cur))


@pytest.mark.cuda
def test_cuda_decode_refuses_unsupported_chunks(cuda_device):
    q = torch.zeros(1, 2, 16, device=cuda_device)
    k = torch.zeros(1, 24, 1, 16, device=cuda_device)
    pos = torch.zeros(1, 24, dtype=torch.int32, device=cuda_device)
    cur = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for bk in (8, 16, 64):
        decode_attention(q, k, k, pos, cur, bk=bk)
    for bk in (24, 32):
        with pytest.raises(ValueError, match="chunk"):
            decode_attention(q, k, k, pos, cur, bk=bk)
