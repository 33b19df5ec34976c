"""Continuous-batching request scheduler on the port's `ExecutionStream`.

After `src/repro/launch/scheduler.py`: `Request` / `RequestResult` (:82,
:100), prompt-length buckets (:109, :120), `merge_prefill_caches` (:136),
lane admission and reset (:167-239), `TokenSampler` (:246-270),
`_ChunkedPrefill` and `_Slot` (:277-313), `_SchedulerBase` (:315),
`SequentialSchedule` (:454), `ContinuousSchedule` (:497) with its prefix
tier (the paged pool of `launch/kv_pool.py`: construction :508-559,
`_re_prefill_cost` :561, the bind :579-593, `_prefix_hit_admit` :596,
`_pool_cold_insert` :630, the release of a finished lane's page table,
`stats()["prefix_cache"]` :890) and its chunked prefill (:663-737 and the
chunk branches of `_admit` and `run`), `SLOSchedule` (:905-1178), and the
typed construction API `SLOConfig` / `SpecConfig` / `PrefixConfig` /
`ChunkConfig` / `ServeConfig` / `build_scheduler` (:1199-1340), with the
encoder-decoder's per-request frames (`Request.frames`, `_prefill_batch`
:382, the bucket refusal of `_check` :416). The speculative schedule
(`launch/speculative.py`) builds on `ContinuousSchedule` and registers
itself in `SCHEDULES` as "spec". Not ported yet: mesh placement and ring
prefill (multi-device), and the deprecated `make_scheduler` shim.

Sampling is greedy (first-index argmax over the true vocab) or seeded
categorical: the token at absolute position p of request r is drawn with
the key fold_in(fold_in(seed_key(seed), r), p) of `core.prng`, jax's
threefry chain in torch, so a request's stream is the reference's under any
schedule or batch composition. Every pick runs on the device that holds
the logits, and only the picks are copied out, through the one function
`TokenSampler.draw` that the SLO and speculative programs also run inside
their graphs: the draws of one run come from the same code on the same
device (float32 `log` differs by about an ulp between devices and builds).

Every model dispatch and every lane write goes through `self.stream` under
the reference's keys — program keys from the `ProgramCache`, and
"admit_slot", "reset_slot", "merge_prefill", "prefix_admit", "pool_insert"
— so dispatch counts and program misses compare one for one with the
reference. Lane and arena writes update the resident decode cache and the
pool's arenas in place: the reference's programs donate them. On the card
the prefill, decode, chunk and SLO step programs replay as CUDA graphs
(`core.dispatch.GraphProgram`); the lane writes run eagerly, a few launches
an admission, as the reference jits them beside its cache. A chunked
prefill stages its lane in a row of one staging cache allocated once per
schedule (the reference allocates one an admission), so the chunk program
binds the same storage whichever lane prefills: one capture per chunk width.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costmodel, prng
from repro_torch.core.dispatch import AsyncExecutionStream, ExecutionStream, ProgramCache
from repro_torch.launch.kv_pool import TIME_MERGE_LEAVES, PagedKVPool
from repro_torch.tree import map_with_path, tree_map

# the prefix pool's knobs: slot admission only (sequential drops them)
PREFIX_KNOBS = ("prefix_cache", "prefix_blocks", "prefix_block_size")


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget."""

    rid: int
    prompt: np.ndarray            # (L,) int32 token ids, L >= 1
    max_new_tokens: int
    arrival: int = 0              # scheduler step at which the request exists
    frames: np.ndarray | None = None   # encdec only: cfg.frame_shape

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: np.ndarray            # (max_new_tokens,) generated ids
    bucket: int                   # prefill bucket used (0 = decode-only)
    admitted_step: int
    finished_step: int


def default_buckets(max_prompt_len: int) -> tuple[int, ...]:
    """Powers of two from 8 up to the longest prompt."""
    out = []
    b = 8
    while b <= max_prompt_len:
        out.append(b)
        b *= 2
    return tuple(out) or (max(1, max_prompt_len),)


def bucket_for(prompt_len: int, buckets: Iterable[int]) -> int:
    """Largest bucket <= prompt_len; 0 when every bucket is longer (the
    request then catches up entirely through decode)."""
    fits = [b for b in buckets if b <= prompt_len]
    return max(fits) if fits else 0


# ---------------------------------------------------------------------------
# Prefill-cache -> decode-buffer writes (in place)
# ---------------------------------------------------------------------------


def _leaf_name(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def _time_slice(ndim: int, axis: int, n: int) -> tuple:
    index = [slice(None)] * ndim
    index[axis] = slice(0, n)
    return tuple(index)


def merge_prefill_caches(dec_caches: Any, pf_caches: Any) -> Any:
    """Copy prefill cache contents into the (longer time axis) decode
    buffers, whole batch, at time offset 0. Only a KV-time leaf may differ
    from its buffer, on one axis; anything else raises with the tree path."""
    def merge(path, dst, src):
        if dst.ndim != src.ndim:
            raise ValueError(f"cache leaf {path!r}: prefill rank {src.ndim} "
                             f"{tuple(src.shape)} != decode buffer rank {dst.ndim} "
                             f"{tuple(dst.shape)}; prefill state would be dropped")
        diff = [i for i in range(dst.ndim) if dst.shape[i] != src.shape[i]]
        if not diff:
            dst.copy_(src)
        elif (len(diff) == 1 and _leaf_name(path) in TIME_MERGE_LEAVES
                and src.shape[diff[0]] <= dst.shape[diff[0]]):
            dst[_time_slice(dst.ndim, diff[0], src.shape[diff[0]])] = src
        else:
            raise ValueError(
                f"cache leaf {path!r}: cannot merge prefill {tuple(src.shape)} into "
                f"decode buffer {tuple(dst.shape)} (mismatched axes {diff}; only the "
                f"named time axis of {sorted(TIME_MERGE_LEAVES)} may differ)")
        return dst
    return map_with_path(merge, dec_caches, pf_caches)


def _admit_leaf(path: str, dst: torch.Tensor, src: torch.Tensor, slot: int):
    """Write batch-1 prefill leaf `src` into decode lane `slot` of `dst`
    (stacked trees: layer axis 0, batch axis 1). `pos` lanes are reset to -1
    first, so stale entries of the lane's previous occupant never pass the
    validity mask."""
    if dst.ndim != src.ndim:
        raise ValueError(f"cache leaf {path!r}: prefill rank {src.ndim} != decode "
                         f"buffer rank {dst.ndim}")
    if src.shape[1] != 1:
        raise ValueError(f"cache leaf {path!r}: admission wants a batch-1 "
                         f"prefill cache, got batch {src.shape[1]}")
    diff = [i for i in range(dst.ndim) if i != 1 and dst.shape[i] != src.shape[i]]
    lane = dst[:, slot]                           # (stack, ...) view
    row = src[:, 0]
    if not diff:                                  # full-lane overwrite
        lane.copy_(row)
    elif (len(diff) == 1 and _leaf_name(path) in TIME_MERGE_LEAVES
            and src.shape[diff[0]] <= dst.shape[diff[0]]):
        if _leaf_name(path) == "pos":             # invalidate the stale tail
            lane.fill_(-1)
        lane[_time_slice(lane.ndim, diff[0] - 1, src.shape[diff[0]])] = row
    else:
        raise ValueError(f"cache leaf {path!r}: cannot admit prefill "
                         f"{tuple(src.shape)} into decode buffer {tuple(dst.shape)} "
                         f"(mismatched axes {diff})")
    return dst


def admit_into_slot(dec_caches: Any, pf_caches: Any, slot: int) -> Any:
    """One on-stream dispatch per admission: write a batch-1 prefill cache
    into lane `slot` of the resident decode cache."""
    return map_with_path(lambda p, d, s: _admit_leaf(p, d, s, slot),
                         dec_caches, pf_caches)


def reset_slot(dec_caches: Any, slot: int) -> Any:
    """Clear lane `slot` for a decode-only admission: `pos` to -1 (nothing
    valid), any leaf without a named time axis to zeros (the init_cache
    state); the KV payload is left as is (masked by pos)."""
    def reset(path, dst):
        name = _leaf_name(path)
        if name == "pos":
            dst[:, slot] = -1
        elif name not in TIME_MERGE_LEAVES:
            dst[:, slot] = 0
        return dst
    return map_with_path(reset, dec_caches)




# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

SAMPLING_MODES = ("greedy", "categorical")


class TokenSampler:
    """Per-request deterministic sampling: greedy is the first-index argmax
    of the fp32 row over the true vocab; categorical draws with the key
    fold_in(fold_in(seed_key(seed), rid), position) of the token's absolute
    position, so a request's stream is the same under any schedule or batch
    composition (reference :249)."""

    def __init__(self, mode: str, vocab: int, seed: int = 0, *,
                 device: str | torch.device = "cpu") -> None:
        if mode not in SAMPLING_MODES:
            raise ValueError(f"sampling mode {mode!r} not in {SAMPLING_MODES}")
        self.mode = mode
        self.vocab = vocab
        self.seed = seed
        # the root key on every device that draws, made outside any capture
        self._roots: dict[torch.device, torch.Tensor] = {}
        self.root(torch.device(device))

    def root(self, device: torch.device) -> torch.Tensor:
        """The root key on `device` ("cuda" and "cuda:0" are one device)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._roots:
            self._roots[device] = prng.seed_key(self.seed, device)
        return self._roots[device]

    def draw(self, rows: torch.Tensor, rids: torch.Tensor | None,
             positions: torch.Tensor | None) -> torch.Tensor:
        """(B, V') logits rows -> (B,) int64 picks on the rows' device, with
        no host sync: the draw the SLO and speculative programs run inside
        their graphs. `rids` and `positions` are (B,) tensors on that device
        (greedy reads neither)."""
        lg = rows[..., :self.vocab].float()
        if self.mode == "greedy":
            return torch.argmax(lg, dim=-1)
        keys = prng.request_keys(self.root(lg.device), rids, positions)
        return prng.categorical(keys, lg)

    def pick(self, rows, rids, positions) -> np.ndarray:
        """(B, V') rows (a tensor on any device, or an array) -> the host's
        (B,) picks: `draw` where the rows lie, then only the picks are
        copied out."""
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.asarray(rows, np.float32))
        if self.mode == "greedy":
            return self.draw(rows, None, None).cpu().numpy()
        dev = rows.device
        return self.draw(rows, torch.as_tensor(np.asarray(rids, np.int64), device=dev),
                         torch.as_tensor(np.asarray(positions, np.int64), device=dev)
                         ).cpu().numpy()

    def __call__(self, logits_row, rid: int, position: int) -> int:
        """One row's pick: the token at `position` of request `rid`."""
        return int(self.pick(logits_row[None], [rid], [position])[0])


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ChunkedPrefill:
    """In-flight chunked prefill of one lane: its row of the staging cache
    accumulates the chunk writes; the [0, target) progress."""

    done: int = 0
    target: int = 0


@dataclasses.dataclass
class _Slot:
    """One decode lane's host-side state machine."""

    req: Request | None = None
    next_pos: int = 0             # absolute position the next decode writes
    next_tok: int = 0             # token consumed by the next decode step
    generated: list[int] = dataclasses.field(default_factory=list)
    bucket: int = 0
    admitted_step: int = 0
    pending: _ChunkedPrefill | None = None

    @property
    def active(self) -> bool:
        return self.req is not None

    @property
    def prefilling(self) -> bool:
        """Mid chunked prefill: the lane holds the request but does not
        decode yet; its chunks still write the staging cache."""
        return self.pending is not None

    @property
    def generating(self) -> bool:
        """Past the prompt: the next decode step's logits are sampled."""
        return self.active and not self.prefilling \
            and self.next_pos >= self.req.prompt.size


class _SchedulerBase:
    """Shared machinery: bucketed prefill programs, admission, floor stats."""

    def __init__(self, model, params, cfg, *, max_len: int,
                 buckets: tuple[int, ...] | None = None,
                 sampling: str = "greedy", seed: int = 0,
                 program_cache: ProgramCache | None = None,
                 stream: ExecutionStream | None = None) -> None:
        self.model = model
        self.cfg = cfg
        self.max_len = max_len
        self.buckets = tuple(sorted(buckets)) if buckets else default_buckets(max_len)
        self.stream = stream or ExecutionStream(program_cache, device=model.device)
        self.cache = program_cache or self.stream.cache
        self.sampler = TokenSampler(sampling, cfg.vocab, seed, device=model.device)
        self.params = params
        self.device = model.device
        self._decode_memo: dict = {}

    # -- programs -----------------------------------------------------------
    def _tokens(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array, np.int32), device=self.device)

    def _prefill_batch(self, tokens: np.ndarray, frames: np.ndarray | None) -> dict:
        """The prefill program's batch: the token ids and, for an
        encoder-decoder, the request's frames in the model's dtype."""
        batch = {"tokens": self._tokens(tokens)}
        if self.cfg.family == "encdec":
            if frames is None:
                raise ValueError("encdec serving needs per-request frames")
            batch["frames"] = torch.as_tensor(np.asarray(frames)[None]).to(
                device=self.device, dtype=self.model.dtype)
        return batch

    def _prefill_program(self, batch: dict):
        """One program per bucket (the batch's shapes). Per call: the batch
        (token ids, an encoder-decoder's frames); resident: the params. Its
        caches are the graph's outputs on the card, overwritten by the next
        prefill of the bucket: admission copies them into the lane (and the
        pool's arenas) first."""
        return self.cache.compile(self.model.prefill, self.params, batch, per_call=(1,))

    def _decode_program(self, caches, tok, pos):
        """Compile-or-hit the decode program, memoized by the (token, pos)
        shapes: cache shapes are fixed per scheduler, so one graph serves
        every step. Per call: token and positions; resident: the params and
        the decode cache (written in place, as the reference donates it)."""
        sig = (tuple(tok.shape), str(tok.dtype), tuple(pos.shape), str(pos.dtype))
        hit = self._decode_memo.get(sig)
        if hit is None:
            hit = self.cache.compile(self.model.decode_step, self.params, caches,
                                     tok, pos, per_call=(2, 3))
            self._decode_memo[sig] = hit
        return hit

    def _check(self, req: Request) -> None:
        need = req.prompt.size + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(f"request {req.rid}: prompt {req.prompt.size} + gen "
                             f"{req.max_new_tokens} exceeds max_len {self.max_len}")
        if self.cfg.family == "encdec" and bucket_for(req.prompt.size, self.buckets) == 0:
            raise ValueError(
                f"request {req.rid}: encdec prompts must reach a prefill "
                f"bucket (cross-attention cache is built at prefill); "
                f"buckets={self.buckets}")

    # -- floor accounting ---------------------------------------------------
    def stats(self, n_requests: int) -> dict:
        recs = self.stream.records
        n = max(n_requests, 1)
        return {
            "n_dispatches": len(recs),
            "floor_s": self.stream.total_floor_s(),
            "work_s": self.stream.total_work_s(),
            "dispatch_wall_s": sum(r.wall_s for r in recs),
            "per_request_dispatch_overhead_s": self.stream.total_floor_s() / n,
            "per_request_dispatches": len(recs) / n,
        }


class SequentialSchedule(_SchedulerBase):
    """The parity reference: one request at a time, full-length prefill and
    a private batch-1 decode loop. The prefix pool rides slot admission, so
    its knobs are dropped here with a warning, as the reference's
    `make_scheduler` drops them (:1393)."""

    name = "sequential"

    def __init__(self, model, params, cfg, *, max_len: int, **kw) -> None:
        knobs = [k for k in PREFIX_KNOBS if kw.pop(k, None) not in (None, False)]
        if knobs:
            warnings.warn(f"SequentialSchedule: {knobs} do(es) not apply (the prefix "
                          "pool rides slot admission); dropped", UserWarning, stacklevel=2)
        super().__init__(model, params, cfg, max_len=max_len, **kw)

    def run(self, requests: list[Request]) -> list[RequestResult]:
        results = []
        for step, req in enumerate(sorted(requests, key=lambda r: (r.arrival, r.rid))):
            self._check(req)
            L = req.prompt.size
            batch = self._prefill_batch(req.prompt[None], req.frames)
            prefill, pkey = self._prefill_program(batch)
            self.stream.encode_operation(prefill, (self.params, batch), pkey, batch=1)
            pf_caches, logits = self.stream.execute_sync()[0]

            caches = self.model.init_cache(1, self.max_len)
            self.stream.encode_operation(merge_prefill_caches, (caches, pf_caches),
                                         "merge_prefill", batch=1)
            caches = self.stream.execute_sync()[0]
            tok = self.sampler(logits[0, -1], req.rid, L)
            generated = [tok]
            for i in range(req.max_new_tokens - 1):
                pos = L + i
                tokj = self._tokens([[tok]])
                posj = self._tokens([pos])
                decode, dkey = self._decode_program(caches, tokj, posj)
                self.stream.encode_operation(decode, (self.params, caches, tokj, posj),
                                             dkey, batch=1)
                caches, logits = self.stream.execute_sync()[0]
                tok = self.sampler(logits[0, -1], req.rid, pos + 1)
                generated.append(tok)
            results.append(RequestResult(req.rid, L, np.asarray(generated, np.int32),
                                         bucket=L, admitted_step=step,
                                         finished_step=step))
        return results


class ContinuousSchedule(_SchedulerBase):
    """Continuous batching: `n_slots` decode lanes in one resident cache,
    stepping together. A new request is admitted into a free lane mid-flight:
    prefill at the largest bucket <= its prompt (or, with `prefill_chunk`,
    as chunk programs, one a tick), catch the tail up through the shared
    decode program (teacher-forced prompt tokens), then generate. Every lane
    shares each decode dispatch."""

    name = "continuous"

    def __init__(self, model, params, cfg, *, n_slots: int, max_len: int,
                 prefix_cache: bool = False, prefix_blocks: int = 64,
                 prefix_block_size: int = 8, prefill_chunk: int | None = None,
                 **kw) -> None:
        # the reference's knobs (:509-559): an encoder-decoder refuses both
        # in the reference's words
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
            if cfg.family == "encdec":
                raise ValueError(
                    "chunked prefill cannot serve encdec: the cross-attention "
                    "cache is built by the monolithic prefill program, so a "
                    "decode-mode chunk has no frames to attend to")
        if prefix_cache and cfg.family == "encdec":
            raise ValueError(
                "prefix cache cannot serve encdec: the cross-attention "
                "cache is built from per-request frames, so token-hash "
                "block sharing would alias state across requests")
        super().__init__(model, params, cfg, max_len=max_len, **kw)
        if n_slots < 1:
            raise ValueError(f"continuous schedule needs n_slots >= 1, got {n_slots}")
        self.prefill_chunk = prefill_chunk
        self._chunk_memo: dict = {}
        self._chunk_keys: set[str] = set()
        self.n_slots = n_slots
        self.slots = [_Slot() for _ in range(n_slots)]
        self.caches = None        # allocated lazily on first run
        self.staging = None       # chunked prefill's lanes, allocated with them
        self.pool: PagedKVPool | None = None
        if prefix_cache:
            self.pool = PagedKVPool(prefix_blocks, prefix_block_size,
                                    evict_cost_fn=self._re_prefill_cost)

    def _re_prefill_cost(self, n_tokens: int) -> float:
        """Cost-model floor + work of re-prefilling an `n_tokens` resident
        prefix at batch 1, on the model's target (`hal.H100` by default)
        with the stream's measured floor: what evicting a block whose chain
        ends `n_tokens` deep would cost to rebuild. The pool evicts the
        cheapest refcount-0 candidate (`PagedKVPool._evict_victim`)."""
        shape = ShapeConfig("re_prefill", max(1, n_tokens), 1, "prefill")
        t = self.model.dispatcher.target
        flops = costmodel.model_flops(self.cfg, shape) \
            + costmodel.attention_flops(self.cfg, shape)
        work = max(flops / t.peak_flops,
                   costmodel.weight_bytes(self.cfg) / t.hbm_bandwidth)
        return self.stream.floor_s + work

    def _ensure_caches(self) -> None:
        if self.caches is None:
            self.caches = self.model.init_cache(self.n_slots, self.max_len)
        if self.prefill_chunk is not None and self.staging is None:
            self.staging = self.model.init_cache(self.n_slots, self.max_len)
        if self.pool is not None and self.pool.arenas is None:
            self.pool.bind(self.caches, max_len=self.max_len)

    # -- prefix-cache admission ---------------------------------------------
    def _prefix_admit(self, dec_caches, arenas, bids, anchor, slot: int):
        """The prefix-hit admission program: gather the chain's blocks into
        a batch-1 prefill-shaped tree and write it into lane `slot`."""
        pf = self.pool.assemble_prefix(dec_caches, arenas, bids, anchor)
        return admit_into_slot(dec_caches, pf, slot)

    def _prefix_hit_admit(self, req: Request, slot: _Slot, slot_idx: int,
                          bucket: int) -> bool:
        """Admit from resident blocks when the prompt's longest anchored
        resident prefix reaches at least the bucket a cold admission would
        prefill: ONE gather-and-write dispatch replaces the prefill and the
        lane write. The match is capped at L-1, so at least one prompt token
        is left to teacher-force the first decode step: positions M..L-1
        catch up through decode exactly as a bucket-M cold admission would,
        and the streams stay those of cold admissions."""
        pool = self.pool
        if pool is None or pool.arenas is None:
            return False
        L = req.prompt.size
        keys = pool.anchored_match(req.prompt, limit=L - 1)
        M = len(keys) * pool.block_size
        if not keys or M < max(bucket, 1):
            return False
        bids = torch.as_tensor(pool.bids_of(keys), dtype=torch.long, device=self.device)
        anchor = pool.anchor_of(keys[-1])
        self.stream.encode_operation(self._prefix_admit,
                                     (self.caches, pool.arenas, bids, anchor, slot_idx),
                                     "prefix_admit", batch=1)
        self.caches = self.stream.execute_sync()[0]
        pool.acquire(req.rid, keys)
        pool.stats["hits"] += 1
        pool.stats["hit_tokens"] += M
        slot.next_pos = M
        slot.next_tok = int(req.prompt[M])
        return True

    def _pool_cold_insert(self, req: Request, bucket: int, pf_caches,
                          staging: bool = False) -> None:
        """Cold-path residency: reserve arena rows for the prefilled whole
        blocks and write them with one more dispatch (floor-charged, the
        cost of caching); the chain end anchors the non-paged leaves, so a
        later admission resumes from exactly this boundary. A chunked
        admission passes its staging row (`staging=True`): decode-shaped,
        valid through `bucket`, a chunk boundary."""
        pool = self.pool
        pool.stats["misses"] += 1
        if bucket < pool.block_size:
            return
        keys, new_bids, first_new = pool.reserve(req.prompt[:bucket])
        if new_bids:
            pool.validate_prefill(pf_caches, bucket, staging=staging)
            bids = torch.as_tensor(new_bids, dtype=torch.long, device=self.device)
            self.stream.encode_operation(pool.insert_blocks,
                                         (pool.arenas, pf_caches, bids, first_new),
                                         "pool_insert", batch=1)
            pool.arenas = self.stream.execute_sync()[0]
        if keys:
            if len(keys) * pool.block_size == bucket:
                pool.set_anchor(keys[-1], pool.anchor_leaves(pf_caches))
            pool.acquire(req.rid, keys)

    def _release_lane(self, req: Request) -> None:
        if self.pool is not None:
            self.pool.release(req.rid)

    # -- chunked prefill ----------------------------------------------------
    def _chunk_step(self, params, staging, tok, pos0, lane):
        """The chunk program: lane `lane`'s row of the staging cache through
        `prefill_chunk`, written back in place. The lane is a per-call index
        tensor, so one graph serves every lane."""
        row = tree_map(lambda t: t.index_select(1, lane), staging)
        row, logits = self.model.prefill_chunk(params, row, tok, pos0)
        tree_map(lambda dst, src: dst.index_copy_(1, lane, src), staging, row)
        return staging, logits

    def _chunk_program(self, tok, pos0, lane):
        """Compile-or-hit the chunk program, memoized by the chunk width
        alone: the staging cache is decode-shaped whatever the prompt, so
        ONE program (one graph) serves every chunk of every prompt. Per
        call: tokens, start position and lane; resident: the params and the
        staging cache."""
        sig = (tuple(tok.shape), str(tok.dtype))
        hit = self._chunk_memo.get(sig)
        if hit is None:
            hit = self.cache.compile(self._chunk_step, self.params, self.staging, tok, pos0,
                                     lane, per_call=(2, 3, 4))
            self._chunk_keys.add(hit[1])
            self._chunk_memo[sig] = hit
        return hit

    def _staging_row(self, slot_idx: int):
        """Lane `slot_idx`'s batch-1 row of the staging cache (views)."""
        return tree_map(lambda t: t[:, slot_idx:slot_idx + 1], self.staging)

    def _begin_chunked(self, slot_idx: int, slot: _Slot, target: int) -> None:
        """Stage a chunked prefill: clear the lane's staging row (positions
        to -1, the state `init_cache` gives; no dispatch, as the reference
        allocates a fresh cache) and mark the lane pending. Chunks advance
        one a tick, so in-flight decode lanes get a window between every
        pair of chunks instead of stalling behind one monolithic prefill."""
        reset_slot(self.staging, slot_idx)
        slot.pending = _ChunkedPrefill(done=0, target=target)
        slot.next_pos = 0
        slot.next_tok = 0

    def _advance_chunk(self, slot_idx: int, step: int) -> None:
        """Dispatch ONE chunk of a pending lane: C prompt tokens forward in
        decode mode against its staging row, floor-charged on the stream
        (`span` records the token range). The last chunk hands over to
        `_finish_chunked`."""
        slot = self.slots[slot_idx]
        pend, req = slot.pending, slot.req
        c0 = pend.done
        n = min(self.prefill_chunk, pend.target - c0)
        tokj = self._tokens(req.prompt[None, c0:c0 + n])
        pos0 = self._tokens([c0])
        lane = torch.tensor([slot_idx], dtype=torch.long, device=self.device)
        compiled, ckey = self._chunk_program(tokj, pos0, lane)
        self.stream.encode_operation(compiled, (self.params, self.staging, tokj, pos0, lane),
                                     ckey, batch=1, span=(c0, c0 + n))
        self.staging, _ = self.stream.execute_sync()[0]
        pend.done = c0 + n
        if pend.done >= pend.target:
            self._finish_chunked(slot_idx)

    def _finish_chunked(self, slot_idx: int) -> None:
        """Admit the fully staged prefix into the lane: the staging row's
        time extent equals the lane's, so `admit_into_slot` overwrites every
        leaf of the lane (positions included), the path bucketed admissions
        take. The target is capped at L-1, so the first decode step is
        teacher-forced and no logits are needed."""
        slot = self.slots[slot_idx]
        pend, req = slot.pending, slot.req
        row = self._staging_row(slot_idx)
        if self.pool is not None:
            self._pool_cold_insert(req, pend.target, row, staging=True)
        self.stream.encode_operation(admit_into_slot, (self.caches, row, slot_idx),
                                     "admit_slot", batch=1)
        self.caches = self.stream.execute_sync()[0]
        slot.pending = None
        slot.next_pos = pend.target
        slot.next_tok = int(req.prompt[pend.target])

    # -- admission ----------------------------------------------------------
    def _admit(self, slot_idx: int, req: Request, step: int) -> None:
        """Prefill the bucket prefix through the stream, then write the
        prefill state into the lane (both dispatches on the stream). With
        `prefill_chunk` the prompt prefills as chunks instead, up to the
        largest chunk multiple <= L-1 (positions target..L-1 catch up
        teacher-forced through decode, as after a bucket-target admission)."""
        slot = self.slots[slot_idx]
        L = req.prompt.size
        C = self.prefill_chunk
        bucket = C * ((L - 1) // C) if C is not None else bucket_for(L, self.buckets)
        if self._prefix_hit_admit(req, slot, slot_idx, bucket):
            pass                  # admitted from resident blocks
        elif C is not None and bucket > 0:
            self._begin_chunked(slot_idx, slot, bucket)
        elif bucket == 0:
            self.stream.encode_operation(reset_slot, (self.caches, slot_idx),
                                         "reset_slot", batch=1)
            self.caches = self.stream.execute_sync()[0]
            if self.pool is not None:
                self.pool.stats["misses"] += 1
            slot.next_pos, slot.next_tok = 0, int(req.prompt[0])
        else:
            batch = self._prefill_batch(req.prompt[None, :bucket], req.frames)
            prefill, pkey = self._prefill_program(batch)
            self.stream.encode_operation(prefill, (self.params, batch), pkey, batch=1)
            pf_caches, logits = self.stream.execute_sync()[0]
            if self.pool is not None:
                self._pool_cold_insert(req, bucket, pf_caches)
            self.stream.encode_operation(admit_into_slot,
                                         (self.caches, pf_caches, slot_idx),
                                         "admit_slot", batch=1)
            self.caches = self.stream.execute_sync()[0]
            slot.next_pos = bucket
            if bucket < L:        # catch up through decode, teacher-forced
                slot.next_tok = int(req.prompt[bucket])
            else:                 # prompt fully prefilled: sample token L
                tok = self.sampler(logits[0, -1], req.rid, L)
                slot.generated.append(tok)
                slot.next_tok = tok
        slot.req = req
        slot.bucket = bucket
        slot.admitted_step = step

    def _finish(self, slot: _Slot, results: list[RequestResult], step: int) -> None:
        req = slot.req
        results.append(RequestResult(
            req.rid, req.prompt.size,
            np.asarray(slot.generated[:req.max_new_tokens], np.int32),
            bucket=slot.bucket, admitted_step=slot.admitted_step, finished_step=step))
        self._release_lane(req)
        slot.req = None
        slot.generated = []

    def _decoding(self) -> list[int]:
        """The lanes a decode step carries: active and past any chunking."""
        return [i for i, s in enumerate(self.slots) if s.active and not s.prefilling]

    def _sample_lanes(self, logits: torch.Tensor, lanes: list[int]) -> dict[int, int]:
        """The sampler's picks from a decode step's logits (B, 1, V), for
        those of `lanes` whose next position samples (the others are still
        teacher-forced): one draw over their rows, on the logits' device."""
        want = [i for i in lanes
                if self.slots[i].next_pos + 1 >= self.slots[i].req.prompt.size]
        if not want:
            return {}
        rows = logits[want, -1] if len(want) < logits.shape[0] else logits[:, -1]
        picks = self.sampler.pick(rows, [self.slots[i].req.rid for i in want],
                                  [self.slots[i].next_pos + 1 for i in want])
        return dict(zip(want, (int(t) for t in picks)))

    def _advance(self, slot: _Slot, tok: int | None,
                 results: list[RequestResult], step: int) -> None:
        """Consume one decode step for an active lane; `tok` is the
        sampler's pick for it (None while the lane is teacher-forced)."""
        req = slot.req
        nxt = slot.next_pos + 1
        slot.next_pos = nxt
        if nxt < req.prompt.size:            # still catching up: teacher-force
            slot.next_tok = int(req.prompt[nxt])
            return
        slot.generated.append(tok)
        slot.next_tok = tok
        if len(slot.generated) >= req.max_new_tokens:
            self._finish(slot, results, step)

    def _advance_chunks(self, step: int) -> None:
        """Pending lanes advance ONE chunk a tick, so a decode window runs
        between every pair of chunks instead of the whole prompt blocking
        the in-flight lanes at once."""
        for i, slot in enumerate(self.slots):
            if slot.prefilling:
                self._advance_chunk(i, step)

    def _finish_prefilled(self, results: list[RequestResult], step: int) -> None:
        for s in self.slots:
            if s.active and s.generating and len(s.generated) >= s.req.max_new_tokens:
                self._finish(s, results, step)

    # -- the serve loop -----------------------------------------------------
    def run(self, requests: list[Request]) -> list[RequestResult]:
        for r in requests:
            self._check(r)
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._ensure_caches()
        results: list[RequestResult] = []
        step = 0
        while queue or any(s.active for s in self.slots):
            # admissions: free lanes x arrived requests, in arrival order
            for i, slot in enumerate(self.slots):
                if not queue or queue[0].arrival > step:
                    break
                if not slot.active:
                    self._admit(i, queue.pop(0), step)
            self._advance_chunks(step)
            # a fully-prefilled request can finish without a decode step
            self._finish_prefilled(results, step)
            lanes = self._decoding()
            if not lanes:
                if queue or any(s.prefilling for s in self.slots):
                    step += 1     # idle tick: an arrival or a chunk still to come
                    continue
                break
            # one slot-masked decode dispatch for every lane
            tok = np.zeros((self.n_slots, 1), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            for i in lanes:
                tok[i, 0] = self.slots[i].next_tok
                pos[i] = self.slots[i].next_pos
            tokj, posj = self._tokens(tok), self._tokens(pos)
            decode, dkey = self._decode_program(self.caches, tokj, posj)
            self.stream.encode_operation(decode, (self.params, self.caches, tokj, posj),
                                         dkey, batch=len(lanes))
            self.caches, logits = self.stream.execute_sync()[0]
            picks = self._sample_lanes(logits, lanes)
            for i in lanes:
                self._advance(self.slots[i], picks.get(i), results, step)
            step += 1
        results.sort(key=lambda r: r.rid)
        return results

    def stats(self, n_requests: int) -> dict:
        out = super().stats(n_requests)
        if self.pool is not None:
            out["prefix_cache"] = dict(self.pool.stats)
            out["prefix_cache"]["free_blocks"] = self.pool.free_blocks()
        if self.prefill_chunk is not None:
            recs = self.stream.records
            out["chunked_prefill"] = {
                "prefill_chunk": self.prefill_chunk,
                "n_chunks": sum(1 for r in recs if r.key in self._chunk_keys),
                "chunk_tokens": sum(r.span[1] - r.span[0] for r in recs
                                    if r.span is not None),
            }
        return out


class SLOSchedule(ContinuousSchedule):
    """Overlapped continuous batching with SLO-aware admission (reference
    :905).

    The decode loop is software-pipelined on `AsyncExecutionStream`: the
    host plans a window of decode steps whose control flow is fully
    deterministic (teacher-forcing or sampling per lane follows positions,
    never logits), next-token selection runs inside the decode program (the
    first-index argmax, or the per-(rid, pos) categorical draw of
    `TokenSampler.draw`), and each step takes the previous step's token
    output as its input without the host reading it. Tokens reach the host
    once a window, at its sync. Windows end where host decisions live: a
    lane completing, a queued arrival that could claim a free lane, a
    pending chunk.

    A replay overwrites the graph's static outputs, so each step's samples
    are cloned on the device before the next step is submitted; the chained
    token is the next step's per-call input, copied into its graph before
    the replay, in stream order.

    Admission is gated on the cost model: a queued request is admitted into
    a free lane only while the predicted token latency `floor x window +
    per-token work` (work = p99 of recent decode-step walls, the floor until
    one is observed) stays under the SLO. An idle engine always admits.
    Deferred admissions are counted in `deferred_admissions`. Streams are
    token-exact against `ContinuousSchedule` whatever the SLO defers."""

    name = "slo"

    #: decode-wall samples retained for the p99 work predictor
    WALL_WINDOW = 64

    #: default in-flight window when this schedule builds its own stream
    MAX_IN_FLIGHT = 8

    def __init__(self, model, params, cfg, *, n_slots: int, max_len: int,
                 slo_ms: float | None = None, max_in_flight: int = MAX_IN_FLIGHT,
                 stream: ExecutionStream | None = None,
                 program_cache: ProgramCache | None = None, **kw) -> None:
        if stream is None:
            stream = AsyncExecutionStream(program_cache, device=model.device,
                                          max_in_flight=max_in_flight)
        if not isinstance(stream, AsyncExecutionStream):
            raise ValueError(
                "SLOSchedule pipelines decode through AsyncExecutionStream; "
                f"got {type(stream).__name__} (a sync stream would serialize "
                "the window and the floor accounting would not reflect overlap)")
        super().__init__(model, params, cfg, n_slots=n_slots, max_len=max_len,
                         stream=stream, program_cache=program_cache, **kw)
        self.slo_s = None if slo_ms is None else float(slo_ms) * 1e-3
        self.deferred_admissions = 0
        self._step_memo: dict = {}
        self._decode_keys: set[str] = set()
        self._decode_walls: deque[float] = deque(maxlen=self.WALL_WINDOW)
        self._records_seen = 0

    # -- fused decode + on-device sampling ----------------------------------
    def _fused_step(self, params, caches, tok, pos, forced, do_sample, rids):
        """decode_step and next-token selection in one program: the
        sampler's pick at position pos + 1 where the lane samples, the
        forced prompt token elsewhere. Returns (caches, the next step's
        tokens (B, 1), the picks (B,))."""
        caches, logits = self.model.decode_step(params, caches, tok, pos)
        samp = self.sampler.draw(logits[:, -1], rids, pos + 1).to(torch.int32)
        nxt = torch.where(do_sample, samp, forced).to(torch.int32)
        return caches, nxt[:, None], samp

    def _fused_step_program(self, caches, tok, pos, forced, do_sample, rids):
        """Compile-or-hit the pipelined step, memoized by its shapes. Per
        call: token, positions, forced tokens, the sampling mask and the
        rids; resident: the params and the decode cache."""
        sig = (tuple(tok.shape), str(tok.dtype), tuple(pos.shape))
        hit = self._step_memo.get(sig)
        if hit is None:
            hit = self.cache.compile(self._fused_step, self.params, caches, tok, pos, forced,
                                     do_sample, rids, per_call=(2, 3, 4, 5, 6))
            self._decode_keys.add(hit[1])
            self._step_memo[sig] = hit
        return hit

    # -- the SLO admission gate ---------------------------------------------
    def _observe_decode_walls(self) -> None:
        """Fold any new decode-step records into the work predictor."""
        recs = self.stream.records
        for r in recs[self._records_seen:]:
            if r.key in self._decode_keys:
                self._decode_walls.append(r.wall_s)
        self._records_seen = len(recs)

    def predicted_token_latency_s(self) -> float:
        """Predicted p99 token latency were one more request admitted now:
        the floor once per submission that can sit in flight ahead of a
        step (the window bound: the gate runs at drained barriers), plus the
        per-token work, the p99 of recent decode-step walls (the floor
        before any was observed)."""
        if self._decode_walls:
            walls = sorted(self._decode_walls)
            work = walls[min(len(walls) - 1, int(0.99 * len(walls)))]
        else:
            work = self.stream.floor_s
        return self.stream.floor_s * self.stream.max_in_flight + work

    def _admission_clear(self) -> bool:
        if self.slo_s is None:
            return True
        if not any(s.active for s in self.slots) and self.stream.in_flight_depth == 0:
            return True           # idle engine: deferring would starve
        return self.predicted_token_latency_s() <= self.slo_s

    # -- the pipelined serve loop -------------------------------------------
    def _window_horizon(self, step: int, queue: list[Request]) -> int:
        """Decode steps encodable ahead without a host decision: up to the
        first lane completion, never past the step at which a queued
        arrival could claim a free lane, never deeper than the in-flight
        window, and one step while a lane is chunking (its next chunk
        bounds the window)."""
        remain = []
        for s in self.slots:
            if not s.active or s.prefilling:
                continue
            forced_left = max(0, s.req.prompt.size - 1 - s.next_pos)
            remain.append(forced_left + s.req.max_new_tokens - len(s.generated))
        k = min(remain + [self.stream.max_in_flight])
        if queue and any(not s.active for s in self.slots):
            k = min(k, max(1, queue[0].arrival - step))
        if any(s.prefilling for s in self.slots):
            k = 1
        return k

    def _submit(self):
        """Submit the one encoded program; a program that raised on the
        host has no outputs, and `sync` re-raises its error."""
        out = self.stream.submit()[0]
        if out is None:
            self.stream.sync()
        return out

    def _pipelined_window(self, step: int, queue: list[Request],
                          results: list[RequestResult]) -> int:
        """Encode and submit `k` chained decode steps, then sync once and
        fold the tokens back into the lanes' state machines."""
        k = self._window_horizon(step, queue)
        n = self.n_slots
        lanes = self._decoding()
        # the whole window's inputs are planned on the host and copied to
        # the device at once: a copy from pageable memory waits for the
        # device, so one a step would drain the window at every step. Rows:
        # first token, rids, then each step's positions, forced tokens and
        # sampling mask
        host = np.zeros((2 + 3 * k, n), np.int32)
        for i in lanes:
            host[0, i] = self.slots[i].next_tok
            host[1, i] = self.slots[i].req.rid
        sampled_by_step: list[list[int]] = []
        for t in range(k):
            sampled: list[int] = []
            for i in lanes:
                s = self.slots[i]
                host[2 + 3 * t, i] = s.next_pos
                nxt = s.next_pos + 1
                if nxt < s.req.prompt.size:   # catch-up: teacher-force
                    host[3 + 3 * t, i] = int(s.req.prompt[nxt])
                else:
                    host[4 + 3 * t, i] = 1
                    sampled.append(i)
                s.next_pos = nxt
            sampled_by_step.append(sampled)
        plan_dev = self._tokens(host)
        tok_dev = plan_dev[0][:, None]    # then each step's output, on the device
        ridsj = plan_dev[1]
        plan: list[tuple[torch.Tensor, list[int]]] = []
        for t, sampled in enumerate(sampled_by_step):
            posj, forcedj = plan_dev[2 + 3 * t], plan_dev[3 + 3 * t]
            maskj = plan_dev[4 + 3 * t] != 0
            compiled, dkey = self._fused_step_program(self.caches, tok_dev, posj, forcedj,
                                                      maskj, ridsj)
            self.stream.encode_operation(
                compiled, (self.params, self.caches, tok_dev, posj, forcedj, maskj, ridsj),
                dkey, batch=len(lanes))
            self.caches, tok_dev, samp = self._submit()
            # the next replay overwrites `samp`: keep this step's on the device
            plan.append((samp.clone(), sampled))
        self.stream.sync()
        self._observe_decode_walls()
        nxt_host = tok_dev.cpu().numpy()[:, 0]
        for t, (samp, sampled) in enumerate(plan):
            samp_np = samp.cpu().numpy() if sampled else None
            for i in sampled:
                s = self.slots[i]
                s.generated.append(int(samp_np[i]))
                if len(s.generated) >= s.req.max_new_tokens:
                    self._finish(s, results, step + t)
        for i in lanes:
            if self.slots[i].active:
                self.slots[i].next_tok = int(nxt_host[i])
        return step + k

    def run(self, requests: list[Request]) -> list[RequestResult]:
        for r in requests:
            self._check(r)
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._ensure_caches()
        results: list[RequestResult] = []
        step = 0
        while queue or any(s.active for s in self.slots):
            # admissions at a drained barrier; the gate reads the ledger
            for i, slot in enumerate(self.slots):
                if not queue or queue[0].arrival > step:
                    break
                if slot.active:
                    continue
                if not self._admission_clear():
                    self.deferred_admissions += 1
                    break
                self._admit(i, queue.pop(0), step)
            # one chunk of every pending lane at this barrier: the gate and
            # the window both see each chunk as an ordinary dispatch
            self._advance_chunks(step)
            # a fully-prefilled request can finish without a decode step
            self._finish_prefilled(results, step)
            if not any(s.active for s in self.slots):
                if queue:
                    step += 1     # idle tick: wait for the next arrival
                    continue
                break
            if not self._decoding():
                step += 1         # only mid-chunk lanes: nothing to decode
                continue
            step = self._pipelined_window(step, queue, results)
        results.sort(key=lambda r: r.rid)
        return results

    def stats(self, n_requests: int) -> dict:
        out = super().stats(n_requests)
        recs = self.stream.records
        out.update({
            "deferred_admissions": self.deferred_admissions,
            "max_in_flight": self.stream.max_in_flight,
            "mean_inflight_depth": float(np.mean([r.inflight_depth for r in recs]))
            if recs else 0.0,
            "predicted_token_latency_s": self.predicted_token_latency_s(),
        })
        return out


SCHEDULES = {
    ContinuousSchedule.name: ContinuousSchedule,
    SequentialSchedule.name: SequentialSchedule,
    SLOSchedule.name: SLOSchedule,
    # "spec" (SpeculativeSchedule) registers itself from launch.speculative
}


# ---------------------------------------------------------------------------
# Typed serve configuration (reference :1199-1340)
# ---------------------------------------------------------------------------
# One dataclass per schedule-specific knob group, attached as a section; a
# section on a schedule it does not apply to is a ValueError at validate().


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """`slo` schedule knobs: the admission gate's target and the in-flight
    window."""
    slo_ms: float | None = None
    max_in_flight: int = SLOSchedule.MAX_IN_FLIGHT


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """`spec` schedule knobs: the drafter (`draft_ckpt`: a shrink drafter's
    checkpoint directory) and the window depth."""
    draft_depth: int = 4
    draft: str = "shrink"
    draft_ckpt: str | None = None
    draft_branches: int = 1
    drafter: Any = None           # a prebuilt Drafter overrides `draft`
    max_in_flight: int = 2


@dataclasses.dataclass(frozen=True)
class PrefixConfig:
    """The paged KV prefix pool (continuous / slo): the section's presence
    enables it."""
    blocks: int = 64
    block_size: int = 8


@dataclasses.dataclass(frozen=True)
class ChunkConfig:
    """Chunked prefill (continuous / slo): a long prompt admits as chunk
    programs of `prefill_chunk` tokens, with decode windows between them.
    The reference's `ring_min` (ring-attention prefill) waits for the
    multi-device port."""
    prefill_chunk: int | None = None

    def __post_init__(self) -> None:
        if self.prefill_chunk is None:
            raise ValueError("ChunkConfig needs prefill_chunk; an empty section would "
                             "silently do nothing")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {self.prefill_chunk}")


#: which schedules each section applies to
_SECTION_SCHEDULES = {
    "slo": ("slo",),
    "spec": ("spec",),
    "prefix": ("continuous", "slo"),
    "chunk": ("continuous", "slo"),
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Typed serving configuration: the knobs every schedule shares, plus
    per-schedule sections. `validate()` rejects a section attached to a
    schedule it does not apply to; `build_scheduler` is the one
    construction path of `launch/serve.py`."""
    schedule: str
    max_len: int
    n_slots: int = 1
    sampling: str = "greedy"
    seed: int = 0
    buckets: tuple[int, ...] | None = None
    stream: ExecutionStream | None = None
    program_cache: ProgramCache | None = None
    slo: SLOConfig | None = None
    spec: SpecConfig | None = None
    prefix: PrefixConfig | None = None
    chunk: ChunkConfig | None = None

    def validate(self) -> "ServeConfig":
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule {self.schedule!r} not in {sorted(SCHEDULES)}")
        for name, applies in _SECTION_SCHEDULES.items():
            if getattr(self, name) is not None and self.schedule not in applies:
                raise ValueError(
                    f"ServeConfig.{name} does not apply to the {self.schedule!r} "
                    f"schedule (only {applies}); drop the section instead of "
                    f"expecting it to be ignored")
        if self.chunk is not None and self.prefix is not None \
                and self.chunk.prefill_chunk % self.prefix.block_size != 0:
            raise ValueError(
                f"prefix.block_size ({self.prefix.block_size}) must divide "
                f"chunk.prefill_chunk ({self.chunk.prefill_chunk}): chunk targets are "
                f"chunk multiples, and a chain only anchors when whole blocks tile "
                f"the prefilled prefix exactly")
        return self

    def scheduler_kwargs(self) -> dict:
        """Flatten to the scheduler constructors' keywords."""
        kw: dict[str, Any] = dict(sampling=self.sampling, seed=self.seed,
                                  buckets=self.buckets, stream=self.stream,
                                  program_cache=self.program_cache)
        if self.slo is not None:
            kw.update(slo_ms=self.slo.slo_ms, max_in_flight=self.slo.max_in_flight)
        if self.spec is not None:
            sp = self.spec
            kw.update(draft_depth=sp.draft_depth, draft=sp.draft, draft_ckpt=sp.draft_ckpt,
                      draft_branches=sp.draft_branches, max_in_flight=sp.max_in_flight)
            if sp.drafter is not None:
                kw["drafter"] = sp.drafter
        if self.prefix is not None:
            kw.update(prefix_cache=True, prefix_blocks=self.prefix.blocks,
                      prefix_block_size=self.prefix.block_size)
        if self.chunk is not None:
            kw["prefill_chunk"] = self.chunk.prefill_chunk
        return kw


def build_scheduler(config: ServeConfig, model, params, cfg) -> _SchedulerBase:
    """Construct the scheduler a validated `ServeConfig` describes."""
    config.validate()
    kw = config.scheduler_kwargs()
    if config.schedule == "sequential":
        return SequentialSchedule(model, params, cfg, max_len=config.max_len, **kw)
    return SCHEDULES[config.schedule](model, params, cfg, n_slots=config.n_slots,
                                      max_len=config.max_len, **kw)


# registers SCHEDULES["spec"]; the bottom import keeps the cycle harmless
# (this module is fully defined by the time speculative imports it back)
from repro_torch.launch import speculative as _speculative  # noqa: E402,F401
