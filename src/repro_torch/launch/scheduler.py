"""Continuous-batching request scheduler on the port's `ExecutionStream`.

After `src/repro/launch/scheduler.py`: `Request` / `RequestResult` (:82,
:100), prompt-length buckets (:109, :120), `merge_prefill_caches` (:136),
lane admission and reset (:167-239), greedy `TokenSampler` (:249),
`_SchedulerBase` (:315), `SequentialSchedule` (:454) and `ContinuousSchedule`
(:497), with the encoder-decoder's per-request frames (`Request.frames`,
`_prefill_batch` :382, the bucket refusal of `_check` :416). The
speculative schedule (`launch/speculative.py`) builds on
`ContinuousSchedule` and registers itself in `SCHEDULES` as "spec". Not
ported yet: mesh placement, the prefix pool, chunked prefill, categorical
sampling (it needs `jax.random`'s threefry in torch) and the SLO schedule.

Every model dispatch and every lane write goes through `self.stream` under
the reference's keys — program keys from the `ProgramCache`, and
"admit_slot", "reset_slot", "merge_prefill" — so dispatch counts and
program misses compare one for one with the reference. Lane writes update
the resident decode cache in place: the reference's programs donate it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core.dispatch import ExecutionStream
from repro_torch.tree import map_with_path

# cache leaves with a time axis that prefill may fill only partly
TIME_MERGE_LEAVES = frozenset({"k", "v", "pos"})


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

SAMPLING_MODES = ("greedy",)


class TokenSampler:
    """Greedy sampling over the true vocab (first index on ties, as
    `np.argmax`). Categorical sampling waits for the port of `jax.random`'s
    threefry, so its streams can match the reference's."""

    def __init__(self, mode: str, vocab: int) -> None:
        if mode not in SAMPLING_MODES:
            raise ValueError(f"sampling mode {mode!r} not in {SAMPLING_MODES}")
        self.mode = mode
        self.vocab = vocab

    def __call__(self, logits_row: np.ndarray, rid: int, position: int) -> int:
        return int(np.argmax(np.asarray(logits_row, np.float32)[: self.vocab]))


def _host_row(logits: torch.Tensor, vocab: int) -> np.ndarray:
    """(B, S, V) logits -> the host's (B, vocab) fp32 rows of the last step."""
    return logits[:, -1, :vocab].float().cpu().numpy()


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Slot:
    """One decode lane's host-side state machine."""

    req: Request | None = None
    next_pos: int = 0             # absolute position the next decode writes
    next_tok: int = 0             # token consumed by the next decode step
    generated: list[int] = dataclasses.field(default_factory=list)
    bucket: int = 0
    admitted_step: int = 0

    @property
    def active(self) -> bool:
        return self.req is not None

    @property
    def generating(self) -> bool:
        """Past the prompt: the next decode step's logits are sampled."""
        return self.active and self.next_pos >= self.req.prompt.size


class _SchedulerBase:
    """Shared machinery: bucketed prefill programs, admission, floor stats."""

    def __init__(self, model, params, cfg, *, max_len: int,
                 sampling: str = "greedy",
                 stream: ExecutionStream | None = None) -> None:
        self.model = model
        self.cfg = cfg
        self.max_len = max_len
        self.buckets = default_buckets(max_len)
        self.stream = stream or ExecutionStream(device=model.device)
        self.cache = self.stream.cache
        self.sampler = TokenSampler(sampling, cfg.vocab)
        self.params = params
        self.device = model.device
        self._decode_memo: dict = {}

    # -- programs -----------------------------------------------------------
    def _tokens(self, array: np.ndarray) -> torch.Tensor:
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
        return self.cache.compile(self.model.prefill, self.params, batch)

    def _decode_program(self, caches, tok, pos):
        """Compile-or-hit the decode program, memoized by the (token, pos)
        shapes: cache shapes are fixed per scheduler."""
        sig = (tuple(tok.shape), str(tok.dtype), tuple(pos.shape), str(pos.dtype))
        hit = self._decode_memo.get(sig)
        if hit is None:
            hit = self.cache.compile(self.model.decode_step, self.params, caches,
                                     tok, pos)
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
    a private batch-1 decode loop."""

    name = "sequential"

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
            tok = self.sampler(_host_row(logits, self.cfg.vocab)[0], req.rid, L)
            generated = [tok]
            for i in range(req.max_new_tokens - 1):
                pos = L + i
                tokj = self._tokens([[tok]])
                posj = self._tokens([pos])
                decode, dkey = self._decode_program(caches, tokj, posj)
                self.stream.encode_operation(decode, (self.params, caches, tokj, posj),
                                             dkey, batch=1)
                caches, logits = self.stream.execute_sync()[0]
                tok = self.sampler(_host_row(logits, self.cfg.vocab)[0], req.rid,
                                   pos + 1)
                generated.append(tok)
            results.append(RequestResult(req.rid, L, np.asarray(generated, np.int32),
                                         bucket=L, admitted_step=step,
                                         finished_step=step))
        return results


class ContinuousSchedule(_SchedulerBase):
    """Continuous batching: `n_slots` decode lanes in one resident cache,
    stepping together. A new request is admitted into a free lane mid-flight:
    prefill at the largest bucket <= its prompt, catch the tail up through
    the shared decode program (teacher-forced prompt tokens), then generate.
    Every lane shares each decode dispatch."""

    name = "continuous"

    def __init__(self, model, params, cfg, *, n_slots: int, max_len: int,
                 prefix_cache: bool = False, prefill_chunk: int | None = None, **kw) -> None:
        # the reference's knobs (:509-537): an encoder-decoder refuses them
        # in the reference's words; anything else waits for their port
        if prefill_chunk is not None:
            if cfg.family == "encdec":
                raise ValueError(
                    "chunked prefill cannot serve encdec: the cross-attention "
                    "cache is built by the monolithic prefill program, so a "
                    "decode-mode chunk has no frames to attend to")
            raise NotImplementedError("chunked prefill is not ported yet")
        if prefix_cache:
            if cfg.family == "encdec":
                raise ValueError(
                    "prefix cache cannot serve encdec: the cross-attention "
                    "cache is built from per-request frames, so token-hash "
                    "block sharing would alias state across requests")
            raise NotImplementedError("the prefix pool is not ported yet")
        super().__init__(model, params, cfg, max_len=max_len, **kw)
        if n_slots < 1:
            raise ValueError(f"continuous schedule needs n_slots >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.slots = [_Slot() for _ in range(n_slots)]
        self.caches = None        # allocated lazily on first run

    def _ensure_caches(self) -> None:
        if self.caches is None:
            self.caches = self.model.init_cache(self.n_slots, self.max_len)

    # -- admission ----------------------------------------------------------
    def _admit(self, slot_idx: int, req: Request, step: int) -> None:
        """Prefill the bucket prefix through the stream, then write the
        prefill state into the lane (both dispatches on the stream)."""
        slot = self.slots[slot_idx]
        L = req.prompt.size
        bucket = bucket_for(L, self.buckets)
        if bucket == 0:
            self.stream.encode_operation(reset_slot, (self.caches, slot_idx),
                                         "reset_slot", batch=1)
            self.caches = self.stream.execute_sync()[0]
            slot.next_pos, slot.next_tok = 0, int(req.prompt[0])
        else:
            batch = self._prefill_batch(req.prompt[None, :bucket], req.frames)
            prefill, pkey = self._prefill_program(batch)
            self.stream.encode_operation(prefill, (self.params, batch), pkey, batch=1)
            pf_caches, logits = self.stream.execute_sync()[0]
            self.stream.encode_operation(admit_into_slot,
                                         (self.caches, pf_caches, slot_idx),
                                         "admit_slot", batch=1)
            self.caches = self.stream.execute_sync()[0]
            slot.next_pos = bucket
            if bucket < L:        # catch up through decode, teacher-forced
                slot.next_tok = int(req.prompt[bucket])
            else:                 # prompt fully prefilled: sample token L
                tok = self.sampler(_host_row(logits, self.cfg.vocab)[0], req.rid, L)
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
        slot.req = None
        slot.generated = []

    def _advance(self, slot: _Slot, logits_row: np.ndarray,
                 results: list[RequestResult], step: int) -> None:
        """Consume one decode step's logits for an active lane."""
        req = slot.req
        nxt = slot.next_pos + 1
        slot.next_pos = nxt
        if nxt < req.prompt.size:            # still catching up: teacher-force
            slot.next_tok = int(req.prompt[nxt])
            return
        tok = self.sampler(logits_row, req.rid, nxt)
        slot.generated.append(tok)
        slot.next_tok = tok
        if len(slot.generated) >= req.max_new_tokens:
            self._finish(slot, results, step)

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
            # a fully-prefilled request can finish without a decode step
            for s in self.slots:
                if s.active and s.generating and len(s.generated) >= s.req.max_new_tokens:
                    self._finish(s, results, step)
            active = [s for s in self.slots if s.active]
            if not active:
                if queue:
                    step += 1     # idle tick: waiting for an arrival
                    continue
                break
            # one slot-masked decode dispatch for every lane
            tok = np.zeros((self.n_slots, 1), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            for i, s in enumerate(self.slots):
                if s.active:
                    tok[i, 0] = s.next_tok
                    pos[i] = s.next_pos
            tokj, posj = self._tokens(tok), self._tokens(pos)
            decode, dkey = self._decode_program(self.caches, tokj, posj)
            self.stream.encode_operation(decode, (self.params, self.caches, tokj, posj),
                                         dkey, batch=len(active))
            self.caches, logits = self.stream.execute_sync()[0]
            lg = _host_row(logits, self.cfg.vocab)
            for i, s in enumerate(self.slots):
                if s.active:
                    self._advance(s, lg[i], results, step)
            step += 1
        results.sort(key=lambda r: r.rid)
        return results


SCHEDULES = {
    ContinuousSchedule.name: ContinuousSchedule,
    SequentialSchedule.name: SequentialSchedule,
}
