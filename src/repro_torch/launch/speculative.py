"""Speculative decoding on the overlapped stream: chain and tree windows,
greedy or seeded categorical.

After `src/repro/launch/speculative.py`. A cheaper drafter proposes K tokens
per lane in one dispatch, with the target sampler's own rule (greedy argmax,
or the per-(rid, pos) categorical draw); one verify dispatch runs K+1 target
decode steps teacher-forced on the proposals, turns their logits into score
rows (`specdec_ops.seeded_scores`: the fp32 logits, or the logits plus the
gumbel noise of each (rid, position)'s key), takes the first-index argmax at
every position and the accepted prefix on the card through the `specdec`
kernel, and rolls back every rejected cache write. Each window emits
`accept + 1` tokens per lane for exactly two floor-charged dispatches, and
the emitted tokens are always the target sampler's picks, so greedy streams
are token-exact against `SequentialSchedule` and categorical streams are the
same under every schedule, whatever the drafter proposed.

  * **Drafter** — `draft_of(cfg)` depth-prunes a config (same widths and
    vocab); `Drafter.shrink` builds it through `build_model` on the target's
    dispatcher, with random weights from a generator seeded `seed + 1` (the
    reference uses `PRNGKey(seed + 1)`), with given params (e.g. the
    reference's, bridged through `bridge.params_from_numpy`), or from a
    checkpoint directory (`ckpt=`, reference :143-178: its metadata's vocab
    and d_model checked before any array loads, a packed template where the
    metadata names a packed weight form, the tree validated after);
    `Drafter.self_draft` drafts with the target itself, its own caches apart.
  * **Tree windows** (`draft_branches > 1`) — the draft dispatch branches at
    the window root on the drafter's top-N of its first row (gumbel-perturbed
    under categorical sampling, so branch 0 is the chain's draw; a stable
    descending sort, so the lower index comes first on ties, as
    `jax.lax.top_k` orders them) and extends each branch with the sampler's
    rule; the verify dispatch tiles the target's caches to B*N rows (lane
    b's branches at rows b*N .. b*N+N-1, `repeat_interleave`), and the
    `specdec_tree` kernel keeps the first branch with the longest accepted
    prefix. A window with K = 0 runs the chain kernel, also in a tree run.
  * **Rollback** — decode writes the caches in place (the reference donates
    them). Positional leaves (`k`/`v`/`pos`, slot = pos % size, so a
    sliding-window ring wraps): the slots a window will clobber are copied
    out before its first step (gather copies) and written back after the
    kernel wherever the position was rejected; the window depth is clamped
    below the smallest ring, so no window wraps onto the slot it commits.
    Recurrent leaves (the SSM's state and conv tails, the RG-LRU's h and
    conv tail): a copy after each of the first K steps (the leaf itself
    holds the state after the last), and each lane keeps the state at its
    accept point (in a tree window, the winning branch's). A
    leaf without the lane axis raises, naming its tree path.
  * **Stream** — both dispatches go on an `AsyncExecutionStream`: the draft
    is submitted without waiting, the verify takes its live proposal tensor,
    and the host syncs once per window to read the accept lengths. On the
    card every program (draft, verify, tree draft and verify, joint
    catch-up and prefill; one per memo entry) replays as a CUDA graph: the
    draft's outputs are copied into the verify graph's static inputs, and
    the rollback's index writes and the threefry / gumbel arithmetic of a
    categorical window are device ops, captured with the rest.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointReader
from repro_torch.core.dispatch import AsyncExecutionStream
from repro_torch.kernels.specdec import ops as specdec_ops
from repro_torch.launch.scheduler import (SCHEDULES, TIME_MERGE_LEAVES, ContinuousSchedule,
                                          _leaf_name, admit_into_slot, bucket_for,
                                          reset_slot)
from repro_torch.models.model import build_model
from repro_torch.tree import leaves_with_path, tree_map


def _reset_both_slots(t_caches, d_caches, slot: int):
    """Decode-only admission of both models in ONE dispatch."""
    return reset_slot(t_caches, slot), reset_slot(d_caches, slot)


def _admit_both_slots(t_caches, d_caches, pf_t, pf_d, slot: int):
    """Target AND drafter prefill state into lane `slot` in ONE dispatch."""
    return admit_into_slot(t_caches, pf_t, slot), admit_into_slot(d_caches, pf_d, slot)


# ---------------------------------------------------------------------------
# Draft models
# ---------------------------------------------------------------------------


def draft_of(cfg) -> Any:
    """The shrink rule (reference :96): the same widths and vocab, depth cut
    to one layer (one block-pattern period for hybrids, one encoder layer
    for encdec), every draft layer dense, no MTP heads."""
    n_layers = len(cfg.block_pattern) if cfg.block_pattern else 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-draft",
        n_layers=n_layers,
        n_dense_layers=n_layers if cfg.n_experts else cfg.n_dense_layers,
        n_encoder_layers=min(cfg.n_encoder_layers, 1),
        mtp_depth=0,
    )


def _validate_draft_params(model, dcfg, params) -> None:
    """Reject drafter params that do not match `draft_of`'s tree, loudly: a
    wrong drafter would still serve, at acceptance ~0."""
    ref = dict(leaves_with_path(model.init(
        torch.Generator(device=model.device).manual_seed(0))))
    got = dict(leaves_with_path(params))
    if set(ref) != set(got):
        raise ValueError(
            f"drafter params do not match the {dcfg.name!r} param tree: missing "
            f"{sorted(set(ref) - set(got))[:4]}, unexpected {sorted(set(got) - set(ref))[:4]}")
    for path, leaf in ref.items():
        if tuple(got[path].shape) != tuple(leaf.shape):
            raise ValueError(f"drafter param {path!r} has shape {tuple(got[path].shape)}, "
                             f"draft config {dcfg.name!r} wants {tuple(leaf.shape)}")


def _load_draft_checkpoint(model, dcfg, cfg, path: str):
    """The drafter's params from a checkpoint directory (reference
    :143-178): the metadata's vocab and d_model checked against the target
    before any array loads; a checkpoint of a packed weight form restores
    into a template packed in that form, so the tags round-trip; a dense
    tree is validated after."""
    from repro_torch.optim.compression import compress_model_params

    reader = CheckpointReader(path)
    if reader.latest_step() is None:
        raise FileNotFoundError(f"no committed drafter checkpoint in {path!r}")
    meta = reader.metadata() or {}
    for key, want in (("vocab", cfg.vocab), ("d_model", cfg.d_model)):
        got = meta.get(key)
        if got is not None and int(got) != int(want):
            raise ValueError(
                f"drafter checkpoint {path!r} was distilled with {key}={got}, but the "
                f"target {cfg.name!r} serves {key}={want}; speculative decoding shares the "
                f"tokenizer and widths — re-distill against this target")
    form = meta.get("weight_form", "fp16")
    template = model.init(torch.Generator(device=model.device).manual_seed(0))
    if form != "fp16":
        template = compress_model_params(template, form)
    try:
        params, _ = reader.restore(template)
    except (KeyError, ValueError) as e:
        raise ValueError(f"drafter checkpoint {path!r} does not restore into the "
                         f"{dcfg.name!r} param tree: {e}") from None
    if form == "fp16":
        _validate_draft_params(model, dcfg, params)
    return params


@dataclasses.dataclass
class Drafter:
    """A draft model and its params, served beside the target."""

    model: Any
    params: Any
    cfg: Any
    kind: str = "shrink"
    trained: bool = False     # params given (distilled), not random init

    @classmethod
    def shrink(cls, cfg, *, dispatcher=None, device: str | torch.device = "cuda",
               seed: int = 0, params=None, ckpt: str | None = None) -> "Drafter":
        """The depth-pruned drafter: random weights from a generator seeded
        `seed + 1`, `params` (validated against `draft_of(cfg)`), or the
        params of the checkpoint directory `ckpt`."""
        if params is not None and ckpt is not None:
            raise ValueError("pass params= or ckpt=, not both")
        dcfg = draft_of(cfg)
        model = build_model(dcfg, dispatcher, device=device)
        trained = params is not None or ckpt is not None
        if ckpt is not None:
            params = _load_draft_checkpoint(model, dcfg, cfg, ckpt)
        elif params is not None:
            _validate_draft_params(model, dcfg, params)
        else:
            params = model.init(torch.Generator(device=model.device).manual_seed(seed + 1))
        return cls(model, params, dcfg, kind="shrink", trained=trained)

    @classmethod
    def self_draft(cls, model, params, cfg) -> "Drafter":
        """Draft with the target itself: every proposal is accepted."""
        return cls(model, params, cfg, kind="self", trained=True)


DRAFT_KINDS = ("shrink", "self")


# ---------------------------------------------------------------------------
# Cache slots a window writes
# ---------------------------------------------------------------------------


def _rollback_leaves(caches, lanes: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(positional, recurrent) leaves of a (stack, B, ...) cache tree: the
    named KV-time leaves, restored slot by slot, and every other leaf,
    restored from a per-step copy. A leaf whose axis 1 is not the `lanes`
    lanes cannot be rolled back by lane and raises with its path."""
    positional, recurrent = [], []
    for path, leaf in leaves_with_path(caches):
        if leaf.ndim < 2 or leaf.shape[1] != lanes:
            raise ValueError(f"cache leaf {path!r} {tuple(leaf.shape)}: speculative rollback "
                             f"wants (stack, {lanes} lanes, ...)")
        if _leaf_name(path) in TIME_MERGE_LEAVES:
            if leaf.ndim < 3:
                raise ValueError(f"cache leaf {path!r} {tuple(leaf.shape)}: a positional "
                                 "leaf wants a slot axis")
            positional.append(leaf)
        else:
            recurrent.append(leaf)
    return positional, recurrent


def _keep_accepted(leaves: list[torch.Tensor], snaps: list[list[torch.Tensor]],
                   accept: torch.Tensor, rows: torch.Tensor | None = None) -> None:
    """Each recurrent leaf (stack, B, ...) takes, per lane, its state after
    step `accept` of the window, in place: `snaps[j]` holds the copies after
    steps 0..K-1 and the leaf the state after step K (in a tree window the
    copies are of the B*nbr tiled rows, of which `rows` picks each lane's
    winner). Selection by mask, no host read."""
    for leaf, per_step in zip(leaves, snaps):
        for j, snap in enumerate(per_step):
            if rows is not None:
                snap = snap.index_select(1, rows)
            m = (accept == j).reshape((1, -1) + (1,) * (leaf.ndim - 2))
            leaf.copy_(torch.where(m, snap, leaf))


def _window_slots(leaf: torch.Tensor, p0: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) slots the window's speculative steps write: (p0+1 .. p0+k) % S."""
    steps = torch.arange(1, k + 1, device=p0.device)
    return (p0.long()[:, None] + steps[None]) % leaf.shape[2]


def _gather_slots(leaf: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """leaf[:, b, slots[b]] for every lane, as a copy: (stack, B, k, ...)."""
    idx = slots.reshape((1,) + tuple(slots.shape) + (1,) * (leaf.ndim - 3))
    return torch.gather(leaf, 2, idx.expand(leaf.shape[:2] + slots.shape[1:2] + leaf.shape[3:]))


def _restore_rejected(leaves: list[torch.Tensor], saved: list[torch.Tensor],
                      p0: torch.Tensor, accept: torch.Tensor, k: int) -> None:
    """Write the saved slot contents back, in place, wherever the window's
    step was rejected (step j > accept)."""
    steps = torch.arange(1, k + 1, device=accept.device)
    rejected = steps[None] > accept[:, None]                     # (B, k)
    for leaf, old in zip(leaves, saved):
        slots = _window_slots(leaf, p0, k)
        cur = _gather_slots(leaf, slots)
        m = rejected.reshape((1,) + tuple(rejected.shape) + (1,) * (leaf.ndim - 3))
        lanes = torch.arange(leaf.shape[1], device=leaf.device)[:, None]
        leaf[:, lanes, slots] = torch.where(m, old, cur)


def top_candidates(row: torch.Tensor, n: int) -> torch.Tensor:
    """(B, V) -> (B, n) int32 indices of the n largest scores, the lower
    index first on ties, as `jax.lax.top_k` orders them (`torch.topk`
    promises no order among equal scores): a stable descending sort."""
    return torch.sort(row, dim=-1, descending=True, stable=True).indices[:, :n].to(torch.int32)


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------


class SpeculativeSchedule(ContinuousSchedule):
    """Draft -> verify windows on an `AsyncExecutionStream` (reference :236).

    Admission, bucketed prefill and teacher-forced catch-up follow
    `ContinuousSchedule`, with the drafter admitted and stepped in the same
    dispatches; once every active lane samples, decode proceeds in windows:

        draft dispatch  : K+1 drafter steps -> proposals (B, K)
        verify dispatch : K+1 target steps teacher-forced on them, the
                          `specdec` kernel -> (samples, accept), rollback.

    `window_kinds` counts the windows by the kernel their verify ran:
    "chain" (`specdec`, K = 0 windows of a tree run included) and "tree"
    (`specdec_tree`); `bonus_windows` counts the K = 0 windows, which verify
    one position and draft nothing. `branch_wins` counts the lane-windows of
    tree windows by their winning branch, `partial_accepts` the lane-windows
    that kept some of their proposals and rolled back the rest."""

    name = "spec"

    #: in-flight window when this schedule builds its own stream: draft and
    #: verify of one window
    MAX_IN_FLIGHT = 2

    def __init__(self, model, params, cfg, *, n_slots: int, max_len: int,
                 draft_depth: int = 4, draft: str = "shrink",
                 drafter: Drafter | None = None, draft_branches: int = 1,
                 draft_ckpt: str | None = None, max_in_flight: int = MAX_IN_FLIGHT,
                 stream: AsyncExecutionStream | None = None, **kw) -> None:
        if kw.pop("prefix_cache", False):
            raise ValueError(
                "SpeculativeSchedule does not route admissions through the paged KV "
                "pool: joint target+drafter admission would need both caches resident "
                "per block. Serve prefix-cached traffic with --schedule continuous.")
        if kw.pop("prefill_chunk", None) is not None:
            raise ValueError(
                "SpeculativeSchedule does not chunk prefill: admission stages the target "
                "AND drafter caches jointly. Serve chunked-prefill traffic with "
                "--schedule continuous.")
        if stream is None:
            stream = AsyncExecutionStream(kw.get("program_cache"), device=model.device,
                                          max_in_flight=max_in_flight)
        if not isinstance(stream, AsyncExecutionStream):
            raise ValueError("SpeculativeSchedule pipelines draft->verify windows through "
                             f"AsyncExecutionStream; got {type(stream).__name__}")
        super().__init__(model, params, cfg, n_slots=n_slots, max_len=max_len,
                         stream=stream, **kw)
        if draft_depth < 1:
            raise ValueError(f"draft_depth must be >= 1, got {draft_depth}")
        if draft_branches < 1:
            raise ValueError(f"draft_branches must be >= 1, got {draft_branches}")
        if drafter is None:
            if draft not in DRAFT_KINDS:
                raise ValueError(f"draft {draft!r} not in {DRAFT_KINDS}")
            if draft == "self":
                if draft_ckpt:
                    raise ValueError(
                        "draft_ckpt loads a distilled shrink drafter; the self drafter IS "
                        "the target — drop --draft-ckpt or use --draft shrink")
                drafter = Drafter.self_draft(model, params, cfg)
            else:
                drafter = Drafter.shrink(cfg, dispatcher=model.dispatcher,
                                         device=model.device, ckpt=draft_ckpt or None)
        if drafter.cfg.vocab != cfg.vocab:
            raise ValueError(f"drafter vocab {drafter.cfg.vocab} != target vocab "
                             f"{cfg.vocab}; speculative decoding shares the tokenizer")
        self.drafter = drafter
        self.draft_depth = draft_depth
        self.draft_branches = draft_branches
        self.draft_caches = None
        self._min_ring: int | None = None
        self.n_windows = 0
        self.window_kinds: Counter[str] = Counter()   # by the verify's kernel
        self.bonus_windows = 0    # K = 0 windows: a verify and no draft
        self.branch_wins: Counter[int] = Counter()
        self.partial_accepts = 0
        self.proposed = 0
        self.accepted = 0
        self.emitted = 0
        self.draft_steps = 0      # drafter decode steps inside draft windows
        self.verify_steps = 0     # target decode steps inside verify windows
        self.catchup_steps = 0    # joint teacher-forced ticks (1 step each)
        self._draft_keys: set[str] = set()
        self._verify_keys: set[str] = set()
        self._draft_memo: dict = {}
        self._verify_memo: dict = {}
        self._joint_memo: dict = {}
        t_model, d_model = self.model, self.drafter.model

        def joint_prefill(params, dparams, batch):
            pf_t, logits = t_model.prefill(params, batch)
            pf_d, _ = d_model.prefill(dparams, batch)
            return pf_t, logits, pf_d

        # one stable function object: every admission resolves through the
        # ProgramCache, so its hits are counted
        self._joint_prefill_fn = joint_prefill

    # -- fused programs ------------------------------------------------------
    def _memo(self, memo: dict, keys: set, sig, build) -> tuple:
        """Compile-or-hit once per signature (a memo hit asks the cache
        nothing, as in the reference)."""
        hit = memo.get(sig)
        if hit is None:
            hit = build()
            keys.add(hit[1])
            memo[sig] = hit
        return hit

    def _propose(self, lg: torch.Tensor, rids: torch.Tensor, positions: torch.Tensor):
        """The drafter's proposal from its last step's logits: the target
        sampler's pick at `positions` (greedy argmax, or the seeded draw)."""
        return self.sampler.draw(lg[:, -1], rids, positions).to(torch.int32)

    def _draft_program(self, tok, p0, rids, k: int):
        """K+1 drafter steps: consume the chain from `tok`, propose with the
        target sampler's rule; the extra step consumes the last proposal, so
        an accept-all window leaves the drafter's stream contiguous (its
        proposal is dropped)."""
        model = self.drafter.model

        def fused(params, caches, tok0, p0, rids):
            tok, props = tok0, []
            for i in range(k + 1):
                caches, lg = model.decode_step(params, caches, tok, p0 + i)
                prop = self._propose(lg, rids, p0 + i + 1)
                props.append(prop)
                tok = prop[:, None]
            return caches, torch.stack(props[:k], dim=1)          # (B, K)

        return self._memo(self._draft_memo, self._draft_keys,
                          (k, tuple(tok.shape), tuple(p0.shape)),
                          lambda: self.cache.compile(fused, self.drafter.params,
                                                     self.draft_caches, tok, p0, rids,
                                                     options=f"k={k}", per_call=(2, 3, 4)))

    def _scores(self, rows: list[torch.Tensor], rids: torch.Tensor, p0: torch.Tensor):
        """The verify's score rows (B, K+1, V): position p0 + 1 + t's row t,
        greedy or gumbel-perturbed by its (rid, position) key."""
        scores = torch.stack(rows, dim=1)
        positions = p0.long()[:, None] + 1 + torch.arange(len(rows), device=p0.device)[None]
        return specdec_ops.seeded_scores(scores, self.sampler.root(scores.device), rids,
                                         positions, self.sampler.mode)

    def _verify_program(self, tok, p0, drafts, rids, k: int):
        """K+1 target steps teacher-forced on the proposals, the `specdec`
        kernel, and the rollback of every rejected cache write."""
        model, vocab = self.model, self.cfg.vocab
        disp = self.model.dispatcher

        def fused(params, caches, tok0, p0, drafts, rids):
            leaves, recurrent = _rollback_leaves(caches, tok0.shape[0])
            saved = [_gather_slots(leaf, _window_slots(leaf, p0, k)) for leaf in leaves] \
                if k else []
            tok, rows = tok0, []
            snaps: list[list[torch.Tensor]] = [[] for _ in recurrent]
            for i in range(k + 1):
                caches, lg = model.decode_step(params, caches, tok, p0 + i)
                rows.append(lg[:, -1, :vocab].float())
                if k:
                    tok = drafts[:, min(i, k - 1)][:, None]
                if i < k:             # the state after the last step is the leaf itself
                    for per_step, leaf in zip(snaps, recurrent):
                        per_step.append(leaf.clone())
            scores = self._scores(rows, rids, p0)
            samples, accept = specdec_ops.verify_accept(scores, drafts, dispatcher=disp)
            if k:
                _restore_rejected(leaves, saved, p0, accept, k)
                _keep_accepted(recurrent, snaps, accept)
            return caches, samples, accept

        return self._memo(self._verify_memo, self._verify_keys,
                          (k, tuple(tok.shape), tuple(p0.shape)),
                          lambda: self.cache.compile(fused, self.params, self.caches, tok,
                                                     p0, drafts, rids, options=f"k={k}",
                                                     per_call=(2, 3, 4, 5)))

    def _draft_tree_program(self, tok, p0, rids, k: int):
        """The tree window's draft: step 0 on the B lanes ranks the drafter's
        candidates for the window's first proposal (its row, perturbed by
        the (rid, p0 + 1) gumbel under categorical sampling, so the top one
        is the chain's draw); the caches tile to B*nbr rows (lane b's
        branches at rows b*nbr .. b*nbr+nbr-1), each branch starts at one of
        the top-nbr candidates (branch 0: the chain proposal) and extends
        with the sampler's rule; the last of the k tiled steps only keeps
        the drafter's stream contiguous."""
        nbr = self.draft_branches
        model, vocab = self.drafter.model, self.cfg.vocab

        def fused(params, caches, tok0, p0, rids):
            caches, lg = model.decode_step(params, caches, tok0, p0)
            row = specdec_ops.seeded_scores(
                lg[:, -1:, :vocab], self.sampler.root(lg.device), rids, p0.long()[:, None] + 1,
                self.sampler.mode)[:, 0]
            roots = top_candidates(row, nbr)                        # (B, nbr)
            tiled = tree_map(lambda leaf: leaf.repeat_interleave(nbr, dim=1), caches)
            tokt = roots.reshape(-1, 1)                             # (B*nbr, 1)
            p0t = p0.repeat_interleave(nbr)
            ridt = rids.repeat_interleave(nbr)
            tok, props = tokt, []
            for i in range(k):
                tiled, lg = model.decode_step(params, tiled, tok, p0t + 1 + i)
                prop = self._propose(lg, ridt, p0t + i + 2)
                props.append(prop)
                tok = prop[:, None]
            drafts = torch.cat([tokt] + [p[:, None] for p in props[:k - 1]], dim=1)
            return tiled, drafts.reshape(tok0.shape[0], nbr, k)

        return self._memo(self._draft_memo, self._draft_keys,
                          (k, nbr, tuple(tok.shape), tuple(p0.shape)),
                          lambda: self.cache.compile(fused, self.drafter.params,
                                                     self.draft_caches, tok, p0, rids,
                                                     options=f"k={k} nbr={nbr}",
                                                     per_call=(2, 3, 4)))

    def _verify_tree_program(self, dcaches_tiled, tok, p0, drafts, rids, k: int):
        """One dispatch scores the whole tree: the target's caches tile to
        B*nbr rows, K+1 steps run every branch teacher-forced, the
        `specdec_tree` kernel picks each lane's winning branch, and the
        caches keep that branch's rows, rolled back past its accepted prefix.
        The drafter's caches keep the winner's rows of the draft's tiled
        caches too, without rollback (a dented proposal context costs
        acceptance, never a token). Both resident caches take the winners'
        rows in place, so every window binds the same storage."""
        nbr = self.draft_branches
        model, vocab = self.model, self.cfg.vocab
        disp = self.model.dispatcher

        def fused(params, caches, dcaches, dtiled, tok0, p0, drafts, rids):
            b = tok0.shape[0]
            leaves, recurrent = _rollback_leaves(caches, b)
            # every branch clobbers the same slots: save them per lane, untiled
            saved = [_gather_slots(leaf, _window_slots(leaf, p0, k)) for leaf in leaves]
            tiled = tree_map(lambda leaf: leaf.repeat_interleave(nbr, dim=1), caches)
            _, tiled_recurrent = _rollback_leaves(tiled, b * nbr)
            p0t = p0.repeat_interleave(nbr)
            dflat = drafts.reshape(b * nbr, k)
            tok, rows = tok0.repeat_interleave(nbr, dim=0), []
            snaps: list[list[torch.Tensor]] = [[] for _ in recurrent]
            for i in range(k + 1):
                tiled, lg = model.decode_step(params, tiled, tok, p0t + i)
                rows.append(lg[:, -1, :vocab].float())
                tok = dflat[:, min(i, k - 1)][:, None]
                if i < k:
                    for per_step, leaf in zip(snaps, tiled_recurrent):
                        per_step.append(leaf.clone())
            scores = self._scores(rows, rids.repeat_interleave(nbr), p0t)
            samples, accept, branch = specdec_ops.verify_accept_tree(
                scores.reshape(b, nbr, k + 1, scores.shape[-1]), drafts, dispatcher=disp)
            win = torch.arange(b, device=branch.device) * nbr + branch.long()
            caches = tree_map(lambda dst, src: dst.copy_(src.index_select(1, win)),
                              caches, tiled)
            _restore_rejected(leaves, saved, p0, accept, k)
            _keep_accepted(recurrent, snaps, accept, win)
            dcaches = tree_map(lambda dst, src: dst.copy_(src.index_select(1, win)),
                               dcaches, dtiled)
            return caches, dcaches, samples, accept, branch

        # per call: the draft's tiled caches, token, positions, drafts, rids
        return self._memo(self._verify_memo, self._verify_keys,
                          (k, nbr, tuple(tok.shape), tuple(p0.shape)),
                          lambda: self.cache.compile(fused, self.params, self.caches,
                                                     self.draft_caches, dcaches_tiled,
                                                     tok, p0, drafts, rids,
                                                     options=f"k={k} nbr={nbr}",
                                                     per_call=(3, 4, 5, 6, 7)))

    def _joint_program(self, tok, pos):
        """Prompt catch-up: one dispatch steps target AND drafter on the same
        teacher-forced token."""
        sig = (tuple(tok.shape), tuple(pos.shape))
        hit = self._joint_memo.get(sig)
        if hit is None:
            t_model, d_model = self.model, self.drafter.model

            def fused(params, dparams, caches, dcaches, tok, pos):
                caches, lg = t_model.decode_step(params, caches, tok, pos)
                dcaches, _ = d_model.decode_step(dparams, dcaches, tok, pos)
                return caches, dcaches, lg

            hit = self.cache.compile(fused, self.params, self.drafter.params, self.caches,
                                     self.draft_caches, tok, pos, per_call=(4, 5))
            self._joint_memo[sig] = hit
        return hit

    # -- admission (drafter in lockstep, joint dispatches) -------------------
    def _admit(self, slot_idx: int, req, step: int) -> None:
        """`ContinuousSchedule._admit` with the drafter admitted in the SAME
        dispatches: one joint prefill and one joint lane write (or reset).
        An encoder-decoder's joint prefill carries the request's frames into
        both models: the drafter runs its own stem and encoder on them
        (reference :696)."""
        slot = self.slots[slot_idx]
        L = req.prompt.size
        bucket = bucket_for(L, self.buckets)
        if bucket == 0:
            self.stream.encode_operation(
                _reset_both_slots, (self.caches, self.draft_caches, slot_idx),
                "spec_reset_slot", batch=1)
            self.caches, self.draft_caches = self.stream.execute_sync()[0]
            slot.next_pos, slot.next_tok = 0, int(req.prompt[0])
        else:
            batch = self._prefill_batch(req.prompt[None, :bucket], req.frames)
            prefill, pkey = self.cache.compile(self._joint_prefill_fn, self.params,
                                               self.drafter.params, batch, per_call=(2,))
            self.stream.encode_operation(prefill, (self.params, self.drafter.params, batch),
                                         pkey, batch=1)
            pf_t, logits, pf_d = self.stream.execute_sync()[0]
            self.stream.encode_operation(
                _admit_both_slots, (self.caches, self.draft_caches, pf_t, pf_d, slot_idx),
                "spec_admit_slot", batch=1)
            self.caches, self.draft_caches = self.stream.execute_sync()[0]
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

    # -- the serve loop ------------------------------------------------------
    def run(self, requests: list) -> list:
        for r in requests:
            self._check(r)
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._ensure_caches()
        if self.draft_caches is None:
            self.draft_caches = self.drafter.model.init_cache(self.n_slots, self.max_len)
        results: list = []
        step = 0
        while queue or any(s.active for s in self.slots):
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
                    step += 1     # idle tick: wait for the next arrival
                    continue
                break
            if any(s.next_pos + 1 < s.req.prompt.size for s in active):
                step = self._catchup_step(results, step)
            else:
                step = self._spec_window(queue, results, step)
        results.sort(key=lambda r: r.rid)
        return results

    def _lane_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(B, 1) next tokens, (B,) next positions and (B,) rids of the
        active lanes."""
        tok = np.zeros((self.n_slots, 1), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        rids = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s.active:
                tok[i, 0] = s.next_tok
                pos[i] = s.next_pos
                rids[i] = s.req.rid
        return tok, pos, rids

    def _catchup_step(self, results: list, step: int) -> int:
        """One joint teacher-forced tick while any lane is inside its prompt."""
        tok, pos, _ = self._lane_arrays()
        tokj, posj = self._tokens(tok), self._tokens(pos)
        prog, key = self._joint_program(tokj, posj)
        lanes = self._decoding()
        self.stream.encode_operation(
            prog, (self.params, self.drafter.params, self.caches, self.draft_caches,
                   tokj, posj), key, batch=len(lanes))
        self.caches, self.draft_caches, logits = self.stream.execute_sync()[0]
        self.catchup_steps += 1
        picks = self._sample_lanes(logits, lanes)
        for i in lanes:
            self._advance(self.slots[i], picks.get(i), results, step)
        return step + 1

    def _min_positional_size(self) -> int:
        """Smallest slot-axis extent of the target's positional cache leaves:
        a deeper window would wrap onto its own first slot."""
        if self._min_ring is None:
            sizes = [leaf.shape[2] for path, leaf in leaves_with_path(self.caches)
                     if _leaf_name(path) in TIME_MERGE_LEAVES]
            self._min_ring = min(sizes) if sizes else self.max_len
        return self._min_ring

    def _window_depth(self, active: list, queue: list, step: int) -> int:
        """Never past a lane's cache end or a ring's size, never more
        proposals than the hungriest lane can still emit, never past a queued
        arrival that could claim a free lane."""
        k = self.draft_depth
        k = min(k, self._min_positional_size() - 1)
        k = min(k, min(self.max_len - 1 - s.next_pos for s in active))
        k = min(k, max(s.req.max_new_tokens - len(s.generated) for s in active) - 1)
        if queue and any(not s.active for s in self.slots):
            k = min(k, max(1, queue[0].arrival - step) - 1)
        return max(k, 0)

    def _submit(self):
        """Submit the one encoded program. A program that raised on the host
        has no outputs (`submit` keeps its error): `sync` re-raises it."""
        out = self.stream.submit()[0]
        if out is None:
            self.stream.sync()
        return out

    def _spec_window(self, queue: list, results: list, step: int) -> int:
        active = [s for s in self.slots if s.active]
        k = self._window_depth(active, queue, step)
        tok, p0, rids = self._lane_arrays()
        tokj, p0j, ridsj = self._tokens(tok), self._tokens(p0), self._tokens(rids)
        if k > 0 and self.draft_branches > 1:
            prog, dkey = self._draft_tree_program(tokj, p0j, ridsj, k)
            self.stream.encode_operation(prog, (self.drafter.params, self.draft_caches,
                                                tokj, p0j, ridsj), dkey, batch=len(active))
            dtiled, drafts = self._submit()
            self.draft_steps += k + 1
            prog, vkey = self._verify_tree_program(dtiled, tokj, p0j, drafts, ridsj, k)
            self.stream.encode_operation(prog, (self.params, self.caches, self.draft_caches,
                                                dtiled, tokj, p0j, drafts, ridsj), vkey,
                                         batch=len(active))
            self.caches, self.draft_caches, samples, accept, branch = self._submit()
            self.window_kinds["tree"] += 1
        else:
            branch = None
            if k > 0:
                prog, dkey = self._draft_program(tokj, p0j, ridsj, k)
                self.stream.encode_operation(prog, (self.drafter.params, self.draft_caches,
                                                    tokj, p0j, ridsj), dkey, batch=len(active))
                # no wait: the proposals chain into the verify as a live tensor
                self.draft_caches, drafts = self._submit()
                self.draft_steps += k + 1
            else:
                drafts = torch.zeros((self.n_slots, 0), dtype=torch.int32,
                                     device=self.device)
                self.bonus_windows += 1
            prog, vkey = self._verify_program(tokj, p0j, drafts, ridsj, k)
            self.stream.encode_operation(prog, (self.params, self.caches, tokj, p0j, drafts,
                                                ridsj), vkey, batch=len(active))
            self.caches, samples, accept = self._submit()
            self.window_kinds["chain"] += 1
        self.stream.sync()        # accept lengths are data: one sync per window
        samples = samples.cpu().numpy()
        accept = accept.cpu().numpy()
        if branch is not None:
            branch = branch.cpu().numpy()
        self.n_windows += 1
        self.verify_steps += k + 1
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            a = int(accept[i])
            self.proposed += k
            self.accepted += a
            self.partial_accepts += 0 < a < k
            if branch is not None:
                self.branch_wins[int(branch[i])] += 1
            take = min(a + 1, s.req.max_new_tokens - len(s.generated))
            s.generated.extend(int(t) for t in samples[i, :take])
            self.emitted += take
            s.next_pos = int(p0[i]) + a + 1
            s.next_tok = int(samples[i, a])
            if len(s.generated) >= s.req.max_new_tokens:
                self._finish(s, results, step + take)
        return step + k + 1

    # -- reporting -----------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed; 0.0 when no window proposed anything."""
        return self.accepted / self.proposed if self.proposed else 0.0

    def stats(self, n_requests: int) -> dict:
        out = super().stats(n_requests)
        recs = self.stream.records
        draft_recs = sum(1 for r in recs if r.key in self._draft_keys)
        verify_recs = sum(1 for r in recs if r.key in self._verify_keys)
        out.update({
            "draft_depth": self.draft_depth,
            "draft_branches": self.draft_branches,
            "drafter": self.drafter.kind,
            "drafter_trained": self.drafter.trained,
            "n_windows": self.n_windows,
            "windows_by_kind": dict(self.window_kinds),
            "bonus_windows": self.bonus_windows,
            "branch_wins": dict(self.branch_wins),
            "partial_accepts": self.partial_accepts,
            "draft_dispatches": draft_recs,
            "verify_dispatches": verify_recs,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": self.acceptance_rate,
            "emitted_tokens": self.emitted,
            "tokens_per_window_dispatch": self.emitted / max(draft_recs + verify_recs, 1),
            "draft_steps": self.draft_steps,
            "verify_steps": self.verify_steps,
            "catchup_steps": self.catchup_steps,
        })
        return out


SCHEDULES["spec"] = SpeculativeSchedule
