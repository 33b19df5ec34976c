"""Drafter distillation: teach the shrink draft model the target's logits.

    PYTHONPATH=src python -m repro_torch.launch.distill --arch tinyllama-1.1b \
        --smoke --device cpu --teacher-steps 150 --steps 300 --ckpt-dir /tmp/distill
    PYTHONPATH=src python -m repro_torch.launch.distill --arch tinyllama-1.1b \
        --ckpt-dir DISTILL_DIR

After `src/repro/launch/distill.py` (`STUDENT_STEP_OFFSET` :59, `DEFAULTS`
:63, `_full_logits` :67, `make_teacher_logits_fn` :77, `make_distill_loss`
:85, `_fit` :113, `train_teacher` :130, `distill_student` :152,
`rollout_agreement` :185, `_metadata` :210, `load_teacher` :217,
`distill_pipeline` :235, `run` :262), with the reference's flags and the
port's `--device` (default `cuda`, as the train and serve CLIs'). A shrink
drafter from random init shares no distribution with the target: its
acceptance is ~0 and every speculative window pays two dispatches for one
token. The recipe, through the port's training stack:

  * **teacher** — the target model itself, trained with `launch/train.py`'s
    `make_train_step` on the synthetic motif corpus (`data/pipeline.py`),
    whose motifs give next-token prediction real structure.
  * **student** — `draft_of(cfg)`: one layer, the same widths and vocab,
    built through `build_model` like every serving model.
  * **loss** — `kl_weight * T^2 * KL(teacher || student)` at temperature T
    plus `(1 - kl_weight)` of the hard-label cross entropy (with the z-loss
    at 1e-4), stepped by the same `make_train_step` through its `loss_fn=`
    hook. The teacher's fp32 logits come from one forward without a
    gradient per batch and ride the batch as `batch["teacher_logits"]`,
    detached, so gradients reach the student's leaves only.
  * **checkpoints** — `checkpoint.CheckpointManager` with a metadata
    sidecar (arch, vocab, d_model, weight form, the final agreement), in
    the reference's layout: `--draft shrink --draft-ckpt DIR/student` on
    the serve CLI serves the student, `--ckpt DIR/teacher` the teacher, and
    the reference reads both. A packed `--student-weight-form` is packed by
    `compress_model_params` and keeps its form tags.

On `--device cuda` the kernels are built first with nvcc if missing, and
every dense matmul and full-causal attention of both models' forwards runs
its hand-written CUDA kernel (`models.dispatched`); the backward's plain
products run in full fp32 (TF32 off). The loops are eager (the port's
train step updates the params and the optimizer state in place); nothing
catches a failure: an exception ends the run. Without a CUDA device and
without `--device cpu` the CLI exits with an error.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Iterable

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import CheckpointManager, CheckpointReader
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import native
from repro_torch.launch.speculative import draft_of
from repro_torch.launch.train import make_train_step
from repro_torch.models.attention import NEG_INF
from repro_torch.models.model import build_model, token_xent
from repro_torch.optim import adamw

#: the student's data stream is the teacher's motif distribution (the same
#: DataConfig seed plants the same motifs) on a disjoint slice of the step
#: space, so distillation batches never replay teacher training batches
STUDENT_STEP_OFFSET = 100_000

#: the reference's recipe defaults
DEFAULTS = dict(teacher_steps=150, steps=300, batch=8, seq=64, lr=3e-3,
                kl_weight=0.75, temperature=1.0)


def _full_logits(model, params, tokens: torch.Tensor) -> torch.Tensor:
    """fp32 (B, S, padded V) logits of a full-context train-mode forward:
    the teacher's soft targets and the student's predictions."""
    return model._train_logits(params, {"tokens": tokens})[0]


def make_teacher_logits_fn(teacher) -> Callable:
    """`(tparams, tokens) -> fp32 logits`, one teacher forward without a
    gradient through the teacher's dispatcher; its output rides the batch
    into the student's train step as `batch["teacher_logits"]`."""
    @torch.no_grad()
    def teacher_logits(tparams, tokens: torch.Tensor) -> torch.Tensor:
        return _full_logits(teacher, tparams, tokens).detach()

    return teacher_logits


def distill_terms(lg: torch.Tensor, teacher_lg: torch.Tensor, targets: torch.Tensor,
                  vocab: int, temperature: float) -> dict[str, torch.Tensor]:
    """The distillation loss's per-token terms (each of the targets'
    shape): `kl`, T^2 times KL(teacher || student) at temperature T; `ce`
    and `z`, the hard-label cross entropy and z-loss (`token_xent`);
    `agree`, first-index argmax equality as fp32. Padded vocab slots are
    masked to -1e30 in both logits, so they carry no teacher mass: there
    `p_t` is 0 and `logp_t - logp_s` is 0 in fp32."""
    T = float(temperature)
    vmask = torch.arange(lg.shape[-1], device=lg.device) < vocab
    neg = torch.full((), NEG_INF, device=lg.device)
    lg = torch.where(vmask, lg, neg)
    tl = torch.where(vmask, teacher_lg.float(), neg)
    logp_s = torch.log_softmax(lg / T, dim=-1)
    logp_t = torch.log_softmax(tl / T, dim=-1)
    p_t = torch.exp(logp_t)
    kl = (T * T) * torch.sum(p_t * (logp_t - logp_s), dim=-1)
    ce, z = token_xent(lg, targets, vocab)
    agree = (torch.argmax(lg, dim=-1) == torch.argmax(tl, dim=-1)).float()
    return {"kl": kl, "ce": ce, "z": z, "agree": agree}


def make_distill_loss(student, vocab: int, *, kl_weight: float = 0.75,
                      temperature: float = 1.0) -> Callable:
    """`loss_fn(params, batch)` for `make_train_step`: temperature-scaled
    KL to the teacher plus hard-label CE, with the teacher's top-1
    agreement reported alongside (the quantity speculative acceptance
    tracks). Metrics: `loss`, `kl`, `ce`, `agree`."""
    if not 0.0 <= kl_weight <= 1.0:
        raise ValueError(f"kl_weight must be in [0, 1], got {kl_weight}")

    def loss_fn(params, batch):
        lg = _full_logits(student, params, batch["tokens"])
        terms = distill_terms(lg, batch["teacher_logits"], batch["targets"], vocab,
                              temperature)
        kl, ce, z = terms["kl"].mean(), terms["ce"].mean(), terms["z"].mean()
        loss = kl_weight * kl + (1.0 - kl_weight) * ce + 1e-4 * z
        return loss, {"loss": loss, "kl": kl, "ce": ce, "agree": terms["agree"].mean()}

    return loss_fn


def _fit(step_fn, params, opt_state, batches: Iterable[dict], *, log_every: int,
         tag: str) -> tuple:
    """The shared loop: one eager step a batch, the params and state
    updated in place. Returns (params, the loss every `log_every` steps,
    each step's wall in seconds: its batch, the teacher's forward
    included, synchronized on the card)."""
    history: list[float] = []
    step_s: list[float] = []
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            return params, history, step_s
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss_t = metrics["loss"]
        if loss_t.is_cuda:
            torch.cuda.synchronize(loss_t.device)
        step_s.append(time.perf_counter() - t0)
        if len(step_s) % log_every == 0:
            loss = float(loss_t)
            history.append(loss)
            extras = "".join(f" {k} {float(v):.3f}" for k, v in metrics.items()
                             if k in ("kl", "ce", "agree"))
            print(f"[{tag}] step {len(step_s):5d} loss {loss:8.4f}{extras}", flush=True)


def _batches(src: SyntheticLM, steps: int, device, offset: int = 0):
    for t in range(steps):
        yield {k: torch.from_numpy(v).to(device) for k, v in src.batch(offset + t).items()}


def train_teacher(cfg, *, steps: int, batch: int, seq: int, lr: float, seed: int = 0,
                  log_every: int = 50, device="cuda", dispatcher=None) -> tuple:
    """Train the target on the motif corpus: (teacher, params, loss
    history, step walls). The teacher is this run: what speculation needs
    is that teacher and student share a learned distribution. Its AdamW
    state is released on return."""
    device = torch.device(device)
    teacher = build_model(cfg, dispatcher, device=device)
    params = teacher.init(torch.Generator(device=device).manual_seed(seed))
    opt_cfg = adamw.AdamWConfig(peak_lr=lr, warmup_steps=max(steps // 15, 5),
                                total_steps=steps)
    opt_state = adamw.init_state(opt_cfg, params)
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))
    params, history, step_s = _fit(make_train_step(teacher, opt_cfg), params, opt_state,
                                   _batches(src, steps, device), log_every=log_every,
                                   tag="teacher")
    return teacher, params, history, step_s


def distill_student(cfg, teacher, tparams, *, steps: int, batch: int, seq: int, lr: float,
                    kl_weight: float, temperature: float, seed: int = 0,
                    log_every: int = 50, dispatcher=None) -> tuple:
    """Distill `draft_of(cfg)` against the teacher: (student, params, loss
    history, step walls). The same step machinery as pretraining, the loss
    swapped through `loss_fn=`; constant-after-warmup schedule (a
    distillation budget is not a convergence horizon)."""
    device = teacher.device
    student = build_model(draft_of(cfg), dispatcher, device=device)
    params = student.init(torch.Generator(device=device).manual_seed(seed + 1))
    opt_cfg = adamw.AdamWConfig(peak_lr=lr, warmup_steps=max(steps // 30, 5),
                                total_steps=steps, schedule_kind="constant")
    opt_state = adamw.init_state(opt_cfg, params)
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed))
    teacher_fn = make_teacher_logits_fn(teacher)
    loss_fn = make_distill_loss(student, cfg.vocab, kl_weight=kl_weight,
                                temperature=temperature)

    def batches():
        for b in _batches(src, steps, device, offset=STUDENT_STEP_OFFSET):
            b["teacher_logits"] = teacher_fn(tparams, b["tokens"])
            yield b

    params, history, step_s = _fit(make_train_step(student, opt_cfg, loss_fn=loss_fn),
                                   params, opt_state, batches(), log_every=log_every,
                                   tag="distill")
    return student, params, history, step_s


@torch.no_grad()
def rollout_agreement(cfg, teacher, tparams, student, sparams, *, n_prompts: int = 16,
                      prompt_len: int = 24, steps: int = 12, seed: int = 7) -> float:
    """Held-out greedy rollout agreement: roll the teacher forward greedily
    from fresh motif prompts (full-context forwards) and score the
    student's stepwise top-1 over the true vocab: the off-policy estimate
    of shrink-drafter acceptance."""
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=prompt_len, global_batch=n_prompts,
                                 seed=seed))
    ctx = torch.from_numpy(src.prompt_batch(0, n_prompts, prompt_len)).to(teacher.device)
    hits = total = 0
    for _ in range(steps):
        t_pick = torch.argmax(_full_logits(teacher, tparams, ctx)[:, -1, :cfg.vocab], dim=-1)
        s_pick = torch.argmax(_full_logits(student, sparams, ctx)[:, -1, :cfg.vocab], dim=-1)
        hits += int((t_pick == s_pick).sum())
        total += t_pick.numel()
        ctx = torch.cat([ctx, t_pick[:, None].to(ctx.dtype)], dim=1)
    return hits / max(total, 1)


def _metadata(cfg, role: str, *, weight_form: str = "fp16", **extra) -> dict:
    return {"role": role, "arch": cfg.name, "vocab": int(cfg.vocab),
            "d_model": int(cfg.d_model), "n_layers": int(cfg.n_layers),
            "weight_form": weight_form, **extra}


def load_teacher(cfg, ckpt_dir: str, *, device="cuda", dispatcher=None) -> tuple:
    """(teacher, params) from a distill checkpoint directory's teacher/
    subtree, its metadata checked against `cfg` before any array loads; a
    directory with no committed step raises FileNotFoundError."""
    reader = CheckpointReader(ckpt_dir)
    meta = reader.metadata() or {}
    for key, want in (("vocab", cfg.vocab), ("d_model", cfg.d_model)):
        got = meta.get(key)
        if got is not None and int(got) != int(want):
            raise ValueError(
                f"teacher checkpoint {ckpt_dir!r} was trained with {key}={got}, but the "
                f"requested config {cfg.name!r} has {key}={want}")
    device = torch.device(device)
    teacher = build_model(cfg, dispatcher, device=device)
    params, _ = reader.restore(teacher.init(torch.Generator(device=device).manual_seed(0)))
    return teacher, params


def distill_pipeline(cfg, *, teacher_steps: int, steps: int, batch: int, seq: int, lr: float,
                     kl_weight: float, temperature: float, seed: int = 0,
                     teacher_ckpt: str | None = None, eval_steps: int = 12,
                     log_every: int = 50, device="cuda") -> dict:
    """The whole recipe as a library call: train or load the teacher,
    distill the student, measure held-out rollout agreement. Both models
    share one `KernelDispatcher` (`routes`: its census); on the card
    `peak_memory_gb` holds each stage's peak (the teacher's, then the
    student's from a reset after the teacher's optimizer state is gone)."""
    device = torch.device(device)
    dispatcher = KernelDispatcher()
    peak: dict[str, float] = {}

    def mark(stage: str) -> None:
        if device.type == "cuda":
            peak[stage] = torch.cuda.max_memory_allocated(device) / 1e9
            torch.cuda.reset_peak_memory_stats(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    teacher_step_s: list[float] = []
    if teacher_ckpt:
        teacher, tparams = load_teacher(cfg, teacher_ckpt, device=device, dispatcher=dispatcher)
        teacher_history: list[float] = []
    else:
        teacher, tparams, teacher_history, teacher_step_s = train_teacher(
            cfg, steps=teacher_steps, batch=batch, seq=seq, lr=lr, seed=seed,
            log_every=log_every, device=device, dispatcher=dispatcher)
    mark("teacher")
    student, sparams, history, step_s = distill_student(
        cfg, teacher, tparams, steps=steps, batch=batch, seq=seq, lr=lr,
        kl_weight=kl_weight, temperature=temperature, seed=seed, log_every=log_every,
        dispatcher=dispatcher)
    mark("student")
    agree = rollout_agreement(cfg, teacher, tparams, student, sparams, steps=eval_steps,
                              seed=seed + 7)
    return {"cfg": cfg, "teacher": teacher, "teacher_params": tparams,
            "teacher_history": teacher_history, "teacher_step_s": teacher_step_s,
            "student": student, "student_cfg": student.cfg, "student_params": sparams,
            "history": history, "step_s": step_s, "agreement": agree,
            "routes": dispatcher.census(), "peak_memory_gb": peak}


def save_student(ckpt_dir: str, cfg, sparams, step: int, *, weight_form: str,
                 agreement: float) -> None:
    """`<ckpt_dir>/student` at `step`, packed in `weight_form` unless fp16,
    with the metadata `Drafter.shrink(ckpt=...)` checks (`cfg` the target's
    config; the sidecar names the student's)."""
    from repro_torch.optim.compression import compress_model_params

    if weight_form != "fp16":
        sparams = compress_model_params(sparams, weight_form)
    CheckpointManager(os.path.join(ckpt_dir, "student")).save(
        step, sparams, metadata=_metadata(draft_of(cfg), "draft-student",
                                          weight_form=weight_form, target_arch=cfg.name,
                                          agreement_top1=float(agreement)))


def run(argv=None) -> dict:
    """The CLI. Returns the reference's dict (`loss_history`,
    `teacher_history`, `agreement`, `arch`, `student_arch`) plus the
    trained `teacher_params` and `student_params`, each loop's step walls
    (`teacher_step_s`, `step_s`), the dispatcher's `routes`, each stage's
    `peak_memory_gb` on the card and, with `--ckpt-dir`, each save's wall
    (`save_s`)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.distill")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.ARCH_NAMES + ["ane-paper"])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--teacher-steps", type=int, default=DEFAULTS["teacher_steps"])
    ap.add_argument("--teacher-ckpt", default="",
                    help="load the teacher from this checkpoint directory instead of "
                         "training one")
    ap.add_argument("--steps", type=int, default=DEFAULTS["steps"],
                    help="distillation steps for the student")
    ap.add_argument("--batch", type=int, default=DEFAULTS["batch"])
    ap.add_argument("--seq", type=int, default=DEFAULTS["seq"])
    ap.add_argument("--lr", type=float, default=DEFAULTS["lr"])
    ap.add_argument("--kl-weight", type=float, default=DEFAULTS["kl_weight"],
                    help="soft-target weight; 1 - kl_weight goes to the hard-label CE")
    ap.add_argument("--temperature", type=float, default=DEFAULTS["temperature"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="write teacher/ and student/ checkpoints (with metadata sidecars) "
                         "under this directory")
    ap.add_argument("--student-weight-form", default="fp16",
                    choices=("fp16", "int4_palette", "sparse"),
                    help="pack the student checkpoint into this streamed form; "
                         "`--draft-ckpt` restores the form tags intact")
    ap.add_argument("--eval-steps", type=int, default=12,
                    help="held-out teacher-rollout length for the agreement report")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels; cpu: their plain PyTorch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available "
                 "(pass --device cpu to run the plain versions on the CPU)")

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.device == "cuda":
        native.build()
        # the backward's plain products in full fp32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    out = distill_pipeline(
        cfg, teacher_steps=args.teacher_steps, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, kl_weight=args.kl_weight, temperature=args.temperature,
        seed=args.seed, teacher_ckpt=args.teacher_ckpt or None, eval_steps=args.eval_steps,
        log_every=args.log_every, device=args.device)

    save_s: dict[str, float] = {}
    if args.ckpt_dir:
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(args.ckpt_dir, "teacher")).save(
            args.teacher_steps, out["teacher_params"], metadata=_metadata(cfg, "teacher"))
        save_s["teacher"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_student(args.ckpt_dir, cfg, out["student_params"], args.steps,
                     weight_form=args.student_weight_form, agreement=out["agreement"])
        save_s["student"] = time.perf_counter() - t0
        print(f"-> {args.ckpt_dir}/teacher, {args.ckpt_dir}/student "
              f"({args.student_weight_form})")

    hist = out["history"]
    first = hist[0] if hist else float("nan")
    last = hist[-1] if hist else float("nan")
    print(f"distilled {out['student_cfg'].name}: loss {first:.3f} -> {last:.3f}, held-out "
          f"teacher-rollout agreement {out['agreement']:.3f}")
    return {"loss_history": hist, "teacher_history": out["teacher_history"],
            "agreement": out["agreement"], "arch": cfg.name,
            "student_arch": out["student_cfg"].name,
            "teacher_params": out["teacher_params"], "student_params": out["student_params"],
            "teacher_step_s": out["teacher_step_s"], "step_s": out["step_s"],
            "routes": out["routes"], "peak_memory_gb": out["peak_memory_gb"],
            "save_s": save_s}


if __name__ == "__main__":
    run()
