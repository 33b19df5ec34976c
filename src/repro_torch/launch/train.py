"""The port's training CLI: one eager train step, fault-tolerant, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --device cpu --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 30 --batch 8 --seq 128 --ckpt-dir CKPT_DIR

After `src/repro/launch/train.py` (`make_train_step` :35, `run` :78), with
the reference's flags but `--mesh` (multi-device training comes with the
sharded slice) and with the port's `--device` (default `cuda`, as the serve
CLI's). On `--device cuda` the kernels are built first with nvcc if missing
and every dense matmul, full-causal attention and conv of the forward runs
its hand-written CUDA kernel (`models.dispatched`); the backward is plain
fp32 products with TF32 off (the reference has no Pallas backward).
Without a CUDA device and without `--device cpu` the CLI exits with an
error instead of falling back.

A step is eager: the loss, `torch.autograd.grad` over every param leaf (a
leaf the loss does not reach gets zeros, as `jax.grad` gives it), the
optional int8 error-feedback round trip (`--grad-compression int8`), then
AdamW; the params and the optimizer state are written in place, so they
stay resident across steps. Batches come from the seeded synthetic
pipeline (`data.pipeline`: batch t is a pure function of (seed, t), the
reference's bit for bit). With `--ckpt-dir` the state `(params, opt_state)`
is saved asynchronously every `--ckpt-every` steps and once at the end, in
the reference's layout (`checkpoint.CheckpointManager`); the supervisor
(`runtime.fault_tolerance.run_with_restarts`) restarts a crashed run from
the latest committed step, and the pipeline makes the resumed steps those
of an uninterrupted run.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable

import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.data.pipeline import make_pipeline
from repro_torch.kernels import native
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_grads, decompress_grads, init_residual
from repro_torch.runtime.fault_tolerance import RestartPolicy, Watchdog, run_with_restarts
from repro_torch.tree import leaves_with_path, tree_map


def _unflatten_like(tree: Any, flat: list) -> Any:
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def _copy_into(dst: Any, src: Any) -> None:
    for (_, d), (_, s) in zip(leaves_with_path(dst), leaves_with_path(src)):
        d.copy_(s)


def make_train_step(model, opt_cfg: adamw.AdamWConfig, grad_compression: str = "none", *,
                    loss_fn: Callable | None = None) -> Callable:
    """`train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`: loss -> grads -> (optional int8 error-feedback compression
    round trip) -> AdamW, the params and state updated in place and
    returned. `loss_fn(params, batch) -> (loss, metrics)` overrides
    `model.loss` (the distillation driver's hook, reference :44-49)."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {grad_compression!r} not in ('none', 'int8')")
    loss_fn = model.loss if loss_fn is None else loss_fn

    def train_step(params, opt_state: dict, batch: dict):
        leaves = [t for _, t in leaves_with_path(params)]
        for t in leaves:
            t.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = loss_fn(params, batch)
                got = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        with torch.no_grad():
            grads = _unflatten_like(params, [torch.zeros_like(t) if g is None else g
                                             for t, g in zip(leaves, got)])
            if grad_compression == "int8":
                comp, residual = compress_grads(grads, opt_state.get("residual"))
                grads = decompress_grads(comp, grads)
                _copy_into(opt_state["residual"], residual)
            new_p, new_opt, om = adamw.apply_updates(
                opt_cfg, params, grads, {k: opt_state[k] for k in ("step", "m", "v")})
            _copy_into(params, new_p)
            _copy_into({k: opt_state[k] for k in ("step", "m", "v")}, new_opt)
        return params, opt_state, {**{k: v.detach() for k, v in metrics.items()}, **om}

    return train_step


def run(argv=None, *, cfg=None) -> dict:
    """Train; returns the reference's dict (`final_step`, `loss_history`
    every `--log-every` steps, `final_loss`) plus `step_s` (every step's
    wall, synchronized), `save_s` (each save's wall: the final `save`'s, and
    an async save's snapshot), `routes` (the dispatcher's census),
    `restarts` (the repr of each exception the supervisor restarted after;
    `loss_history` and `step_s` then hold the steps of every attempt) and
    `peak_memory_gb` on the card. `cfg` trains a given config in place of
    the registered one (its name must be that of `--arch`): the library
    entry point for a depth-cut copy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.ARCH_NAMES + ["ane-paper"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels; cpu: their plain PyTorch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available "
                 "(pass --device cpu to run the plain versions on the CPU)")

    named = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if cfg is not None and cfg.name != named.name:
        raise ValueError(f"cfg {cfg.name!r} is not --arch {args.arch!r} ({named.name!r})")
    cfg = named if cfg is None else cfg
    device = torch.device(args.device)
    if device.type == "cuda":
        native.build()
        # the backward's plain products in full fp32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    dispatcher = KernelDispatcher()
    model = build_model(cfg, dispatcher, device=device)
    opt_cfg = adamw.AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                                total_steps=args.steps)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    pipe_src = make_pipeline(cfg, args.seq, args.batch, seed=args.seed)
    step_fn = make_train_step(model, opt_cfg, args.grad_compression)
    history: list[float] = []
    step_s: list[float] = []
    save_s: list[float] = []

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def save(step: int, state, *, wait: bool) -> None:
        t0 = time.perf_counter()
        (mgr.save if wait else mgr.save_async)(step, state)
        save_s.append(time.perf_counter() - t0)

    def training_run(start_step: int) -> int:
        params = model.init(torch.Generator(device=device).manual_seed(args.seed))
        opt_state = adamw.init_state(opt_cfg, params)
        if args.grad_compression == "int8":
            opt_state["residual"] = init_residual(params)
        step = 0
        if mgr is not None:
            mgr.wait()                    # an async save in flight commits first
        if start_step == -1 and mgr is not None and mgr.latest_step() is not None:
            (params, opt_state), step = mgr.restore((params, opt_state))
        watchdog = Watchdog(deadline_s=600.0)
        t_start = time.perf_counter()
        while step < args.steps:
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe_src._source.batch(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            sync()
            step_s.append(time.perf_counter() - t0)
            watchdog.poke()
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                loss = float(metrics["loss"])
                history.append(loss)
                dt = (time.perf_counter() - t_start) / step
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.1f} ms/step", flush=True)
            if mgr is not None and step % args.ckpt_every == 0:
                save(step, (params, opt_state), wait=False)
        if mgr is not None:
            save(args.steps, (params, opt_state), wait=True)
        return step

    restarts: list[str] = []
    final = run_with_restarts(training_run, policy=RestartPolicy(max_restarts=2),
                              on_restart=lambda n, e: restarts.append(repr(e)))
    pipe_src.close()
    out = {"final_step": final, "loss_history": history,
           "final_loss": history[-1] if history else float("nan"),
           "step_s": step_s, "save_s": save_s, "routes": dispatcher.census(),
           "restarts": restarts}
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


if __name__ == "__main__":
    result = run()
    print(f"done: step {result['final_step']} final loss {result['final_loss']:.4f}")
