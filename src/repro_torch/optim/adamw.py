"""AdamW: decoupled weight decay, cosine schedule, global-norm clipping,
fp32 master arithmetic over low-precision params.

After `src/repro/optim/adamw.py`: `AdamWConfig` (:19), `schedule` (:37),
`init_state` (:52), `global_norm` (:62) and `apply_updates` (:68). Every
quantity is a float32 tensor computed in the reference's order (a Python
constant folds first where the reference's Python folds it, then enters as
a float32 operand), so a step matches the reference's within float32
rounding of its transcendental functions. Trees walk in `repro_torch.tree`
order, which is `jax.tree`'s (dict keys sorted).

`apply_updates` returns new trees and leaves its arguments as they are;
`launch.train.make_train_step` writes the results into the resident params
and state in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" halves state memory
    # "cosine" decays to min_lr_ratio * peak over total_steps; "constant"
    # holds peak_lr after warmup
    schedule_kind: str = "cosine"


def _reciprocal(n: int) -> np.float32:
    """1 / n in float32, as XLA folds a division by the constant n."""
    return np.float32(1) / np.float32(max(n, 1))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to min_lr_ratio * peak or constant peak;
    `step` an integer tensor, the result a float32 tensor on its device.

    The arithmetic is that of the reference's compiled step: XLA turns each
    division by a constant into a product by its float32 reciprocal, folds
    the warmup's `peak * step / warmup` into `step * (peak * (1 / warmup))`
    and contracts the cosine's `min + c * (1 + cos)` into one fused
    multiply-add (here in float64, exact before its one rounding); its
    float32 cosine is the correctly rounded one (torch's own float32 cos
    can be an ulp off it)."""
    if cfg.schedule_kind not in ("cosine", "constant"):
        raise ValueError(f"schedule_kind {cfg.schedule_kind!r} "
                         f"not in ('cosine', 'constant')")
    step = step.to(torch.float32)
    warm = step * float(np.float32(cfg.peak_lr) * _reciprocal(cfg.warmup_steps))
    if cfg.schedule_kind == "constant":
        return torch.where(step < cfg.warmup_steps, warm, _f32(cfg.peak_lr, step))
    prog = torch.clamp((step - cfg.warmup_steps)
                       * float(_reciprocal(cfg.total_steps - cfg.warmup_steps)), 0, 1)
    c = float(np.float32((1 - cfg.min_lr_ratio) * 0.5))
    cos32 = torch.cos((math.pi * prog).double()).float()     # float32 cos, rounded once
    cos = ((1 + cos32).double() * c + float(np.float32(cfg.min_lr_ratio))).float()
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def init_state(cfg: AdamWConfig, params) -> dict[str, Any]:
    """{"step": int32 0, "m": zeros like params, "v": zeros like params},
    the moments in `cfg.moment_dtype`, on each param's device."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    first = leaves_with_path(params)[0][1]
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for _, x in leaves_with_path(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _update(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c):
    """One leaf (reference `upd`, :77): the new (p, m, v) in their dtypes."""
    g32 = g.float() * scale
    m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g32 * g32
    mh = m32 / b1c
    vh = v32 / b2c
    delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
    newp = p.float() - lr * delta
    return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step. Returns (new_params, new_state, metrics); the metrics
    are the step's `lr` and the clipped gradients' pre-clip `grad_norm`."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    # a true division (a Python number over a tensor multiplies by the
    # reciprocal in torch)
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    step32 = step.to(torch.float32)
    b1c = 1 - _f32(cfg.b1, step32) ** step32
    b2c = 1 - _f32(cfg.b2, step32) ** step32
    new = tree_map(lambda p, g, m, v: _update(cfg, p, g, m, v, scale, lr, b1c, b2c),
                   params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], new, is_leaf=lambda t: isinstance(t, tuple))  # noqa: E731
    new_state = {"step": step, "m": pick(1), "v": pick(2)}
    return pick(0), new_state, {"lr": lr, "grad_norm": gnorm}
