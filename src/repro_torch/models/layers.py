"""Common layers: norms, RoPE, the MLPs, embeddings, the logits head and the
encoder's sinusoidal positions.

After `src/repro/models/layers.py`. Parameters are plain dicts of tensors
with the reference's names, shapes and dtypes; `init_*` draw from the same
distributions at the same scales, from an explicit `torch.Generator` (the
numbers differ from `jax.random`'s, so the tests bridge the reference's own
parameters in). Numerics follow the reference: norms and RoPE compute in
fp32 and round once; every matmul is a routed `linear` (fp32 accumulator in
the kernel); the logits head runs in fp32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp

Params = dict[str, Any]


def normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype) * std`: a standard normal draw
    in `dtype`, scaled in `dtype`."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.to(dtype) * std


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: int, device, stack: tuple[int, ...] = ()) -> Params:
    p = {"scale": torch.ones(stack + (dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(stack + (dim,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p.get("bias", 0.0)
    else:  # rmsnorm
        ms = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves: the first and second half of the head dim rotate as
# pairs, not interleaved even/odd lanes)
# ---------------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    angles = positions[..., None].float() * freqs          # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs: the GLU path and the plain two-matrix gelu MLP (`act="gelu_mlp"`)
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh approximation (not the erf form)."""
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d: int, f: int, dtype,
             stack: tuple[int, ...] = ()) -> Params:
    std_in, std_out = d ** -0.5, f ** -0.5
    if cfg.act == "gelu_mlp":                           # plain 2-matrix MLP
        p = {"wi": normal(gen, stack + (d, f), dtype, std_in),
             "wo": normal(gen, stack + (f, d), dtype, std_out)}
        if cfg.use_bias:
            p["bi"] = torch.zeros(stack + (f,), dtype=dtype, device=gen.device)
            p["bo"] = torch.zeros(stack + (d,), dtype=dtype, device=gen.device)
        return p
    return {"wg": normal(gen, stack + (d, f), dtype, std_in),
            "wu": normal(gen, stack + (d, f), dtype, std_in),
            "wd": normal(gen, stack + (f, d), dtype, std_out)}


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if "wi" in p:                                       # plain MLP
        h = gelu(dsp.linear(x, p["wi"], bias=p.get("bi")))
        return dsp.linear(h, p["wo"], bias=p.get("bo"))
    act = _ACTS.get(cfg.act, F.silu)
    g = act(dsp.linear(x, p["wg"]))
    u = dsp.linear(x, p["wu"])
    return dsp.linear(g * u, p["wd"])


# ---------------------------------------------------------------------------
# Embedding / logits head
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    v = cfg.padded_vocab
    p = {"table": normal(gen, (v, cfg.d_model), dtype, 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal(gen, (cfg.d_model, v), dtype, cfg.d_model ** -0.5)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    flat = tokens.reshape(-1).long()
    return p["table"].index_select(0, flat).reshape(tokens.shape + (-1,))


def logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Always fp32 out: the routed head runs the whole matmul in fp32 (an
    fp32 `anemm`), so the anchor holds although the kernel stores in its
    input dtype. Each call widens a dense bf16 `unembed` to an fp32 copy; a
    packed `unembed` runs the fp32 `palette` / `sparse` kernel instead."""
    w = p["table"].T if cfg.tie_embeddings else p["unembed"]
    return dsp.linear(x.float(), w)


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings for the encoder frames: computed
    in numpy float64 and cast to float32, as the reference computes them."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32))
