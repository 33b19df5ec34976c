"""Common layers: norms (and QK-norm's per-head RMS norm), RoPE, the MLPs,
embeddings, the logits head and the encoder's sinusoidal positions.

After `src/repro/models/layers.py`. Parameters are plain dicts of tensors
with the reference's names, shapes and dtypes; `init_*` draw from the same
distributions at the same scales, from an explicit `torch.Generator` (the
numbers differ from `jax.random`'s, so the tests bridge the reference's own
parameters in). Numerics follow the reference: norms and RoPE compute in
fp32 and round once; every matmul is a routed `linear` (fp32 accumulator in
the kernel); the logits head runs in fp32.
"""

from __future__ import annotations

import weakref
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp

Params = dict[str, Any]


def normal(gen: torch.Generator, shape, dtype, std: float) -> torch.Tensor:
    """`jax.random.normal(key, shape, dtype) * std`: a standard normal draw
    in `dtype`, scaled in `dtype` (in place: the same bits as `* std`, and
    one copy fewer alive at once, which a 3.8 B-element expert bank needs)."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.to(dtype).mul_(std)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: int, device, stack: tuple[int, ...] = ()) -> Params:
    p = {"scale": torch.ones(stack + (dim,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(stack + (dim,), dtype=torch.float32, device=device)
    return p


# Rows up to this width take a norm's mean in torch's one reduction over
# the row: at tinyllama's 2048 it gives the same bits at 8 and 16 rows on
# the H100 (the rows phase checks it every run), and the serve digests fix
# its bits. torch sizes a reduction's block from the row count below 16
# rows, so wider rows (granite's 4096 to command-r's 8192) measured other
# bits at 8 rows than at 16 on the H100, and take the mean as a pairwise
# tree.
ONE_REDUCTION_MAX_WIDTH = 2048


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, kept as a dim of 1: a pairwise tree of
    elementwise adds (the width zero-padded to a power of two, halves
    added), so every row's bits are the same whatever the number of rows."""
    d = x.shape[-1]
    width = 1 << (d - 1).bit_length()
    if width != d:
        x = F.pad(x, (0, width - d))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x


def row_mean(x32: torch.Tensor) -> torch.Tensor:
    """A norm's fp32 mean over the last dim, kept as a dim of 1."""
    if x32.shape[-1] <= ONE_REDUCTION_MAX_WIDTH:
        return x32.mean(-1, keepdim=True)
    return row_sum(x32) / x32.shape[-1]


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = row_mean(x32)
        var = row_mean((x32 - mu) ** 2)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p.get("bias", 0.0)
    else:  # rmsnorm
        ms = row_mean(x32 * x32)
        y = x32 * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm of QK-norm (chameleon's stability recipe; reference
    :71): fp32 mean over the head dim, rsqrt, the fp32 scale, back to x's
    dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) * scale
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
    """The table's rows of `tokens`. `F.embedding`'s backward on CUDA sums
    a repeated token's rows without atomics (a per-feature loop over the
    tokens, or a sort and a segment sum), so two steps from one state give
    the same table gradient bit for bit; `index_select`'s backward
    (`index_add_`) would not."""
    return F.embedding(tokens.reshape(-1).long(), p["table"]).reshape(tokens.shape + (-1,))


# (id(head parameter), transposed) -> (weak reference to it, its version,
# its fp32 copy)
_FP32_HEADS: dict[tuple[int, bool], tuple[weakref.ref, int, torch.Tensor]] = {}


def fp32_head(w: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The head weight `w` (or its transpose, a tied table's) as a
    contiguous fp32 (d, V) tensor: the same values the fp32 `anemm` would
    widen it to, made once per head parameter and kept while the parameter
    lives, so neither each forward nor each captured program's private pool
    holds a copy of its own (recurrentgemma's 256,000 x 4,096 head is 4.2 GB
    in fp32). A copy made during a CUDA-graph capture is not kept: its
    contents exist only in the graph's replays. A head changed in place
    after its first forward raises. A head that gradients flow into (a
    training step's) is widened anew each call and never kept: its copy
    belongs to that step's graph."""
    if w.requires_grad and torch.is_grad_enabled():
        return (w.T if transpose else w).to(torch.float32,
                                             memory_format=torch.contiguous_format)
    key = (id(w), transpose)
    hit = _FP32_HEADS.get(key)
    if hit is not None and hit[0]() is w:
        if hit[1] != w._version:
            raise RuntimeError("the head weight changed in place after its fp32 copy was made")
        return hit[2]
    wide = (w.T if transpose else w).to(torch.float32, memory_format=torch.contiguous_format)
    if wide is w or (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        return wide
    _FP32_HEADS[key] = (weakref.ref(w, lambda _, key=key: _FP32_HEADS.pop(key, None)),
                        w._version, wide)
    return wide


def logits(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Always fp32 out: the routed head runs the whole matmul in fp32 (an
    fp32 `anemm`), so the anchor holds although the kernel stores in its
    input dtype. A dense `unembed` (or tied table) enters as its fp32 copy
    (`fp32_head`); a packed `unembed` runs the fp32 `palette` / `sparse`
    kernel instead."""
    w = p["table"] if cfg.tie_embeddings else p["unembed"]
    if isinstance(w, torch.Tensor):
        w = fp32_head(w, transpose=cfg.tie_embeddings)
    return dsp.linear(x.float(), w)


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings for the encoder frames: computed
    in numpy float64 and cast to float32, as the reference computes them."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32))
