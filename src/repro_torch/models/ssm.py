"""Mamba-2 / SSD (state-space duality) mixer and the depthwise causal conv.

After `src/repro/models/ssm.py`: `init_ssm` (:60), `_causal_conv` (:92,
which the RG-LRU block shares), `_ssd_chunked` (:111), `ssm_forward`
(:171) in its three modes, the gated RMS norm (:240-244) and
`init_ssm_cache` (:248). The reference's `lax.scan` over chunks is a Python
loop that carries the (B, H, P, N) state; its `tp_row_dot` is `dot` off a
mesh, here the routed `linear` (multi-device comes with the sharded slice).

Layout: x (B, L, H, P) head values; B̃/C̃ (B, L, G, N) with G groups
broadcast over heads; A (H,) negative reals; dt (B, L, H) softplus-positive.
Every projection (`w_z`, `w_x`, `w_b`, `w_c`, `w_dt`, `out_proj`) is a
routed `linear`; the conv, the scan and the norm are plain PyTorch, as the
reference computes them outside any kernel.

Decode and a prefill chunk (mode "decode", one token or C tokens a lane)
write the new state and conv tails into `cache` in place, as attention
writes its KV: the serving programs bind the resident cache and the
reference donates it. The decode step's state update is broadcast
multiplies and its read-out over N a pairwise tree (`layers.row_sum`), not
a batched GEMM whose algorithm may change with the batch, so a lane's bits
do not depend on how many lanes the step runs; the gated norm over
`d_inner` takes `layers.row_mean` for the same reason.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp
from repro_torch.models.layers import Params, normal, row_mean, row_sum


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype,
             stack: tuple[int, ...] = ()) -> Params:
    """The reference's separate projections (`w_z`, `w_x`, `w_b`, `w_c`,
    `w_dt`: one fused in_proj would cut across components under tensor
    parallelism), the two conv banks and the fp32 `dt_bias`, `a_log`,
    `d_skip` and `norm_scale`."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    std = d ** -0.5
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(stack + (h,), generator=gen, device=dev, dtype=torch.float32)
    return {
        "w_z": normal(gen, stack + (d, di), dtype, std),
        "w_x": normal(gen, stack + (d, di), dtype, std),
        "w_b": normal(gen, stack + (d, g * n), dtype, std),
        "w_c": normal(gen, stack + (d, g * n), dtype, std),
        "w_dt": normal(gen, stack + (d, h), dtype, std),
        "conv_x_w": normal(gen, stack + (cfg.ssm_conv_width, di), dtype, 0.5),
        "conv_x_b": torch.zeros(stack + (di,), dtype=dtype, device=dev),
        "conv_bc_w": normal(gen, stack + (cfg.ssm_conv_width, 2 * g * n), dtype, 0.5),
        "conv_bc_b": torch.zeros(stack + (2 * g * n,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u))),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)
                           ).expand(stack + (h,)).clone(),
        "d_skip": torch.ones(stack + (h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones(stack + (di,), dtype=torch.float32, device=dev),
        "out_proj": normal(gen, stack + (di, d), dtype, di ** -0.5),
    }


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W (reference :92). xbc (B, L, C), w
    (W, C), b (C,); `state` (B, W-1, C) the last W-1 inputs before xbc (None:
    zeros). The taps accumulate in fp32 one by one in the reference's order,
    then the bias and silu; returns (out in xbc's dtype, the new state: the
    last W-1 inputs)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    n = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + full[:, i:i + n].float() * w[i].float()
    out = out + b.float()
    new_state = full[:, full.shape[1] - (width - 1):] if width > 1 else pad
    return F.silu(out).to(xbc.dtype), new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) everywhere (`F.softplus` returns x
    itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_chunked(x, dt, a, b, c, chunk: int, init_state=None):
    """The SSD algorithm (reference :111). x (B,L,H,P), dt (B,L,H), a (H,),
    b, c (B,L,G,N). Returns (y (B,L,H,P), final state (B,H,P,N)), both fp32.
    Chunks of Q = min(chunk, L) run in order, carrying the state; one
    chunk's (B,Q,Q,H) decay tile is the only quadratic buffer."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    rep = h // g
    xc = x.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b.reshape(bsz, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    cc = c.reshape(bsz, nc, q, g, n).repeat_interleave(rep, dim=3).float()
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = init_state if init_state is not None else \
        torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        xz, dtz, bz, cz = xc[:, ci], dtc[:, ci], bc[:, ci], cc[:, ci]
        da = dtz * a                                              # (B,Q,H), negative
        da_cs = torch.cumsum(da, dim=1)
        # intra-chunk quadratic
        seg = da_cs[:, :, None, :] - da_cs[:, None, :, :]         # (B,Q,Q,H)
        decay = torch.where(causal[None, :, :, None], torch.exp(seg),
                            torch.zeros((), device=x.device))
        scores = torch.einsum("bqhn,bkhn->bqkh", cz, bz) * decay
        y = torch.einsum("bqkh,bkh,bkhp->bqhp", scores, dtz, xz)
        # contribution of the entering state
        decay_from_start = torch.exp(da_cs)                       # (B,Q,H)
        y = y + torch.einsum("bqhn,bhpn,bqh->bqhp", cz, state, decay_from_start)
        # state update to the chunk end
        decay_to_end = torch.exp(da_cs[:, -1:, :] - da_cs)        # (B,Q,H)
        inc = torch.einsum("bkh,bkh,bkhn,bkhp->bhpn", decay_to_end, dtz, bz, xz)
        chunk_decay = torch.exp(da_cs[:, -1, :])                  # (B,H)
        state = state * chunk_decay[..., None, None] + inc
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * q, h, p)[:, :l]
    return y, state


def _write(cache: Params, new: Params) -> Params:
    """The new state into the resident cache's leaves, in place."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def ssm_forward(cfg: ModelConfig, p: Params, xin: torch.Tensor, *, mode: str,
                cache: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """xin (B, S, D). train: the chunked scan from a zero state, no cache.
    prefill: the same, returns the new cache; decode with S == 1: the O(1) state update; decode with S > 1
    (a prefill chunk): the chunked scan resumed from the cache's state. Both
    decode forms write the cache in place and return it."""
    bsz, s, _ = xin.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim
    z = dsp.linear(xin, p["w_z"])
    xs = dsp.linear(xin, p["w_x"])
    bc = torch.cat([dsp.linear(xin, p["w_b"]), dsp.linear(xin, p["w_c"])], dim=-1)
    dt = dsp.linear(xin, p["w_dt"])
    a = -torch.exp(p["a_log"])                                     # (H,)
    dt = softplus(dt.float() + p["dt_bias"])

    if mode in ("train", "prefill"):
        xs, conv_x_state = causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
        bc, conv_bc_state = causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
        x = xs.reshape(bsz, s, h, pdim)
        b = bc[..., :g * n].reshape(bsz, s, g, n)
        c = bc[..., g * n:].reshape(bsz, s, g, n)
        y, state = ssd_chunked(x, dt, a, b, c, cfg.ssm_chunk)
        y = y + x.float() * p["d_skip"][None, None, :, None]
        new_cache = {"state": state.to(xin.dtype), "conv_x": conv_x_state,
                     "conv_bc": conv_bc_state} if mode == "prefill" else None
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode: the SSM steps from a cache")
        xs, conv_x_state = causal_conv(xs, p["conv_x_w"], p["conv_x_b"],
                                       state=cache["conv_x"])
        bc, conv_bc_state = causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                        state=cache["conv_bc"])
        if s == 1:                                                 # O(1) state update
            x = xs.reshape(bsz, h, pdim)                           # (B,H,P)
            b = bc[:, 0, :g * n].reshape(bsz, g, n)
            c = bc[:, 0, g * n:].reshape(bsz, g, n)
            rep = h // g
            bh = b.repeat_interleave(rep, dim=1).float()           # (B,H,N)
            ch = c.repeat_interleave(rep, dim=1).float()
            dt1 = dt[:, 0]                                         # (B,H)
            decay = torch.exp(dt1 * a)                             # (B,H)
            state = cache["state"].float()
            state = state * decay[..., None, None] + \
                dt1[:, :, None, None] * bh[:, :, None, :] * x.float()[..., None]
            y = row_sum(ch[:, :, None, :] * state)[..., 0]         # (B,H,P)
            y = y + x.float() * p["d_skip"][:, None]
            y = y[:, None]                                         # (B,1,H,P)
        else:                                                      # a prefill chunk
            x = xs.reshape(bsz, s, h, pdim)
            b = bc[..., :g * n].reshape(bsz, s, g, n)
            c = bc[..., g * n:].reshape(bsz, s, g, n)
            y, state = ssd_chunked(x, dt, a, b, c, cfg.ssm_chunk,
                                   init_state=cache["state"].float())
            y = y + x.float() * p["d_skip"][None, None, :, None]
        new_cache = _write(cache, {"state": state.to(xin.dtype), "conv_x": conv_x_state,
                                   "conv_bc": conv_bc_state})
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', 'decode')")

    # gated RMS norm + out projection
    y = y.reshape(bsz, -1, di)
    gated = y * F.silu(z.float())
    ms = row_mean(gated * gated)
    y = (gated * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(xin.dtype)
    return dsp.linear(y, p["out_proj"]), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device,
                   stack: tuple[int, ...] = ()) -> Params:
    """One layer's recurrent state and conv tails (`stack` leading dims for
    a layer group): no time axis."""
    def zeros(*shape):
        return torch.zeros(stack + (batch,) + shape, dtype=dtype, device=device)
    return {"state": zeros(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            "conv_x": zeros(cfg.ssm_conv_width - 1, cfg.d_inner),
            "conv_bc": zeros(cfg.ssm_conv_width - 1, 2 * cfg.ssm_groups * cfg.ssm_state)}
