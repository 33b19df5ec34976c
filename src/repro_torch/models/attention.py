"""GQA attention with a KV cache: prefill through flash, decode one token.

After `src/repro/models/attention.py`, the non-MLA, no-window path:
`init_kv_cache` (:268), `_qkv` (:285), `attention_forward` (:297),
`_write_prefill_cache` (:353), the one-token `_append_cache` (:367-384),
`_decode_attention` (:405), the forward of `chunked_attention` (:233),
which is the flash route's plain version, and the encoder-decoder's
`cross_attention_forward` / `encode_cross_kv` (:518-542).

Caches keep the reference's layout, `{"k": (B, S, KV, dh), "v": ...,
"pos": (B, S) int32}` with -1 marking an empty slot. Decode writes the new
token into the cache in place: the reference's programs donate these
buffers, so the port updates them where they lie instead of copying.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp
from repro_torch.models.layers import Params, apply_rope, normal

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   stack: tuple[int, ...] = (), cross: bool = False) -> Params:
    """The GQA projections; a `cross` attention (reference :40) takes the
    same ones (its queries from the decoder, keys and values from the
    encoder output)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    std = d ** -0.5
    p = {
        "wq": normal(gen, stack + (d, h, dh), dtype, std),
        "wk": normal(gen, stack + (d, kv, dh), dtype, std),
        "wv": normal(gen, stack + (d, kv, dh), dtype, std),
        "wo": normal(gen, stack + (h, dh, d), dtype, (h * dh) ** -0.5),
    }
    if cfg.use_bias:
        dev = gen.device
        p["bq"] = torch.zeros(stack + (h, dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(stack + (kv, dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(stack + (kv, dh), dtype=dtype, device=dev)
        p["bo"] = torch.zeros(stack + (d,), dtype=dtype, device=dev)
    return p


# ---------------------------------------------------------------------------
# Blocked online-softmax attention (the flash route's plain version)
# ---------------------------------------------------------------------------


def _mask_for(qpos, kpos, causal, window, skv):
    if causal:
        allow = kpos[None, :] <= qpos[:, None]
    else:
        allow = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                           device=qpos.device)
    if window is not None:
        allow &= (qpos[:, None] - kpos[None, :]) < window
    allow &= (kpos < skv)[None, :]
    return allow


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_chunk: int = 1024,
                      kv_chunk: int = 1024, scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, dh), k/v (B, Skv, KV, dh): Q blocks x KV blocks with a
    running (max, denominator, accumulator) in fp32; the score tile is the
    only live intermediate. The reference's `lax.scan`s are Python loops."""
    b, sq, h, dh = q.shape
    _, skv, kvh, _ = k.shape
    g = h // kvh
    scale = scale if scale is not None else dh ** -0.5
    q_chunk = min(q_chunk, max(sq, 1))
    kv_chunk = min(kv_chunk, max(skv, 1))
    dev = q.device
    qg = q.reshape(b, sq, kvh, g, dh)
    blocks = []
    for q0 in range(0, sq, q_chunk):
        qblk = qg[:, q0:q0 + q_chunk].float()
        nq = qblk.shape[1]
        qpos = torch.arange(q0, q0 + nq, device=dev)
        m = torch.full((b, nq, kvh, g), NEG_INF, device=dev)
        l = torch.zeros((b, nq, kvh, g), device=dev)
        acc = torch.zeros((b, nq, kvh, g, dh), device=dev)
        for k0 in range(0, skv, kv_chunk):
            kblk = k[:, k0:k0 + kv_chunk].float()
            vblk = v[:, k0:k0 + kv_chunk].float()
            kpos = torch.arange(k0, k0 + kblk.shape[1], device=dev)
            s = torch.einsum("bqkgd,bckd->bqkgc", qblk, kblk) * scale
            allow = _mask_for(qpos, kpos, causal, window, skv)
            s = s.masked_fill(~allow[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vblk)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.to(q.dtype))
    return torch.cat(blocks, dim=1).reshape(b, sq, h, dh)


# ---------------------------------------------------------------------------
# GQA forward: prefill / decode
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device, stack: tuple[int, ...] = ()) -> Params:
    """One layer's cache (with `stack` leading dims for a layer group)."""
    shape = stack + (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(stack + (batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    q = dsp.linear(x, p["wq"], bias=p.get("bq"))
    k = dsp.linear(x, p["wk"], bias=p.get("bk"))
    v = dsp.linear(x, p["wv"], bias=p.get("bv"))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, *, mode: str,
                      cache: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """x (B, S, D), positions (B, S) int32. prefill: attend causally through
    the flash route and return the new cache; decode (S == 1): append to
    `cache` in place and attend through the decode route."""
    q, k, v = _qkv(cfg, p, x, positions)
    disp = dsp.active_dispatcher()
    if mode == "prefill":
        out = dsp.flash_route(disp, q, k, v, causal=True)
        new_cache = _write_prefill_cache(k, v, positions)
    elif mode == "decode":
        if cache is None or x.shape[1] != 1:
            raise ValueError("decode: one token per lane against a cache")
        new_cache = _append_cache(cache, {"k": k, "v": v}, positions)
        out = dsp.decode_route(disp, q[:, 0], new_cache["k"], new_cache["v"],
                               new_cache["pos"], positions[:, 0])[:, None]
    else:
        raise ValueError(f"mode {mode!r}: the port serves prefill and decode")
    out = dsp.linear(out, p["wo"], n_contract=2, bias=p.get("bo"))
    return out, new_cache


def _write_prefill_cache(k, v, positions):
    return {"k": k, "v": v, "pos": positions}


def _append_cache(cache: Params, kv_new: Params, positions: torch.Tensor) -> Params:
    """Write the one new token of every lane at slot pos % size, in place."""
    size = cache["pos"].shape[1]
    pos = positions[:, 0]                              # (B,)
    slot = (pos % size).long()
    bidx = torch.arange(pos.shape[0], device=pos.device)
    for name, new in kv_new.items():
        cache[name][bidx, slot] = new[:, 0].to(cache[name].dtype)
    cache["pos"][bidx, slot] = pos
    return cache


def _decode_attention(q, cache, positions, window: int | None = None):
    """The plain decode path, q (B, 1, H, dh) against cache (B, Smax, KV, dh)
    with the validity mask (reference :405, one-token case)."""
    b, sq, h, dh = q.shape
    if sq != 1:
        raise ValueError("the port's plain decode path takes one token per lane")
    kvh = cache["k"].shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, dh)
    s = torch.einsum("bqkgd,bckd->bkgc", qg.float(), cache["k"].float()) * dh ** -0.5
    cur = positions[:, 0][:, None]
    valid = (cache["pos"] >= 0) & (cache["pos"] <= cur)
    if window:
        valid &= (cur - cache["pos"]) < window
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w, cache["v"].float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                            enc_kv: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder stream x (B, S, D) against the encoder's precomputed (k, v)
    (B, enc_len, KV, dh): non-causal through the flash route, no RoPE."""
    q = dsp.linear(x, p["wq"], bias=p.get("bq"))
    k, v = enc_kv
    out = dsp.flash_route(dsp.active_dispatcher(), q, k, v, causal=False)
    return dsp.linear(out, p["wo"], n_contract=2, bias=p.get("bo"))


def encode_cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor):
    k = dsp.linear(enc_out, p["wk"], bias=p.get("bk"))
    v = dsp.linear(enc_out, p["wv"], bias=p.get("bv"))
    return k, v
