"""Attention with a KV cache: GQA (prefill through flash or, for a
sliding-window layer, the blocked plain attention; decode one token) and
MLA's latent cache (DeepSeek-V3).

After `src/repro/models/attention.py`. The GQA path:
`init_attention` (:40, with QK-norm's `q_scale` / `k_scale` at :72),
`init_kv_cache` (:268, a ring of `min(max_len, attn_window)` slots for a
sliding-window layer), `_qkv` (:285, QK-norm before RoPE),
`attention_forward` (:297; a windowed layer prefills through
`chunked_attention(window=...)`, :318-323, never the flash route, and
decodes through the decode route with its window, :331-333),
`_write_prefill_cache` (:353, the last `window` positions rolled to slot
p % window when a prompt is longer), `_append_cache` (:367-403) and
`_decode_attention` (:405-435) for one token a lane and for a prefill chunk
of C tokens a lane, the forward of `chunked_attention` (:233),
which is the flash route's plain version, and the encoder-decoder's
`cross_attention_forward` / `encode_cross_kv` (:518-542).

MLA (:439-515): the MLA branches of `init_attention` (:44-60) and
`init_kv_cache` (:272-277), `_mla_qkv_latent` (:443) and `_mla_forward`
(:457), to which `attention_forward` branches first, so an MLA layer never
reaches the flash or decode routes. Prefill expands K/V from the latent
through `wkv_b` and attends through the plain `chunked_attention`; decode
and a prefill chunk append the latent `c_kv` and the shared `k_rope` to the
cache and attend in the absorbed form, scores taken in latent space. Its
projections are routed `linear`s (`wkv_b` at prefill only); the absorbed
products are plain fp32 PyTorch outside any kernel, as the reference's
einsums are, computed lane by lane: every product has the shape of one
lane whatever the number of lanes, so a lane's bits do not depend on how
many lanes run (a 16-row tree verify must equal 8-row decode).

Caches keep the reference's layout, `{"k": (B, S, KV, dh), "v": ...,
"pos": (B, S) int32}` (MLA: `{"c_kv": (B, S, kv_lora), "k_rope": (B, S,
rope), "pos"}`) with -1 marking an empty slot; position p lives at slot
p % S, so a sliding-window ring wraps. Decode writes the new token into the
cache in place: the reference's programs donate these buffers, so the port
updates them where they lie instead of copying.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp
from repro_torch.models.layers import Params, apply_rope, normal, rms_head_norm, row_sum

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype,
                   stack: tuple[int, ...] = (), cross: bool = False) -> Params:
    """The GQA projections; a `cross` attention (reference :40) takes the
    same ones (its queries from the decoder, keys and values from the
    encoder output). An MLA config's self-attention takes MLA's."""
    if cfg.use_mla and not cross:
        return _init_mla(gen, cfg, dtype, stack)
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
    if cfg.qk_norm:
        p["q_scale"] = torch.ones(stack + (dh,), dtype=torch.float32, device=gen.device)
        p["k_scale"] = torch.ones(stack + (dh,), dtype=torch.float32, device=gen.device)
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
    """One layer's cache (with `stack` leading dims for a layer group). A
    sliding-window layer keeps a ring of the window only."""
    size = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    pos = torch.full(stack + (batch, size), -1, dtype=torch.int32, device=device)
    if cfg.use_mla:
        return {"c_kv": torch.zeros(stack + (batch, size, cfg.kv_lora_rank), dtype=dtype,
                                    device=device),
                "k_rope": torch.zeros(stack + (batch, size, cfg.qk_rope_dim), dtype=dtype,
                                      device=device),
                "pos": pos}
    shape = stack + (batch, size, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
    }


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    q = dsp.linear(x, p["wq"], bias=p.get("bq"))
    k = dsp.linear(x, p["wk"], bias=p.get("bk"))
    v = dsp.linear(x, p["wv"], bias=p.get("bv"))
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_scale"])
        k = rms_head_norm(k, p["k_scale"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, *, mode: str,
                      cache: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """x (B, S, D), positions (B, S) int32. train: prefill's attention with
    no cache. prefill: attend causally through
    the flash route (a sliding-window layer: the blocked plain attention
    with its window, as the reference bypasses flash there) and return the
    new cache; decode: append the S tokens of every lane to `cache` in
    place, then attend. One token a lane (S == 1, a decode step) goes
    through the decode route; a prefill chunk (S == C) attends each query up
    to its own position through the plain `_decode_attention`, as the
    reference computes it outside any kernel. An MLA layer takes
    `_mla_forward`."""
    if cfg.use_mla:
        return _mla_forward(cfg, p, x, positions, mode=mode, cache=cache)
    q, k, v = _qkv(cfg, p, x, positions)
    disp = dsp.active_dispatcher()
    window = cfg.attn_window
    if mode in ("train", "prefill"):
        if window is None:
            out = dsp.flash_route(disp, q, k, v, causal=True)
        else:
            out = chunked_attention(q, k, v, causal=True, window=window)
        new_cache = _write_prefill_cache(k, v, positions, window) if mode == "prefill" \
            else None
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode: the tokens attend a cache")
        new_cache = _append_cache(cache, {"k": k, "v": v}, positions)
        if x.shape[1] == 1:
            out = dsp.decode_route(disp, q[:, 0], new_cache["k"], new_cache["v"],
                                   new_cache["pos"], positions[:, 0], window=window)[:, None]
        else:
            out = _decode_attention(q, new_cache, positions, window)
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', 'decode')")
    out = dsp.linear(out, p["wo"], n_contract=2, bias=p.get("bo"))
    return out, new_cache


def _write_prefill_cache(k, v, positions, window: int | None = None):
    """The prefill's cache. A prompt longer than a sliding window keeps its
    last `window` positions, rolled so that position p lies at slot
    p % window (the ring invariant: decode's next write replaces the
    oldest entry)."""
    s = positions.shape[1]
    if window and s > window:
        shift = (s - window) % window
        k, v, positions = (torch.roll(t[:, -window:], shift, dims=1) for t in (k, v, positions))
    return {"k": k, "v": v, "pos": positions}


def _append_cache(cache: Params, kv_new: Params, positions: torch.Tensor) -> Params:
    """Write the S new tokens of every lane at slots pos % size, in place.
    A chunk's positions are consecutive, so up to `size` of them land on
    distinct slots in one write; a longer chunk is written token by token,
    so later positions overwrite the oldest slots as S decode steps would
    (the reference's sequential loop)."""
    size = cache["pos"].shape[1]
    b, s = positions.shape
    bidx = torch.arange(b, device=positions.device)[:, None]
    runs = [(0, s)] if s <= size else [(i, i + 1) for i in range(s)]
    for lo, hi in runs:
        pos = positions[:, lo:hi]                      # (B, n)
        slot = (pos % size).long()
        for name, new in kv_new.items():
            cache[name][bidx, slot] = new[:, lo:hi].to(cache[name].dtype)
        cache["pos"][bidx, slot] = pos
    return cache


def _decode_attention(q, cache, positions, window: int | None = None):
    """The plain decode path (reference :405): q (B, S, H, dh) against the
    cache (B, Smax, KV, dh) under its validity mask, each query up to its own
    position: S == 1 is a decode step, S == C a prefill chunk."""
    b, sq, h, dh = q.shape
    kvh = cache["k"].shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh)
    s = torch.einsum("bqkgd,bckd->bqkgc", qg.float(), cache["k"].float()) * dh ** -0.5
    cpos = cache["pos"][:, None, :]                    # (B, 1, Smax)
    cur = positions[:, :, None]                        # (B, S, 1)
    valid = (cpos >= 0) & (cpos <= cur)
    if window:
        valid &= (cur - cpos) < window
    s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", w, cache["v"].float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): latent cache, expanded prefill, absorbed decode
# ---------------------------------------------------------------------------


def _init_mla(gen: torch.Generator, cfg: ModelConfig, dtype,
              stack: tuple[int, ...]) -> Params:
    """MLA's projections (reference :44-60): the query through a rank
    `q_lora` bottleneck, K/V through the latent of rank `kv_lora` plus one
    shared RoPE key; fp32 norms of both latents."""
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dev = gen.device
    return {
        "wq_a": normal(gen, stack + (d, ql), dtype, d ** -0.5),
        "q_norm": torch.ones(stack + (ql,), dtype=torch.float32, device=dev),
        "wq_b": normal(gen, stack + (ql, h, cfg.qk_nope_dim + cfg.qk_rope_dim), dtype,
                       ql ** -0.5),
        "wkv_a": normal(gen, stack + (d, kl + cfg.qk_rope_dim), dtype, d ** -0.5),
        "kv_norm": torch.ones(stack + (kl,), dtype=torch.float32, device=dev),
        "wkv_b": normal(gen, stack + (kl, h, cfg.qk_nope_dim + cfg.v_head_dim), dtype,
                        kl ** -0.5),
        "wo": normal(gen, stack + (h, cfg.v_head_dim, d), dtype,
                     (h * cfg.v_head_dim) ** -0.5),
    }


def latent_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """`rms_head_norm` of a latent (reference :446, :451) with the mean of
    squares taken by `row_sum`'s pairwise tree, so each row's bits are the
    same whatever the number of rows."""
    x32 = x.float()
    ms = row_sum(x32 * x32) / x32.shape[-1]
    return (x32 * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def _mla_qkv_latent(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,kv_lora), k_rope
    (B,S,rope)) (reference :443-454): `wq_a`, the norm, `wq_b`; RoPE on the
    query's rope half and on the shared key through a singleton head axis."""
    nope, kl = cfg.qk_nope_dim, cfg.kv_lora_rank
    cq = latent_norm(dsp.linear(x, p["wq_a"]), p["q_norm"])
    q = dsp.linear(cq, p["wq_b"])                                # (B,S,H,nope+rope)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    ckv_full = dsp.linear(x, p["wkv_a"])                         # (B,S,kv_lora+rope)
    c_kv = latent_norm(ckv_full[..., :kl], p["kv_norm"])
    k_rope = apply_rope(ckv_full[..., None, kl:], positions, cfg.rope_theta)[..., 0, :]
    return q[..., :nope], q_rope, c_kv, k_rope


def _absorbed_lane(q_lat, q_rope, c_kv, k_rope, cpos, qpos, scale: float) -> torch.Tensor:
    """One lane's absorbed attention (reference :487-512) in fp32, heads
    leading: scores `(q_lat·c_kv + q_rope·k_rope)·scale` (H, S, C) over the
    cache's C slots, each of the S queries masked to the valid slots up to
    its own position, the softmax, and the context in latent space
    (H, S, kv_lora)."""
    c32 = c_kv.float()
    sc = (q_lat.float() @ c32.T + q_rope.float() @ k_rope.float().T) * scale
    valid = (cpos[None, :] >= 0) & (cpos[None, :] <= qpos[:, None])     # (S, C)
    sc = sc.masked_fill(~valid, NEG_INF)
    return torch.softmax(sc, dim=-1) @ c32


def _mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                 mode: str, cache: Params | None) -> tuple[torch.Tensor, Params | None]:
    """prefill: K and V expanded from the latent through `wkv_b`, the shared
    `k_rope` broadcast over heads, V zero-padded to the query-key width, the
    plain causal `chunked_attention` at scale (nope+rope)^-0.5, V's width
    sliced back; the cache keeps the latent `{c_kv, k_rope, pos}`. decode
    (S = 1) and a prefill chunk (S = C): the S latents appended in place,
    then the absorbed form (reference :484-512): `q_lat = q_nope · w_k`
    rounded to the activation dtype (the reference's `einsum32`), the
    scores in fp32 from the cache's stored dtype, the context rounded to
    the activation dtype, then `· w_v` rounded likewise. `wo` contracts
    (H, v) either way."""
    b, s, _ = x.shape
    h, nope, dt = cfg.n_heads, cfg.qk_nope_dim, x.dtype
    scale = (nope + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(cfg, p, x, positions)
    if mode in ("train", "prefill"):
        kv = dsp.linear(c_kv, p["wkv_b"])                        # (B,S,H,nope+v)
        k = torch.cat([kv[..., :nope], k_rope[:, :, None, :].expand(b, s, h, -1)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        v = F.pad(kv[..., nope:], (0, k.shape[-1] - cfg.v_head_dim))
        out = chunked_attention(q, k, v, causal=True, scale=scale)[..., :cfg.v_head_dim]
        new_cache = {"c_kv": c_kv, "k_rope": k_rope, "pos": positions} \
            if mode == "prefill" else None
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode: the tokens attend a cache")
        new_cache = _append_cache(cache, {"c_kv": c_kv, "k_rope": k_rope}, positions)
        # the two halves of wkv_b in fp32, heads leading: (H, nope, L), (H, L, v)
        w_k = p["wkv_b"][..., :nope].permute(1, 2, 0).float().contiguous()
        w_v = p["wkv_b"][..., nope:].permute(1, 0, 2).float().contiguous()
        q_nope, q_rope = q_nope.float().transpose(1, 2), q_rope.transpose(1, 2)
        lanes = []
        for i in range(b):                                       # (H, S, ...) a lane
            q_lat = (q_nope[i] @ w_k).to(dt)
            ctx = _absorbed_lane(q_lat, q_rope[i], new_cache["c_kv"][i],
                                 new_cache["k_rope"][i], new_cache["pos"][i], positions[i],
                                 scale).to(dt)
            lanes.append((ctx.float() @ w_v).to(dt).transpose(0, 1))
        out = torch.stack(lanes)                                 # (B,S,H,v)
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', 'decode')")
    return dsp.linear(out, p["wo"], n_contract=2), new_cache


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
