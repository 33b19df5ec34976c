"""Encoder-decoder backbone (Whisper-small) with its conv stem.

After `src/repro/models/encdec.py`: `init_encdec_stacks` (:32),
`conv_stem` (:70), `encode` (:84), `build_cross_cache` (:115), the prefill
and decode modes of `decoder_stack` (:124), its train mode (no caches, a
full remat region a layer) and `init_decoder_cache` (:174).
Parameters keep the reference's stacked layout (a leading layer axis on
every leaf of "enc" and "dec"); a Python loop over the layers replaces
`lax.scan`, and layer `i` reads `leaf[i]`, a view.

Log-mel frames (B, stem_stride * encoder_len, n_mels) go through Whisper's
two-conv stem: two width-`stem_width` time convs with GELU (the second
strided by `stem_stride`), routed as NHWC `conv2d` on a unit height axis
with the LUT-GELU fused at the conv's output port. Then sinusoidal
positions, the bidirectional encoder (non-causal flash), and a final norm.
The decoder carries two caches: its own self-attention KV cache and the
per-layer cross-attention K/V, built once at prefill from the encoder
output and resident through decode (the encoder output never re-crosses
the host).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import dispatched as dsp
from repro_torch.models.layers import (Params, apply_mlp, apply_norm, init_mlp, init_norm,
                                       normal, sinusoidal_positions)
from repro_torch.models.transformer import remat
from repro_torch.tree import tree_map


def init_encdec_stacks(gen: torch.Generator, cfg: ModelConfig, dtype) -> Params:
    dev, d = gen.device, cfg.d_model
    enc, dec = (cfg.n_encoder_layers,), (cfg.n_layers,)
    p = {
        "enc": {"ln1": init_norm(cfg, d, dev, enc),
                "attn": attn_lib.init_attention(gen, cfg, dtype, enc),
                "ln2": init_norm(cfg, d, dev, enc),
                "mlp": init_mlp(gen, cfg, d, cfg.d_ff, dtype, enc)},
        "enc_ln": init_norm(cfg, d, dev),
        "dec": {"ln1": init_norm(cfg, d, dev, dec),
                "self_attn": attn_lib.init_attention(gen, cfg, dtype, dec),
                "lnx": init_norm(cfg, d, dev, dec),
                "cross_attn": attn_lib.init_attention(gen, cfg, dtype, dec, cross=True),
                "ln2": init_norm(cfg, d, dev, dec),
                "mlp": init_mlp(gen, cfg, d, cfg.d_ff, dtype, dec)},
    }
    if cfg.n_mels:
        kw = cfg.stem_width
        p["stem"] = {
            "w1": normal(gen, (1, kw, cfg.n_mels, d), dtype, (kw * cfg.n_mels) ** -0.5),
            "b1": torch.zeros((d,), dtype=dtype, device=dev),
            "w2": normal(gen, (1, kw, d, d), dtype, (kw * d) ** -0.5),
            "b2": torch.zeros((d,), dtype=dtype, device=dev),
        }
    return p


def conv_stem(cfg: ModelConfig, stem: Params, frames: torch.Tensor) -> torch.Tensor:
    """(B, stem_stride*enc_len, n_mels) log-mel frames -> (B, enc_len,
    d_model): two routed NHWC convs with a unit height axis, GELU at each
    conv's output port."""
    x = frames[:, None]                              # (B, 1, T, n_mels)
    x = dsp.conv2d(x, stem["w1"], stem["b1"], stride=(1, 1), padding="SAME", act="gelu")
    x = dsp.conv2d(x, stem["w2"], stem["b2"], stride=(1, cfg.stem_stride),
                   padding="SAME", act="gelu")
    return x[:, 0]                                   # (B, enc_len, d_model)


@functools.cache
def _positions(length: int, dim: int, device: torch.device, dtype) -> torch.Tensor:
    """`sinusoidal_positions` in `dtype` on `device`, made once per shape
    (callers only read it)."""
    return sinusoidal_positions(length, dim).to(device=device, dtype=dtype)


def _layer(tree: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], tree)


def encode(cfg: ModelConfig, p: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: `cfg.frame_shape` per request — mel frames through the conv
    stem when the config has one, else (B, enc_len, d_model) embeddings."""
    if cfg.n_mels:
        frames = conv_stem(cfg, p["stem"], frames)
    x = frames + _positions(frames.shape[1], cfg.d_model, frames.device, frames.dtype)
    disp = dsp.active_dispatcher()
    for i in range(cfg.n_encoder_layers):
        unit = _layer(p["enc"], i)
        attn = unit["attn"]
        h = apply_norm(cfg, unit["ln1"], x)
        q = dsp.linear(h, attn["wq"], bias=attn.get("bq"))
        k = dsp.linear(h, attn["wk"], bias=attn.get("bk"))
        v = dsp.linear(h, attn["wv"], bias=attn.get("bv"))
        out = dsp.flash_route(disp, q, k, v, causal=False)
        x = x + dsp.linear(out, attn["wo"], n_contract=2, bias=attn.get("bo"))
        h = apply_norm(cfg, unit["ln2"], x)
        x = x + apply_mlp(cfg, unit["mlp"], h)
    return apply_norm(cfg, p["enc_ln"], x)


def build_cross_cache(cfg: ModelConfig, p: Params, enc_out: torch.Tensor) -> Params:
    """Per-layer cross K/V, stacked (L, B, enc_len, KV, dh) — computed once."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        k, v = attn_lib.encode_cross_kv(cfg, _layer(p["dec"], i)["cross_attn"], enc_out)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decoder_stack(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                  mode: str, cross: Params,
                  caches: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """train: no caches, each layer a full remat region (the reference
    checkpoints every decoder layer, :147-152); prefill: returns the stacked
    self-attention caches it built; decode: writes `caches` (the stacked
    self caches) in place and returns them."""
    def unit_fn(x, unit, cross_k, cross_v, cache):
        h = apply_norm(cfg, unit["ln1"], x)
        out, nc = attn_lib.attention_forward(cfg, unit["self_attn"], h, positions,
                                             mode=mode, cache=cache)
        x = x + out
        h = apply_norm(cfg, unit["lnx"], x)
        x = x + attn_lib.cross_attention_forward(cfg, unit["cross_attn"], h,
                                                 (cross_k, cross_v))
        h = apply_norm(cfg, unit["ln2"], x)
        return x + apply_mlp(cfg, unit["mlp"], h), nc

    if mode == "train":
        run = remat(lambda *args: unit_fn(*args, None)[0], "full")
        for i in range(cfg.n_layers):
            x = run(x, _layer(p["dec"], i), cross["k"][i], cross["v"][i])
        return x, None
    per_layer = []
    for i in range(cfg.n_layers):
        cache = _layer(caches, i) if caches is not None else None
        x, nc = unit_fn(x, _layer(p["dec"], i), cross["k"][i], cross["v"][i], cache)
        per_layer.append(nc)
    if mode == "prefill":
        return x, {name: torch.stack([c[name] for c in per_layer]) for name in per_layer[0]}
    return x, caches


def init_decoder_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Params:
    return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device, (cfg.n_layers,))


def init_cross_cache(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    """The resident cross K/V buffers of `batch` lanes (reference model.py:197-202)."""
    shape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
