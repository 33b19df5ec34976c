"""Analytic cost model: parameters, FLOPs, and bytes per (arch x shape).

A copy of `src/repro/core/costmodel.py` (plain Python, every formula
unchanged), over the port's own `configs.base`. It prices nothing by itself:
a caller divides its counts by a target's rates (`core.hal.H100`), as the
prefix pool's eviction cost does (`launch.scheduler._re_prefill_cost`).

This is the napkin-math layer the paper's placement planner runs on
(§5.3: cost = max(flops/gflops, bytes/bw) + launch + transfer) and the source
of MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) that the roofline
analysis compares against compiled HLO_FLOPs.

All counts are *global* (whole step across the mesh); divide by chip count
for per-chip figures.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig

# ---------------------------------------------------------------------------
# Parameter counts
# ---------------------------------------------------------------------------


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.use_mla:
        qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
        p = d * cfg.q_lora_rank                       # W_q_a
        p += cfg.q_lora_rank * cfg.n_heads * qk_head  # W_q_b
        p += d * (cfg.kv_lora_rank + cfg.qk_rope_dim)  # W_kv_a (+ shared rope key)
        p += cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)  # W_kv_b
        p += cfg.n_heads * cfg.v_head_dim * d         # W_o
        return p
    dh, h, kv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    return d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d


def _mlp_params(d: int, f: int, act: str) -> int:
    # GLU MLPs (silu/gelu gate) carry 3 matrices; plain MLPs carry 2.
    return (3 if act != "gelu_mlp" else 2) * d * f


def _ssm_params(cfg: ModelConfig) -> int:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    g = cfg.ssm_groups
    p = d * (2 * di + 2 * g * n + cfg.ssm_heads)      # in_proj: z, x, B, C, dt
    p += cfg.ssm_conv_width * (di + 2 * g * n)        # conv1d over x,B,C
    p += cfg.ssm_heads * 2                            # A_log, D
    p += di * d                                       # out_proj
    p += di                                           # gated norm
    return p


def _rglru_params(cfg: ModelConfig) -> int:
    d, w = cfg.d_model, cfg.lru_width
    p = 2 * d * w                                     # linear_x, linear_y (in)
    p += w * d                                        # out proj
    p += cfg.ssm_conv_width * w if cfg.ssm_conv_width else 4 * w  # temporal conv
    p += 2 * w                                        # recurrent + input gates (diag) params: a_param, gates
    p += 2 * w * w // max(1, w // w)                  # gate projections (per-channel block): use w*w light
    return p


def layer_params(cfg: ModelConfig, layer_idx: int) -> int:
    """Parameters of one decoder layer (norms excluded; negligible)."""
    kind = cfg.block_kind(layer_idx)
    if kind == "ssm":
        return _ssm_params(cfg)
    p = 0
    if kind == "rglru":
        p += _rglru_params(cfg)
    else:
        p += _attn_params(cfg)
    # MLP / MoE
    if cfg.layer_is_moe(layer_idx):
        p += cfg.n_experts * _mlp_params(cfg.d_model, cfg.d_ff_expert, cfg.act)
        p += cfg.n_shared_experts * _mlp_params(cfg.d_model, cfg.d_ff_expert, cfg.act)
        p += cfg.d_model * cfg.n_experts              # router
    else:
        p += _mlp_params(cfg.d_model, cfg.d_ff, cfg.act)
    return p


def layer_active_params(cfg: ModelConfig, layer_idx: int) -> int:
    """Parameters touched per token (MoE: only routed-to experts)."""
    kind = cfg.block_kind(layer_idx)
    if kind == "ssm":
        return _ssm_params(cfg)
    p = _rglru_params(cfg) if kind == "rglru" else _attn_params(cfg)
    if cfg.layer_is_moe(layer_idx):
        p += cfg.experts_per_token * _mlp_params(cfg.d_model, cfg.d_ff_expert, cfg.act)
        p += cfg.n_shared_experts * _mlp_params(cfg.d_model, cfg.d_ff_expert, cfg.act)
        p += cfg.d_model * cfg.n_experts
    else:
        p += _mlp_params(cfg.d_model, cfg.d_ff, cfg.act)
    return p


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (embeddings + layers + head)."""
    p = cfg.padded_vocab * cfg.d_model                # embedding
    if not cfg.tie_embeddings:
        p += cfg.padded_vocab * cfg.d_model           # unembedding
    for i in range(cfg.n_layers):
        p += layer_params(cfg, i)
    if cfg.n_encoder_layers:
        for _ in range(cfg.n_encoder_layers):
            # encoder layer: self-attn + MLP; decoder layers above additionally
            # carry cross-attention.
            p += _attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff, cfg.act)
        p += cfg.n_layers * _attn_params(cfg)         # cross-attn in decoder
        if cfg.n_mels:                                # conv stem (+ biases)
            p += cfg.stem_width * (cfg.n_mels + cfg.d_model) * cfg.d_model
            p += 2 * cfg.d_model
    if cfg.mtp_depth:
        p += cfg.mtp_depth * (layer_params(cfg, cfg.n_layers - 1)
                              + 2 * cfg.d_model * cfg.d_model)
    return p


def active_param_count(cfg: ModelConfig) -> int:
    p = cfg.padded_vocab * cfg.d_model
    if not cfg.tie_embeddings:
        p += cfg.padded_vocab * cfg.d_model
    for i in range(cfg.n_layers):
        p += layer_active_params(cfg, i)
    if cfg.n_encoder_layers:
        p += cfg.n_encoder_layers * (_attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff, cfg.act))
        p += cfg.n_layers * _attn_params(cfg)
        if cfg.n_mels:
            p += cfg.stem_width * (cfg.n_mels + cfg.d_model) * cfg.d_model
            p += 2 * cfg.d_model
    return p


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS for the roofline's usefulness ratio.

    train: 6 * N_active * tokens (fwd 2x + bwd 4x), the assignment's formula.
    prefill: 2 * N_active * tokens.
    decode: 2 * N_active * tokens (one token per sequence).
    Attention score/value FLOPs are excluded here by convention (6ND), and
    reported separately by `attention_flops`.
    """
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * n_active * tokens


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Score+value matmul FLOPs (the part 6ND misses)."""
    if cfg.family == "ssm":
        return 0.0
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.block_kind(i) == "attn")
    dh = cfg.d_head if not cfg.use_mla else (cfg.qk_nope_dim + cfg.qk_rope_dim)
    h = cfg.n_heads
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        ctx = min(s, cfg.attn_window or s)
        fl = 2.0 * 2.0 * h * dh * ctx * b * n_attn    # scores + values per token
        return fl
    ctx = s if cfg.attn_window is None else min(s, cfg.attn_window)
    # causal: ~ S * ctx / 2 pairs
    pairs = b * s * ctx * (0.5 if cfg.attn_window is None else 1.0)
    fl = 2.0 * 2.0 * h * dh * pairs * n_attn
    if shape.kind == "train":
        fl *= 3.0                                     # bwd recompute ~2x fwd
    return fl


def weight_bytes(cfg: ModelConfig, bytes_per_param: float = 2.0) -> float:
    return param_count(cfg) * bytes_per_param


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig, dtype_bytes: int = 2) -> float:
    """Bytes of per-step recurrent state / KV cache read by one decode step."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        per = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state + cfg.d_inner * cfg.ssm_conv_width
        return float(b * cfg.n_layers * per * dtype_bytes)
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        if kind == "rglru":
            total += b * cfg.lru_width * dtype_bytes
        elif kind == "attn":
            ctx = min(s, cfg.attn_window or s)
            if cfg.use_mla:
                total += b * ctx * (cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
            else:
                total += 2 * b * ctx * cfg.n_kv_heads * cfg.d_head * dtype_bytes
    if cfg.n_encoder_layers:
        total += 2 * b * cfg.encoder_len * cfg.n_kv_heads * cfg.d_head * dtype_bytes * cfg.n_layers
    return float(total)


# ---------------------------------------------------------------------------
# Coarse op graph for the segmenter (paper §5.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpCost:
    """One operation node in the placement graph."""

    name: str
    flops: float
    bytes: float          # activation + weight bytes moved at fp16


def op_graph(cfg: ModelConfig, shape: ShapeConfig) -> list[OpCost]:
    """A coarse per-op sequence (one layer unrolled per distinct kind +
    embed/head), enough for the Dijkstra segmenter to place realistically."""
    b = shape.global_batch
    s = 1 if shape.kind == "decode" else shape.seq_len
    tokens = b * s
    d = cfg.d_model
    ops: list[OpCost] = [OpCost("embed", 0.0, tokens * d * 2.0)]
    for i in range(min(cfg.n_layers, 6)):             # representative prefix
        kind = cfg.block_kind(i)
        act_bytes = tokens * d * 2.0
        if kind == "ssm":
            p = _ssm_params(cfg)
            ops.append(OpCost(f"L{i}.ssd", 2.0 * p * tokens, act_bytes + p * 2.0))
        elif kind == "rglru":
            p = _rglru_params(cfg)
            ops.append(OpCost(f"L{i}.rglru", 2.0 * p * tokens, act_bytes + p * 2.0))
        else:
            p = _attn_params(cfg)
            ctx = shape.seq_len if shape.kind == "decode" else s
            ctx = min(ctx, cfg.attn_window or ctx)
            dh = cfg.d_head if not cfg.use_mla else (cfg.qk_nope_dim + cfg.qk_rope_dim)
            score_fl = 4.0 * cfg.n_heads * dh * ctx * tokens
            ops.append(OpCost(f"L{i}.qkv", 2.0 * p * tokens, act_bytes + p * 2.0))
            ops.append(OpCost(f"L{i}.attn", score_fl,
                              act_bytes + 2.0 * b * ctx * cfg.n_kv_heads * max(dh, 1) * 2.0))
        if cfg.layer_is_moe(i):
            pe = cfg.experts_per_token * _mlp_params(d, cfg.d_ff_expert, cfg.act)
            stored = cfg.n_experts * _mlp_params(d, cfg.d_ff_expert, cfg.act)
            ops.append(OpCost(f"L{i}.moe", 2.0 * pe * tokens,
                              act_bytes + min(stored, pe * max(tokens, 1)) * 2.0))
        else:
            p = _mlp_params(d, cfg.d_ff, cfg.act)
            ops.append(OpCost(f"L{i}.mlp", 2.0 * p * tokens, act_bytes + p * 2.0))
        ops.append(OpCost(f"L{i}.norm", 10.0 * tokens * d, 2 * act_bytes))
    ops.append(OpCost("logits", 2.0 * tokens * d * cfg.padded_vocab,
                      tokens * d * 2.0 + d * cfg.padded_vocab * 2.0))
    return ops
