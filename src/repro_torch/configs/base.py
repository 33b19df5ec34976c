"""Model configurations: a copy of the reference's `ModelConfig`,
`ShapeConfig` and `smoke`.

Copied from `src/repro/configs/base.py` (`ModelConfig` at :17, `ShapeConfig`
at :135, `smoke` at :161) with every field and default unchanged, so a
configuration means the same model in both packages; `core.costmodel` prices
a `ShapeConfig`. The port keeps its own copy: it imports nothing
of the JAX package. `smoke(cfg)` gives the reduced same-family configuration
the CPU tests instantiate.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # --- common options ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # gate activation for the GLU MLP
    use_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    attn_window: int | None = None   # sliding-window (local) attention size
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0          # leading dense layers (DeepSeek-V3: 3)
    moe_capacity_factor: float = 1.25
    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0               # multi-token-prediction extra depth
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # --- hybrid (RG-LRU / RecurrentGemma) ---
    block_pattern: tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0
    # --- encoder-decoder (Whisper backbone) ---
    n_encoder_layers: int = 0
    encoder_len: int = 0
    n_mels: int = 0                  # >0: conv stem eats mel frames
    stem_width: int = 3              # conv-stem kernel width (time axis)
    stem_stride: int = 2             # second stem conv's time downsample
    # --- numerics / technique knobs ---
    dtype: str = "bfloat16"          # activation/weight compute dtype
    logits_fp32: bool = True         # the paper's "wider anchor" rule (§3.9)
    remat: str = "full"              # full | dots | none
    scan_layers: bool = True
    seq_shard: bool = True           # Megatron-style sequence parallelism:
    # residual stream (and thus the saved remat checkpoints) sharded over
    # 'model' between layers; GSPMD inserts the all-gather/reduce-scatter
    # pair around attention/MLP. Validated in §Perf pair B; now the default
    # (the paper-faithful baseline sweep ran with it off).
    shard_cache_seq: bool = True     # context-parallel decode: shard the KV
    # cache's sequence dim over 'model' when the KV-head count doesn't
    # divide it (GQA kv=8 on a 16-way axis). Validated in §Perf pair A;
    # now the default (baseline sweep ran with it off).

    # ------------------------------------------------------------------
    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k context? SSM state is O(1); the hybrid's
        local attention caches only its window. Full-attention archs are not
        sub-quadratic and skip `long_500k` (DESIGN.md §Arch-applicability)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.attn_window is not None:
            return True
        return False

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 for clean TP sharding."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def block_kind(self, layer_idx: int) -> str:
        """Temporal-mixing kind for layer `layer_idx`."""
        if self.family == "ssm":
            return "ssm"
        if self.block_pattern:
            return self.block_pattern[layer_idx % len(self.block_pattern)]
        return "attn"

    def layer_is_moe(self, layer_idx: int) -> bool:
        return self.n_experts > 0 and layer_idx >= self.n_dense_layers

    @property
    def frame_shape(self) -> tuple[int, int]:
        """Per-request encoder input (frames, features). With a conv stem
        (`n_mels > 0`) the encoder eats `stem_stride * encoder_len` mel
        frames of width `n_mels`; without one it eats pre-projected
        `d_model` features directly (the seed's stubbed frontend)."""
        if self.n_mels:
            return (self.stem_stride * self.encoder_len, self.n_mels)
        return (self.encoder_len, self.d_model)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small layers/width,
    few experts, tiny vocab — one forward/train step must run on CPU."""
    n_layers = max(2, min(3, cfg.n_layers)) if not cfg.block_pattern else len(cfg.block_pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=16,
        d_ff=128,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        d_ff_expert=64 if cfg.d_ff_expert else 0,
        n_dense_layers=min(cfg.n_dense_layers, 1),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_rope_dim=8 if cfg.qk_rope_dim else 0,
        qk_nope_dim=8 if cfg.qk_nope_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        mtp_depth=min(cfg.mtp_depth, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=32 if cfg.ssm_state else cfg.ssm_chunk,
        lru_width=64 if cfg.lru_width else 0,
        attn_window=min(cfg.attn_window, 32) if cfg.attn_window else None,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_len=min(cfg.encoder_len, 24) if cfg.encoder_len else 0,
        dtype="float32",
    )
