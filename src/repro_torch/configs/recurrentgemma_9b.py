"""recurrentgemma-9b [hybrid]: RG-LRU + local attn, 1:2 [arXiv:2402.19427].

Block pattern: two RG-LRU recurrent blocks per one local-attention block
(window 2048), MQA (kv=1). Sub-quadratic: runs long_500k.

Copied from `src/repro/configs/recurrentgemma_9b.py:8`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_head=256,
    d_ff=12288, vocab=256000,
    norm="rmsnorm", act="gelu",
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096, attn_window=2048,
)
