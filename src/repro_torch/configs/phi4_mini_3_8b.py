"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA [arXiv:2412.08905; hf].

Copied from `src/repro/configs/phi4_mini_3_8b.py:4`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=200064,
    norm="rmsnorm", act="silu", tie_embeddings=True,
)
