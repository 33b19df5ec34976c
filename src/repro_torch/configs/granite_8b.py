"""granite-8b [dense]: llama-arch code model [arXiv:2405.04324; hf].

Copied from `src/repro/configs/granite_8b.py:4`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=49152,
    norm="rmsnorm", act="silu", tie_embeddings=True,
)
