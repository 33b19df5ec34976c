"""tinyllama-1.1b [dense]: llama2-arch small [arXiv:2401.02385; hf].

Copied from `src/repro/configs/tinyllama_1_1b.py:4`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_head=64,
    d_ff=5632, vocab=32000,
    norm="rmsnorm", act="silu",
)
