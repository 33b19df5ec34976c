"""command-r-35b [dense]: GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

Copied from `src/repro/configs/command_r_35b.py:4`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22528, vocab=256000,
    norm="layernorm", act="silu", use_bias=False, tie_embeddings=True,
)
