"""chameleon-34b [vlm]: early-fusion, VQ image tokens [arXiv:2405.09818].

Backbone only per assignment: the VQ tokenizer frontend is a stub —
`input_specs()` supplies token ids that already include image tokens.
Chameleon's stability recipe is QK-norm (norm on queries/keys).

Copied from `src/repro/configs/chameleon_34b.py:9`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536,
    norm="rmsnorm", act="silu", qk_norm=True,
)
