"""dbrx-132b [moe]: 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

Copied from `src/repro/configs/dbrx_132b.py:4`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=10752, vocab=100352,
    norm="layernorm", act="silu",
    n_experts=16, experts_per_token=4, d_ff_expert=10752,
)
