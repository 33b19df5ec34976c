"""mamba2-1.3b [ssm]: SSD (state-space duality), attn-free [arXiv:2405.21060].

Copied from `src/repro/configs/mamba2_1_3b.py:4`."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab=50280,
    norm="rmsnorm",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256, ssm_groups=1,
)
