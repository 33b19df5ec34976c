"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

Copied from `src/repro/configs/deepseek_v3_671b.py:10`: 61 layers, d_model
7168, 128 heads, MLA dims per the published config (q_lora 1536, kv_lora
512, qk_rope 64, qk_nope 128, v_head 128), the first 3 layers dense with
d_ff 18432, then 256 experts of d_ff 2048 (top-8, one shared expert), and one
multi-token-prediction module."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_head=192,
    d_ff=18432, vocab=129280,
    norm="rmsnorm", act="silu",
    n_experts=256, experts_per_token=8, n_shared_experts=1,
    d_ff_expert=2048, n_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    mtp_depth=1,
)
