"""whisper-small [audio]: enc-dec with a real conv stem [arXiv:2212.04356].

Copied from `src/repro/configs/whisper_small.py:12`. Log-mel frames
(3000, 80) per request go through two width-3 time convs (the second
stride 2) with GELU to (1500, 768), then a 12-layer encoder and a 12-layer
decoder with cross-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab=51865,
    norm="layernorm", act="gelu_mlp", use_bias=True,
    n_encoder_layers=12, encoder_len=1500, n_mels=80,
)
