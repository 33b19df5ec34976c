"""ane-paper: the paper's own workload config — the probe networks the guide
measures (conv stacks, matmul chains, reduction probes) expressed as a tiny
dense transformer plus the standalone probes driven by the benchmarks.

This is not an assigned architecture; it is "the paper's own" config per the
deliverable (f) parenthetical, used by the paper-validation benchmarks.

Copied from `src/repro/configs/ane_paper.py:10`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="ane-paper", family="dense",
    n_layers=8, d_model=1024, n_heads=8, n_kv_heads=8, d_head=128,
    d_ff=4096, vocab=32000,
    norm="layernorm", act="gelu",
    dtype="float16",          # the engine's datapath dtype
)
