"""Architecture registry of the port: `get_config(name)` returns the full
published config, `get_smoke(name)` the reduced same-family config the CPU
tests instantiate (after `src/repro/configs/__init__.py`).

Registered: the architectures the port serves — the dense GQA decoders
(tinyllama-1.1b, granite-8b, phi4-mini-3.8b, command-r-35b, chameleon-34b
with QK-norm), the one-device MoEs (dbrx-132b, and deepseek-v3-671b with
MLA's latent cache and its multi-token-prediction module), the
encoder-decoder (whisper-small), the SSM (mamba2-1.3b) and the RG-LRU hybrid
with sliding-window MQA (recurrentgemma-9b) — every architecture of the
reference, in its order — and, outside `ARCH_NAMES` as in the reference, the
paper's own workload config `ane-paper` (float16).
"""

from __future__ import annotations

from repro_torch.configs import (ane_paper, chameleon_34b, command_r_35b, dbrx_132b,
                                 deepseek_v3_671b, granite_8b, mamba2_1_3b, phi4_mini_3_8b,
                                 recurrentgemma_9b, tinyllama_1_1b, whisper_small)
from repro_torch.configs.base import ModelConfig, smoke

_MODULES = {
    "chameleon-34b": chameleon_34b,
    "granite-8b": granite_8b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "command-r-35b": command_r_35b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "dbrx-132b": dbrx_132b,
    "whisper-small": whisper_small,
    "mamba2-1.3b": mamba2_1_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "ane-paper": ane_paper,
}

ARCH_NAMES = [n for n in _MODULES if n != "ane-paper"]


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return smoke(get_config(name))


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_smoke", "smoke"]
