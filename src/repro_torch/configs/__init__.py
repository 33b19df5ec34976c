"""Architecture registry of the port: `get_config(name)` returns the full
published config, `get_smoke(name)` the reduced same-family config the CPU
tests instantiate (after `src/repro/configs/__init__.py`).

Only the architectures the port serves are registered: tinyllama-1.1b and
whisper-small. The others join as their model families are ported.
"""

from __future__ import annotations

from repro_torch.configs import tinyllama_1_1b, whisper_small
from repro_torch.configs.base import ModelConfig, smoke

_MODULES = {
    "tinyllama-1.1b": tinyllama_1_1b,
    "whisper-small": whisper_small,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return smoke(get_config(name))


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config", "get_smoke", "smoke"]
