"""Operand checks shared by the packed-weight kernel wrappers."""

from __future__ import annotations

import torch


def check_operands(name: str, a: torch.Tensor, dtypes: tuple,
                   weights: dict[str, tuple]) -> None:
    """The packed kernels' operand contract: `a` (M, K) is in `dtypes`; each
    weight array is `weights[name] = (tensor, shape, allowed dtypes)`; all
    contiguous and on `a`'s device. Raises on anything else."""
    if a.dtype not in dtypes:
        raise TypeError(f"{name}: a is {a.dtype}; want one of {dtypes}")
    for what, (t, shape, allowed) in weights.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must have shape {shape} for a "
                             f"{tuple(a.shape)}, got {tuple(t.shape)}")
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {what} is {t.dtype}; want one of {allowed}")
        if t.device != a.device:
            raise ValueError(f"{name}: {what} on {t.device}, a on {a.device}")
    if not all(t.is_contiguous() for t in [a] + [w[0] for w in weights.values()]):
        raise ValueError(f"{name}: operands must be contiguous row-major")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for tensors on {a.device}")
