"""Plain PyTorch version of anemm (after `src/repro/kernels/anemm/ref.py`).

fp32 accumulation of the narrow inputs, the epilogue in the kernel's order
(scale, bias, ANE-mode saturation), one rounding to the input dtype. The CPU
tests hold it against the JAX kernel; on the card `chip_smoke.py` holds the
CUDA kernel against it.
"""

from __future__ import annotations

import torch

from repro_torch.core import hal


def anemm_ref(a: torch.Tensor, b: torch.Tensor, scale=None, bias=None, *,
              ane_mode: bool = False) -> torch.Tensor:
    acc = torch.einsum("mk,kn->mn", a.float(), b.float())
    if scale is not None:
        acc = acc * scale.float()[None, :]
    if bias is not None:
        acc = acc + bias.float()[None, :]
    if ane_mode:
        acc = acc.masked_fill(acc >= hal.ACCUM_OUT_CEILING, float("inf"))
        acc = acc.masked_fill(acc <= -hal.ACCUM_OUT_CEILING, float("-inf"))
    return acc.to(a.dtype)
