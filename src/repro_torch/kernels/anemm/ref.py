"""Plain PyTorch version of anemm (after `src/repro/kernels/anemm/ref.py`).

fp32 accumulation of the narrow inputs, the epilogue in the kernel's order
(scale, bias, ANE-mode saturation), one rounding to the input dtype, then
the optional LUT activation through act_lut's plain version. The CPU
tests hold it against the JAX kernel; on the card `chip_smoke.py` holds the
CUDA kernel against it.
"""

from __future__ import annotations

import torch

from repro_torch.core import hal
from repro_torch.kernels.act_lut.ref import act_lut_ref


def anemm_ref(a: torch.Tensor, b: torch.Tensor, scale=None, bias=None, *,
              ane_mode: bool = False,
              epilogue_table: torch.Tensor | None = None) -> torch.Tensor:
    """`epilogue_table`: the (99,) table of a fused LUT activation, applied
    to the rounded product (matmul-then-act_lut), or None."""
    acc = torch.einsum("mk,kn->mn", a.float(), b.float())
    if scale is not None:
        acc = acc * scale.float()[None, :]
    if bias is not None:
        acc = acc + bias.float()[None, :]
    if ane_mode:
        acc = acc.masked_fill(acc >= hal.ACCUM_OUT_CEILING, float("inf"))
        acc = acc.masked_fill(acc <= -hal.ACCUM_OUT_CEILING, float("-inf"))
    out = acc.to(a.dtype)
    if epilogue_table is not None:
        out = act_lut_ref(out, epilogue_table, ane_mode=True)
    return out
