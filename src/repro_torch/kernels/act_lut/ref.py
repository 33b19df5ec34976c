"""Plain PyTorch version of act_lut (after `src/repro/kernels/act_lut/ops.py:43`,
`lut_apply_ref`, with the compare-count index of the kernel body
`src/repro/kernels/act_lut/act_lut.py:27`).

`lut_eval_ref` takes the same steps as the CUDA `lut_eval`
(`csrc/lut_eval.cuh`) as torch ops on fp32: in ANE mode a NaN reads as
+inf; the segment index counts the knots 1..32 that x reaches, clipped to
31 (the CUDA body finds the same index by a search over the sorted knots);
slope*x and the intercept are two separately rounded ops; the end
clamps apply past the domain; in ANE mode the result rounds to fp16 and
back. So the kernel and this version agree bit for bit. The table is one
fp32 tensor of 99 values (`core.numerics.LutTable.kernel_operands`).
"""

from __future__ import annotations

import torch


def lut_eval_ref(xf: torch.Tensor, table: torch.Tensor, *, ane_mode: bool) -> torch.Tensor:
    """The fp32 PWL evaluation of fp32 `xf` through `table` (99,)."""
    xs, sl, ic = table[:33], table[33:65], table[65:97]
    if ane_mode:
        xf = torch.where(torch.isnan(xf), torch.full_like(xf, float("inf")), xf)
    idx = torch.zeros(xf.shape, dtype=torch.int64, device=xf.device)
    for i in range(1, 33):
        idx += xf >= xs[i]
    idx = idx.clamp_(max=31)
    y = sl[idx] * xf
    y = y + ic[idx]
    y = torch.where(xf < xs[0], table[97], y)
    y = torch.where(xf > xs[32], table[98], y)
    if ane_mode:
        y = y.to(torch.float16).to(torch.float32)
    return y


def act_lut_ref(x: torch.Tensor, table: torch.Tensor, *, ane_mode: bool = True) -> torch.Tensor:
    """x widened to fp32, evaluated, stored in x's dtype."""
    return lut_eval_ref(x.float(), table, ane_mode=ane_mode).to(x.dtype)
