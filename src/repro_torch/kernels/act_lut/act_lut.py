"""act_lut: the hand-written CUDA kernel of the 33-knot PWL activation.

Replaces the Pallas TPU kernel `src/repro/kernels/act_lut/act_lut.py:58`;
the kernel is `src/repro_torch/csrc/act_lut.cu` (body `csrc/lut_eval.cuh`,
shared with the fused epilogues of `anemm` and `conv2d`), which also says
what bounds it on an H100. `act_lut(x, table)` evaluates the table (99 fp32
values, `ops.table_operands`) at every element of x (fp32, bf16 or fp16,
any shape) and stores in x's dtype.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version `act_lut_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.act_lut.ref import act_lut_ref

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
TABLE_FLOATS = 99


def act_lut(x: torch.Tensor, table: torch.Tensor, *, ane_mode: bool = True) -> torch.Tensor:
    if x.dtype not in DTYPES:
        raise TypeError(f"act_lut: x is {x.dtype}; want one of {DTYPES}")
    if table.shape != (TABLE_FLOATS,) or table.dtype != torch.float32:
        raise ValueError(f"act_lut: table must be ({TABLE_FLOATS},) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if table.device != x.device:
        raise ValueError(f"act_lut: table on {table.device}, x on {x.device}")
    if x.device.type == "cpu":
        return act_lut_ref(x, table, ane_mode=ane_mode)
    if x.device.type != "cuda":
        raise ValueError(f"act_lut: no kernel for tensors on {x.device}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError("act_lut: x and the table must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        native.launch("act_lut", x.data_ptr(), out.data_ptr(), table.data_ptr(), x.numel(),
                      native.dtype_code(x.dtype), int(ane_mode),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out
