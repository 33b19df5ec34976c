"""conv2d: the hand-written CUDA NHWC convolution with its fused epilogue.

Replaces the Pallas TPU kernel `src/repro/kernels/conv/conv2d.py:95`; the
kernel is `src/repro_torch/csrc/conv2d.cu` (an implicit GEMM on the shared
tile loop), which also says what bounds it on an H100. `conv2d(x, w, bias)`
convolves x (B, H, W, Cin) with w (KH, KW, Cin, Cout) at `stride` with SAME
or VALID padding, accumulates in fp32, adds the bias, saturates in ANE mode
and, with `epilogue=` (a table name of `core.numerics`), evaluates that
activation at the output port; one rounding to x's dtype.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version `conv2d_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.act_lut.ops import table_operands
from repro_torch.kernels.conv.ref import conv2d_ref, out_extent, pad_explicit

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
           stride: tuple[int, int] = (1, 1), padding: str = "SAME",
           ane_mode: bool = False, epilogue: str | None = None) -> torch.Tensor:
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d: want x (B, H, W, Cin) and w (KH, KW, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPES:
        raise TypeError(f"conv2d: dtypes {x.dtype}, {w.dtype}; want one of {DTYPES}")
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    sh, sw = stride
    if sh < 1 or sw < 1:
        raise ValueError(f"conv2d: stride {stride} must be >= 1")
    oh, ow = out_extent(h, kh, sh, padding), out_extent(wd, kw, sw, padding)
    ph, pw = pad_explicit(h, kh, sh, padding), pad_explicit(wd, kw, sw, padding)
    if bias is not None and (bias.shape != (cout,) or bias.device != x.device):
        raise ValueError(f"conv2d: bias must be ({cout},) on {x.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    if w.device != x.device:
        raise ValueError(f"conv2d: x on {x.device}, w on {w.device}")
    table = None if epilogue is None else table_operands(epilogue, x.device)
    if x.device.type == "cpu":
        return conv2d_ref(x, w, bias, stride=stride, padding=padding, ane_mode=ane_mode,
                          epilogue_table=table)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for tensors on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d: x and w must be contiguous (NHWC, HWIO)")
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((b, oh, ow, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        native.launch(
            "conv2d", x.data_ptr(), w.data_ptr(),
            None if bias32 is None else bias32.data_ptr(),
            None if table is None else table.data_ptr(), out.data_ptr(),
            b, h, wd, cin, cout, kh, kw, sh, sw, ph[0], pw[0], oh, ow,
            native.dtype_code(x.dtype), int(ane_mode),
            torch.cuda.current_stream(x.device).cuda_stream)
    return out
