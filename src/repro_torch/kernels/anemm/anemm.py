"""anemm: the hand-written CUDA matmul with the ANE-mode epilogue.

Replaces the Pallas TPU kernel `src/repro/kernels/anemm/anemm.py:69`; the
kernel is `src/repro_torch/csrc/anemm.cu`, which also says what bounds it on
an H100. `anemm(a, b)` computes `a @ b` for a (M, K) and b (K, N) of one
dtype (fp32, bf16 or fp16) with an fp32 accumulator, then per-N `scale`,
`bias`, ANE-mode saturation, with `epilogue=` (a table name of
`core.numerics`) the LUT activation after a rounding to the input dtype
(the reference's output-port rule, reference :53-61), and one rounding to
the input dtype.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version `anemm_ref`. Backward (reference `ops.py:29`) comes with training.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.act_lut.ops import table_operands
from repro_torch.kernels.anemm.ref import anemm_ref

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _vector(x, n: int, what: str, device) -> torch.Tensor | None:
    if x is None:
        return None
    if x.shape != (n,):
        raise ValueError(f"anemm: {what} must have shape ({n},), got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"anemm: {what} on {x.device}, operands on {device}")
    return x.to(torch.float32).contiguous()


def anemm(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None = None,
          bias: torch.Tensor | None = None, *, ane_mode: bool = False,
          epilogue: str | None = None) -> torch.Tensor:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"anemm: want a (M, K) and b (K, N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"anemm: dtypes {a.dtype}, {b.dtype}; want one of {DTYPES}")
    if a.device != b.device:
        raise ValueError(f"anemm: a on {a.device}, b on {b.device}")
    table = None if epilogue is None else table_operands(epilogue, a.device)
    if a.device.type == "cpu":
        return anemm_ref(a, b, scale, bias, ane_mode=ane_mode, epilogue_table=table)
    if a.device.type != "cuda":
        raise ValueError(f"anemm: no kernel for tensors on {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("anemm: operands must be contiguous row-major")
    m, k = a.shape
    n = b.shape[1]
    scale32 = _vector(scale, n, "scale", a.device)
    bias32 = _vector(bias, n, "bias", a.device)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        native.launch(
            "anemm", a.data_ptr(), b.data_ptr(),
            None if scale32 is None else scale32.data_ptr(),
            None if bias32 is None else bias32.data_ptr(),
            None if table is None else table.data_ptr(), out.data_ptr(), m, n, k, native.dtype_code(a.dtype),
            int(ane_mode), torch.cuda.current_stream(a.device).cuda_stream)
    return out
