"""avg_pool / max_pool: the hand-written CUDA NHWC window reductions.

Replace the Pallas TPU kernel `_pool` (`src/repro/kernels/conv/pool.py:44`,
entry points `avg_pool` :73 and `max_pool` :82); the kernels are
`src/repro_torch/csrc/pool.cu`, which also says what bounds them on an H100.
avg is count-include-pad (SAME pads count as zeros), max pads with -inf and
propagates NaN. `stride` defaults to the window, padding to VALID.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (`avg_pool_ref` / `max_pool_ref`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.conv.ref import avg_pool_ref, max_pool_ref, out_extent, pad_explicit

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_PLAIN = {"avg_pool": avg_pool_ref, "max_pool": max_pool_ref}


def _pool(x: torch.Tensor, window, stride, padding: str, kind: str) -> torch.Tensor:
    if x.ndim != 4:
        raise ValueError(f"{kind}: want x (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{kind}: x is {x.dtype}; want one of {DTYPES}")
    (wh, ww), (sh, sw) = window, stride
    if min(wh, ww, sh, sw) < 1:
        raise ValueError(f"{kind}: window {window} and stride {stride} must be >= 1")
    b, h, w, c = x.shape
    oh, ow = out_extent(h, wh, sh, padding), out_extent(w, ww, sw, padding)
    ph, pw = pad_explicit(h, wh, sh, padding), pad_explicit(w, ww, sw, padding)
    if x.device.type == "cpu":
        return _PLAIN[kind](x, window=window, stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"{kind}: no kernel for tensors on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{kind}: x must be contiguous (NHWC)")
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        native.launch(kind, x.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow, wh, ww, sh, sw,
                      ph[0], pw[0], float(np.float32(1.0 / (wh * ww))),
                      native.dtype_code(x.dtype),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out


def avg_pool(x: torch.Tensor, *, window: tuple[int, int],
             stride: tuple[int, int] | None = None, padding: str = "VALID") -> torch.Tensor:
    """NHWC average pooling (count-include-pad, like the engine)."""
    return _pool(x, window, stride or window, padding, "avg_pool")


def max_pool(x: torch.Tensor, *, window: tuple[int, int],
             stride: tuple[int, int] | None = None, padding: str = "VALID") -> torch.Tensor:
    """NHWC max pooling."""
    return _pool(x, window, stride or window, padding, "max_pool")
