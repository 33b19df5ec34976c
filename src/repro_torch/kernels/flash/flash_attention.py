"""flash_attention: the hand-written CUDA attention kernel with online softmax.

Replaces the Pallas TPU kernel `src/repro/kernels/flash/flash_attention.py:93`;
the kernel is `src/repro_torch/csrc/flash_attention.cu`, which also says what
bounds it on an H100. q is (B, H, Sq, d), k and v are (B, KVH, Skv, d); query
head h attends kv head h // (H / KVH). `causal` and `window` mask as the
reference does; d must be 16, 32 or 64.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version `flash_attention_ref`. Strided views whose last dim is unit-stride
(the (B, S, H, d) -> (B, H, S, d) transposes of `flash_route`) go in without
a copy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.flash.ref import flash_attention_ref

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
HEAD_DIMS = (16, 32, 64)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash: want q (B,H,Sq,d), k/v (B,KVH,Skv,d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    _, kvh, skv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % kvh != 0:
        raise ValueError(f"flash: q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash: dtypes {q.dtype}, {k.dtype}, {v.dtype}; want one of {DTYPES}")
    if window is not None and window < 1:
        raise ValueError(f"flash: window must be >= 1 or None, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash: q, k and v must share a device")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash: no kernel for tensors on {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash: head dim {d} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash: the head dim must be unit-stride")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if b * h * sq == 0:
        return out
    with torch.cuda.device(q.device):
        native.launch(
            "flash", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kvh, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), -1 if window is None else int(window), float(scale),
            native.dtype_code(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    return out
