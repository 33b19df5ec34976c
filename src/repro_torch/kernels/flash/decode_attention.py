"""decode_attention: the hand-written CUDA one-token GQA decode kernel.

Replaces the Pallas TPU kernel `src/repro/kernels/flash/decode_attention.py:67`
(the paged variant at :200 is not ported yet); the kernel is
`src/repro_torch/csrc/decode_attention.cu`, which also says what bounds it on
an H100. q (B, H, d) attends a (B, S, KV, d) cache whose slot s holds
absolute position `positions[b, s]` (-1: empty); a slot is valid when
`0 <= pos <= current[b]` and, with a window, `current - pos < window`.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version `decode_attention_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)
MAX_GROUP = 32      # query heads per kv head the kernel stages at once


def decode_attention_ref(q, k_cache, v_cache, positions, current, *,
                         window=None, scale=None):
    """Plain version (reference :121, mirroring models/attention's decode):
    fp32 scores over every cache slot, invalid slots -1e30, softmax, one
    rounding to q's dtype."""
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, g, d)
    sc = torch.einsum("bkgd,bckd->bkgc", qg.float(), k_cache.float()) * scale
    valid = (positions >= 0) & (positions <= current[:, None])
    if window is not None:
        valid &= (current[:, None] - positions) < window
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, current: torch.Tensor, *,
                     window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: want q (B,H,d), caches (B,S,KV,d); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kvh != 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not match "
                         f"cache {tuple(k_cache.shape)}")
    if positions.shape != (b, s) or current.shape != (b,):
        raise ValueError(f"decode_attention: positions {tuple(positions.shape)} / current "
                         f"{tuple(current.shape)}; want ({b}, {s}) / ({b},)")
    if positions.dtype != torch.int32 or current.dtype != torch.int32:
        raise TypeError("decode_attention: positions and current must be int32")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}; want one of {DTYPES}")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window must be >= 1 or None, got {window}")
    devices = {t.device for t in (q, k_cache, v_cache, positions, current)}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: operands on {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, positions, current,
                                    window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for tensors on {q.device}")
    if d not in HEAD_DIMS or h // kvh > MAX_GROUP:
        raise ValueError(f"decode_attention: head dim {d} (want {HEAD_DIMS}), "
                         f"group {h // kvh} (want <= {MAX_GROUP})")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, positions, current)):
        raise ValueError("decode_attention: operands must be contiguous")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        native.launch(
            "decode_attention", q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions.data_ptr(), current.data_ptr(), out.data_ptr(),
            b, h, kvh, s, d, -1 if window is None else int(window), float(scale),
            native.dtype_code(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    return out
