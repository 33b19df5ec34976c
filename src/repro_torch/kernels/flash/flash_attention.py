"""flash_attention: the hand-written CUDA attention kernel with online softmax.

Replaces the Pallas TPU kernel `src/repro/kernels/flash/flash_attention.py:93`;
the kernel is `src/repro_torch/csrc/flash_attention.cu`, which also says what
bounds it on an H100. q is (B, H, Sq, d), k and v are (B, KVH, Skv, d); query
head h attends kv head h // (H / KVH). `causal` and `window` mask as the
reference does; d is one of 16, 32, 64, 128, 256.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version `flash_attention_ref`. Strided views whose last dim is unit-stride
(the (B, S, H, d) -> (B, H, S, d) transposes of `flash_route`) go in without
a copy; a view whose row starts or row strides are not 16-byte aligned is
refused, not copied.

bf16 and fp16 take one of two tensor-core paths, chosen by `flash_plan`
from (Sq, Skv) alone: 64-query tiles, or for short queries (a decode
step's cross-attention) a split over the keys with a combine pass. fp32 runs
the CUDA-core body.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import native
from repro_torch.kernels.flash.ref import flash_attention_ref

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
HEAD_DIMS = (16, 32, 64, 128, 256)
SHORT_QUERY = 16        # Sq at or below this takes the short-query path
SPLIT_STAGE = 64        # keys of a short-query block's stage; splits are multiples
SPLIT_KEYS = 256        # keys a short-query split reads, at the least (PERF.md §6)
MAX_SPLITS = 128        # bounds the fp32 partials of very long key sequences
PATHS = {"tile": 0, "short": 1}   # the kernel's path codes (csrc: Path)


class FlashPlan(NamedTuple):
    path: str           # "tile" or "short"
    n_split: int        # key splits of the short path; more than one adds a combine pass
    split_len: int      # keys a short-path split owns, a multiple of SPLIT_STAGE


TILE = FlashPlan("tile", 1, 0)   # the tile path walks all the keys itself


def flash_plan(sq: int, skv: int) -> FlashPlan:
    """The bf16 / fp16 kernel path of a call. A function of (Sq, Skv) alone,
    never of the batch, the heads, the head dim or the card: a lane's bits
    must not change with how many lanes run beside it. Longer queries take
    64-query tiles over all the keys; short ones split the keys into runs
    of SPLIT_KEYS (longer where more than MAX_SPLITS would be needed)."""
    if sq > SHORT_QUERY:
        return TILE
    fewest = -(-skv // (MAX_SPLITS * SPLIT_STAGE)) * SPLIT_STAGE
    split_len = max(SPLIT_KEYS, fewest)
    return FlashPlan("short", max(1, -(-skv // split_len)), split_len)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Each (b, h, s) row of `t` starts on a 16-byte boundary: the kernel
    stages rows with 16-byte copies."""
    size = t.element_size()
    bad = t.data_ptr() % 16 != 0 or any(
        t.shape[i] > 1 and (t.stride(i) * size) % 16 != 0 for i in range(3))
    if bad:
        raise ValueError(f"flash: {name} rows must start 16-byte aligned (data_ptr "
                         f"{t.data_ptr():#x}, strides {t.stride()}, {t.dtype})")


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_aligned(name, t)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if b * h * sq == 0:
        return out
    plan = flash_plan(sq, skv) if q.dtype != torch.float32 else TILE
    part = None
    if plan.n_split > 1:        # the splits' partial (acc, m, l), fp32
        part = torch.empty(b * h * plan.n_split * sq * (d + 2), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        native.launch(
            "flash", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kvh, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), -1 if window is None else int(window), float(scale),
            native.dtype_code(q.dtype), PATHS[plan.path],
            None if part is None else part.data_ptr(), plan.n_split, plan.split_len,
            torch.cuda.current_stream(q.device).cuda_stream)
    return out
