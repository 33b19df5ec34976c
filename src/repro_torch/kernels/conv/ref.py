"""Plain PyTorch versions of the conv family (after `src/repro/kernels/conv/ref.py`),
and the output geometry every wrapper shares (`out_extent`, `pad_explicit`).

`conv2d_ref` runs the Pallas kernel's datapath as torch ops: the image
padded by `pad_explicit`'s cells, each (kh, kw) tap a strided slice
contracted with its (Cin, Cout) weight plane in fp32, the taps summed in
(i, j) order, then bias, ANE-mode saturation and one rounding to x's dtype;
`epilogue=` then widens that and evaluates the LUT (kernel-then-act_lut, the
rounding point the fused kernel keeps). `avg_pool_ref` / `max_pool_ref` fold
the taps in the same order from the reduction's identity-padded image (0 for
avg, -inf for max) and scale the avg sum by the fp32 constant 1/(wh*ww).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import hal
from repro_torch.kernels.act_lut.ref import act_lut_ref


# Output extents and explicit SAME/VALID pads (reference conv2d.py:37-53),
# shared by every conv-family wrapper and plain version, so SAME always
# means the same cells.


def out_extent(size: int, k: int, stride: int, padding: str) -> int:
    """Output spatial extent for one dim (SAME: ceil(size/s); VALID floor)."""
    if padding == "SAME":
        return -(-size // stride)
    if padding == "VALID":
        if size < k:
            raise ValueError(f"VALID conv: extent {size} < window {k}")
        return (size - k) // stride + 1
    raise ValueError(f"padding must be SAME or VALID, got {padding!r}")


def pad_explicit(size: int, k: int, stride: int, padding: str) -> tuple[int, int]:
    """(lo, hi) explicit pads for one spatial dim."""
    o = out_extent(size, k, stride, padding)
    if padding == "VALID":
        return (0, 0)
    total = max((o - 1) * stride + k - size, 0)
    return (total // 2, total - total // 2)


def _padded(x: torch.Tensor, kh: int, kw: int, stride, padding: str, fill: float):
    """x widened to fp32 and padded by the explicit SAME/VALID cells; the
    output extents."""
    sh, sw = stride
    oh, ow = out_extent(x.shape[1], kh, sh, padding), out_extent(x.shape[2], kw, sw, padding)
    ph, pw = pad_explicit(x.shape[1], kh, sh, padding), pad_explicit(x.shape[2], kw, sw, padding)
    xp = F.pad(x.float(), (0, 0, pw[0], pw[1], ph[0], ph[1]), value=fill)
    return xp, oh, ow


def _tap(xp: torch.Tensor, i: int, j: int, stride, oh: int, ow: int) -> torch.Tensor:
    sh, sw = stride
    return xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :]


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
               stride=(1, 1), padding: str = "SAME", ane_mode: bool = False,
               epilogue_table: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC, w (KH, KW, Cin, Cout) HWIO; `epilogue_table`
    the (99,) table of a fused activation, or None."""
    kh, kw, cin, cout = w.shape
    xp, oh, ow = _padded(x, kh, kw, stride, padding, 0.0)
    acc = torch.zeros((x.shape[0] * oh * ow, cout), dtype=torch.float32, device=x.device)
    wf = w.float()
    for i in range(kh):
        for j in range(kw):
            acc += _tap(xp, i, j, stride, oh, ow).reshape(-1, cin) @ wf[i, j]
    if bias is not None:
        acc = acc + bias.float()
    if ane_mode:
        acc = acc.masked_fill(acc >= hal.ACCUM_OUT_CEILING, float("inf"))
        acc = acc.masked_fill(acc <= -hal.ACCUM_OUT_CEILING, float("-inf"))
    out = acc.to(x.dtype).reshape(x.shape[0], oh, ow, cout)
    if epilogue_table is not None:
        out = act_lut_ref(out, epilogue_table, ane_mode=True)
    return out


def _pool_ref(x: torch.Tensor, window, stride, padding: str, kind: str) -> torch.Tensor:
    wh, ww = window
    avg = kind == "avg_pool"
    xp, oh, ow = _padded(x, wh, ww, stride, padding, 0.0 if avg else float("-inf"))
    acc = None
    for i in range(wh):
        for j in range(ww):
            tap = _tap(xp, i, j, stride, oh, ow)
            if acc is None:
                acc = tap.clone()
            elif avg:
                acc = acc + tap
            else:
                acc = torch.maximum(acc, tap)
    if avg:
        acc = acc * float(np.float32(1.0 / (wh * ww)))
    return acc.to(x.dtype)


def avg_pool_ref(x: torch.Tensor, *, window, stride=None, padding: str = "VALID"):
    return _pool_ref(x, window, stride or window, padding, "avg_pool")


def max_pool_ref(x: torch.Tensor, *, window, stride=None, padding: str = "VALID"):
    return _pool_ref(x, window, stride or window, padding, "max_pool")
