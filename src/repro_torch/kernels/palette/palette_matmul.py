"""palette_matmul: int4 palette weights, dequantized inside the CUDA kernel.

Replaces the Pallas TPU kernel `src/repro/kernels/palette/palette_matmul.py:88`;
the kernel is `src/repro_torch/csrc/palette_matmul.cu`. A weight is stored as
4-bit indices into a 16-entry fp32 codebook, packed two to a byte along K
(low nibble the even row): a (K, N) weight is a (K/2, N) uint8 array plus a
(16,) fp32 LUT. Only those bytes cross device memory; the kernel looks the
codebook up between its shared-memory ring and the matrix unit, as the TPU
kernel does between VMEM and the MXU.

`palette_matmul(a, packed, lut)` takes a (M, K) fp32 or bf16 activation and
returns (M, N) in `a.dtype`: each looked-up weight is rounded once to
`a.dtype`, the product accumulates in fp32 and rounds once. A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version
`palette_matmul_ref`. bf16 runs the streaming tile loop, K summed in
`anemm`'s chunks (`common.chunk_plan`, never a function of M) over
`common.launch_plan`'s blocks: at decode it is bound by the packed bytes
(a quarter of the bf16 weight's), at prefill by the tensor cores. fp32 (the
logits head) runs the blocked fp32 loop, one fmaf chain over K.

`pack_kn` fits the codebook (16 quantiles, then Lloyd rounds) and packs, on
the weight's own device and in chunks, so a model's weights pack on the card
in seconds.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import common, native
from repro_torch.kernels.palette.pairwise import grouped_means

DTYPES = (torch.float32, torch.bfloat16)
N_CODES = 16
# elements per assignment chunk: its (chunk, 16) fp32 distances stay near
# 64 MB
_CHUNK = 1 << 20


def _quantile_codebook(flat: torch.Tensor) -> torch.Tensor:
    """numpy's `quantile(flat, linspace(0, 1, 16))` ("linear" method),
    rounded to fp32 as the reference does: the order statistics come from a
    sort on the tensor's device, the interpolation runs in float64 with
    numpy's `_lerp` (including its `t >= 0.5` branch), so the result is
    bit-identical to numpy's."""
    n = flat.numel()
    virtual = (n - 1) * np.linspace(0.0, 1.0, N_CODES)
    prev = np.floor(virtual).astype(np.int64)
    nxt = prev + 1
    top = virtual >= n - 1
    prev[top] = nxt[top] = -1                       # numpy's above-bounds rule
    gamma = torch.from_numpy(virtual - prev).to(flat.device)
    srt = torch.sort(flat).values
    a = srt[torch.from_numpy(prev % n).to(flat.device)]
    b = srt[torch.from_numpy(nxt % n).to(flat.device)]
    diff = (b - a).double()                        # fp32 subtract, then widened
    lerp = torch.where(gamma >= 0.5, b.double() - diff * (1 - gamma),
                       a.double() + diff * gamma)
    return lerp.float()


def _assign(flat: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """The nearest code of each element (first index on ties, as
    np.argmin), in chunks."""
    return torch.cat([(c[:, None] - code[None, :]).abs().argmin(1)
                      for c in flat.split(_CHUNK)])


def pack_kn(w: torch.Tensor, iters: int = 12) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit a 16-entry codebook (Lloyd) and pack indices along K, low nibble
    first (after the reference's `pack_kn` :34). Returns (packed (K/2, N)
    uint8, lut (16,) float32) on `w`'s device, bit for bit the reference's.

    The quantile start is numpy's. Each Lloyd round assigns every element
    its nearest code, groups the elements by code (a stable sort, so flat
    order within a code) and takes each code's float32 mean in numpy's
    summation order (`pairwise.grouped_means`); an empty code keeps its
    value."""
    if w.ndim != 2 or w.shape[0] % 2:
        raise ValueError(f"pack_kn: want a (K, N) weight with K even, got {tuple(w.shape)}")
    w = w.float().contiguous()
    flat = w.reshape(-1)
    code = _quantile_codebook(flat)
    for _ in range(iters):
        idx = _assign(flat, code).to(torch.uint8)   # one radix pass for the sort
        counts = torch.bincount(idx, minlength=N_CODES).tolist()
        means = grouped_means(flat[torch.sort(idx, stable=True).indices], counts)
        code = torch.where(torch.tensor(counts, device=w.device) > 0,
                           torch.from_numpy(means).to(w.device), code)
    code = torch.sort(code).values
    idx = _assign(flat, code).to(torch.uint8).reshape(w.shape)
    return idx[0::2] | (idx[1::2] << 4), code


def unpack_dense(packed: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The dense (K, N) weight in the LUT's dtype: the FOLD path that the
    plain version multiplies against."""
    k2, n = packed.shape
    idx = torch.stack([packed & 0xF, packed >> 4], dim=1).reshape(2 * k2, n)
    return lut[idx.long()]


def palette_matmul(a: torch.Tensor, packed: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.palette.ref import palette_matmul_ref

    if a.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"palette: want a (M, K) and packed (K/2, N), got "
                         f"{tuple(a.shape)} and {tuple(packed.shape)}")
    m, k = a.shape
    if k % 2:
        raise ValueError(f"palette: K = {k} must be even (two nibbles a byte)")
    n = packed.shape[1]
    common.check_operands("palette", a, DTYPES,
                          {"packed": (packed, (k // 2, n), (torch.uint8,)),
                           "lut": (lut, (N_CODES,), (torch.float32,))})
    if a.device.type == "cpu":
        return palette_matmul_ref(a, packed, lut)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    chunks = common.chunk_plan(k, n, a.dtype)
    plan = common.launch_plan(m, n, chunks)
    with torch.cuda.device(a.device):
        native.launch("palette", a.data_ptr(), packed.data_ptr(), lut.data_ptr(),
                      out.data_ptr(), m, n, k, native.dtype_code(a.dtype), chunks.kc,
                      plan.bm, plan.split, torch.cuda.current_stream(a.device).cuda_stream)
    return out
