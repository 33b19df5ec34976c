"""sparse_matmul: 1:2 pair-sparse weights, rebuilt inside the CUDA kernel.

Replaces the Pallas TPU kernel `src/repro/kernels/sparse/sparse_matmul.py:85`;
the kernel is `src/repro_torch/csrc/sparse_matmul.cu`, which also says what
bounds it on an H100. Exactly one weight of each adjacent pair along K
survives. A (K, N) weight is stored as

    values    (K/2, N)   fp16 or bf16 — the survivors
    selector  (K/16, N)  uint8        — one bit per pair, 8 to a byte:
                                        bit j of byte r is pair 8r+j, and a
                                        set bit means the odd row survived

Only those bytes cross device memory; the kernel rebuilds the dense tile
between its shared-memory load and the matrix unit.

`sparse_matmul(a, values, selector)` takes a (M, K) fp32 or bf16 activation
(K % 16 == 0) and returns (M, N) in `a.dtype`: each value goes through fp32
to `a.dtype`, the product accumulates in fp32 and rounds once. A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version
`sparse_matmul_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.common import check_operands

DTYPES = (torch.float32, torch.bfloat16)
VALUE_DTYPES = (torch.float16, torch.bfloat16)


def _bit_weights(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)[None, :, None]


def pack_pair_sparse(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Magnitude 1:2 pruning and packing (after the reference's :30): the odd
    row of a pair survives only if its magnitude is strictly greater.
    Returns (values (K/2, N) float16, selector (K/16, N) uint8) on `w`'s
    device; bit for bit the reference's."""
    if w.ndim != 2 or w.shape[0] % 16:
        raise ValueError(f"pack_pair_sparse: want a (K, N) weight with K % 16 == 0, "
                         f"got {tuple(w.shape)}")
    k, n = w.shape
    pairs = w.float().reshape(k // 2, 2, n)
    odd = pairs[:, 1].abs() > pairs[:, 0].abs()
    values = torch.where(odd, pairs[:, 1], pairs[:, 0]).to(torch.float16)
    bits = odd.to(torch.uint8).reshape(-1, 8, n) << _bit_weights(w.device)
    return values, bits.sum(1).to(torch.uint8)


def unpack_dense(values: torch.Tensor, selector: torch.Tensor) -> torch.Tensor:
    """The dense (K, N) fp32 weight: the FOLD path that the plain version
    multiplies against."""
    k2, n = values.shape
    odd = ((selector[:, None, :] >> _bit_weights(selector.device)) & 1).reshape(-1, n)[:k2]
    v32 = values.float()
    zero = torch.zeros_like(v32)
    return torch.stack([torch.where(odd == 0, v32, zero),
                        torch.where(odd == 1, v32, zero)], dim=1).reshape(2 * k2, n)


def sparse_matmul(a: torch.Tensor, values: torch.Tensor,
                  selector: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.sparse.ref import sparse_matmul_ref

    if a.ndim != 2 or values.ndim != 2:
        raise ValueError(f"sparse: want a (M, K) and values (K/2, N), got "
                         f"{tuple(a.shape)} and {tuple(values.shape)}")
    m, k = a.shape
    if k % 16:
        raise ValueError(f"sparse: K = {k} must be a multiple of 16 "
                         "(selector bits pack 8 pairs a byte)")
    n = values.shape[1]
    check_operands("sparse", a, DTYPES,
                   {"values": (values, (k // 2, n), VALUE_DTYPES),
                    "selector": (selector, (k // 16, n), (torch.uint8,))})
    if a.device.type == "cpu":
        return sparse_matmul_ref(a, values, selector)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        native.launch("sparse", a.data_ptr(), values.data_ptr(), selector.data_ptr(),
                      out.data_ptr(), m, n, k, native.dtype_code(a.dtype),
                      native.dtype_code(values.dtype),
                      torch.cuda.current_stream(a.device).cuda_stream)
    return out
