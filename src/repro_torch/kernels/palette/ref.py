"""Plain PyTorch version of palette_matmul (after `src/repro/kernels/palette/ref.py`).

The FOLD path: decode the packed weight to dense, round it to `a.dtype`,
multiply with an fp32 accumulator and round once to `a.dtype` — the
kernel's arithmetic, with the dense weight materialized. The CPU tests hold
it against the JAX kernel; on the card `chip_smoke.py` holds the CUDA kernel
against it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.palette.palette_matmul import unpack_dense


def palette_matmul_ref(a: torch.Tensor, packed: torch.Tensor,
                       lut: torch.Tensor) -> torch.Tensor:
    w = unpack_dense(packed, lut.float()).to(a.dtype)
    return torch.einsum("mk,kn->mn", a.float(), w.float()).to(a.dtype)
