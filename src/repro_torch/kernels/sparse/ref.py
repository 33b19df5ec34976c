"""Plain PyTorch version of sparse_matmul (after `src/repro/kernels/sparse/ref.py`).

Rebuild the dense weight, round it to `a.dtype`, multiply with an fp32
accumulator and round once to `a.dtype`: the kernel's arithmetic with the
dense weight materialized.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sparse.sparse_matmul import unpack_dense


def sparse_matmul_ref(a: torch.Tensor, values: torch.Tensor,
                      selector: torch.Tensor) -> torch.Tensor:
    w = unpack_dense(values, selector).to(a.dtype)
    return torch.einsum("mk,kn->mn", a.float(), w.float()).to(a.dtype)
