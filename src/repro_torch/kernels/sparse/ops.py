"""Public wrapper for the pair-structured sparse linear.

After `src/repro/kernels/sparse/ops.py:14`. `SparseLinear` holds the 1:2
packed weight (`pack_pair_sparse`, on the weight's device: fp16 values and
one selector bit a pair) and applies the matmul through `sparse_matmul`: a
CUDA tensor launches `csrc/sparse_matmul.cu`, a CPU tensor runs the plain
version. `hbm_bytes()` is what crosses device memory per call,
`dense_bytes()` the 16-bit dense weight's bytes. Forward-only, as the
reference's: asked for a gradient it raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import forward_only
from repro_torch.kernels.sparse.sparse_matmul import pack_pair_sparse, sparse_matmul


@dataclasses.dataclass
class SparseLinear:
    values: torch.Tensor      # (K/2, N) fp16
    selector: torch.Tensor    # (K/16, N) uint8
    shape: tuple[int, int]    # (K, N)

    @classmethod
    def pack(cls, w: torch.Tensor | np.ndarray) -> "SparseLinear":
        w = torch.as_tensor(w)
        values, selector = pack_pair_sparse(w)
        return cls(values, selector, tuple(w.shape))

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        forward_only("SparseLinear", a)
        return sparse_matmul(a, self.values, self.selector)

    def hbm_bytes(self) -> int:
        return self.values.numel() * self.values.element_size() + self.selector.numel()

    def dense_bytes(self) -> int:
        return self.shape[0] * self.shape[1] * 2
