"""Public wrapper: pack once, stream many.

After `src/repro/kernels/palette/ops.py:19`. `PaletteLinear` holds the
packed weight and its codebook (`pack_kn`, on the weight's device) and
applies the matmul through `palette_matmul`: a CUDA tensor launches
`csrc/palette_matmul.cu`, a CPU tensor runs the plain version.
`hbm_bytes()` is what crosses device memory per call (the packed nibbles
and the fp32 codebook), `dense_bytes()` the 16-bit dense weight's bytes.
Forward-only, as the reference's: asked for a gradient it raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import forward_only
from repro_torch.kernels.palette.palette_matmul import pack_kn, palette_matmul


@dataclasses.dataclass
class PaletteLinear:
    packed: torch.Tensor      # (K/2, N) uint8
    lut: torch.Tensor         # (16,) fp32
    shape: tuple[int, int]    # (K, N)

    @classmethod
    def pack(cls, w: torch.Tensor | np.ndarray) -> "PaletteLinear":
        w = torch.as_tensor(w)
        packed, lut = pack_kn(w)
        return cls(packed, lut, tuple(w.shape))

    def __call__(self, a: torch.Tensor) -> torch.Tensor:
        forward_only("PaletteLinear", a)
        return palette_matmul(a, self.packed, self.lut)

    def hbm_bytes(self) -> int:
        return self.packed.numel() * 1 + self.lut.numel() * 4

    def dense_bytes(self) -> int:
        return self.shape[0] * self.shape[1] * 2
