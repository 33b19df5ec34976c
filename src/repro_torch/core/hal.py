"""Hardware abstraction layer of the port: the GPU targets it runs on.

After `src/repro/core/hal.py` (`Target` at :59), with only the fields this
port reads: the roofline constants that bound a kernel's time. The
reference's ANE capability surface (feature bytes, op floors, weight-form
streaming) is not ported yet; it arrives with `core/capability.py`. The
`WeightForm` tags of the compressed weights are the reference's (:25).

Every constant carries its provenance: `public` for NVIDIA's data sheet
values. The per-dispatch floor is not a constant here: it is measured on the
device (`core.dispatch.measure_dispatch_floor`).
"""

from __future__ import annotations

import dataclasses
import enum


class WeightForm(enum.Enum):
    """Compressed-weight forms the datapath reconstructs (paper ch. 7)."""

    FP16 = "fp16"
    INT8 = "int8"                # per-tensor / per-channel affine
    INT4_PALETTE = "int4_palette"  # 16-entry codebook, 4-bit indices
    SPARSE = "sparse"            # 1:2 keep bits + packed fp16 nonzeros
    BLOCKWISE = "blockwise"      # per-block affine scales


@dataclasses.dataclass(frozen=True)
class Target:
    """One hardware target: the roofline constants of a kernel's bound."""

    name: str
    sku: str                      # the name nvidia-smi reports for the card
    peak_flops: float             # FLOP/s, dense bf16/fp16 on the tensor cores
    peak_flops_fp32: float        # FLOP/s, fp32 FMA outside the tensor cores
    hbm_bandwidth: float          # bytes/s, device memory

    def peak_for(self, dtype_name: str) -> float:
        """Peak operation rate for inputs of `dtype_name`."""
        if dtype_name == "float32":
            return self.peak_flops_fp32
        return self.peak_flops


H100 = Target(
    name="h100",
    sku="NVIDIA H100 80GB HBM3",  # the SXM5 part
    peak_flops=989e12,            # public: H100 SXM data sheet, dense bf16/fp16
    peak_flops_fp32=67e12,        # public: H100 SXM data sheet, fp32
    hbm_bandwidth=3.35e12,        # public: H100 SXM data sheet, 80 GB HBM3
)

# ----------------------------------------------------------------------------
# ANE numeric constants shared with the kernels (reference hal.py:286)
# ----------------------------------------------------------------------------

ACCUM_OUT_CEILING = 32768.0           # 2^15 multiply-accumulate output port ceiling
LUT_KNOTS = 33                        # activation table knot count (reference :291)
SIGMOID_DOMAIN = (-9.938, 8.320)      # sigmoid table domain clamp (reference :293)
