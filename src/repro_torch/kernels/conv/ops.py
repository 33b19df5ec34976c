"""Public entry points of the conv family (after `src/repro/kernels/conv/ops.py`):
`conv2d` with the fused epilogue, `avg_pool`, `max_pool`. Inference only;
the conv's backward (`_conv_bwd`, reference :45) comes with training."""

from repro_torch.kernels.conv.conv2d import conv2d  # noqa: F401
from repro_torch.kernels.conv.pool import avg_pool, max_pool  # noqa: F401
