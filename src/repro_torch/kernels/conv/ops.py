"""Public entry points of the conv family (after `src/repro/kernels/conv/ops.py`):
`conv2d` with the fused epilogue and training gradients, `avg_pool`,
`max_pool`.

`conv2d`'s forward runs the kernel's wrapper (the CUDA kernel on a CUDA
tensor, its plain version on the CPU); its backward differentiates the plain
version `conv2d_ref`, epilogue included (the fused LUT's derivative is its
segment's slope), as the reference differentiates its jnp version
(:22-59). The pools are forward-only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv.conv2d import conv2d as _conv2d_kernel
from repro_torch.kernels.conv.pool import avg_pool, max_pool  # noqa: F401
from repro_torch.kernels.conv.ref import conv2d_ref


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, ane_mode, epilogue):
        ctx.save_for_backward(x, w, bias)
        ctx.options = stride, padding, ane_mode, epilogue
        return _conv2d_kernel(x, w, bias, stride=stride, padding=padding,
                              ane_mode=ane_mode, epilogue=epilogue)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from repro_torch.kernels.act_lut.ops import table_operands

        stride, padding, ane_mode, epilogue = ctx.options
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
            table = None if epilogue is None else table_operands(epilogue, g.device)
            out = conv2d_ref(*leaves, stride=stride, padding=padding, ane_mode=ane_mode,
                             epilogue_table=table)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        grads = [next(got) if t is not None and t.requires_grad else None for t in leaves]
        return (*grads, None, None, None, None)


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
           stride: tuple[int, int] = (1, 1), padding: str = "SAME",
           ane_mode: bool = False, epilogue: str | None = None) -> torch.Tensor:
    """NHWC conv through the kernel with the bias / saturation / LUT
    epilogue at its output port, differentiable in x, w and bias."""
    args = (x, w) if bias is None else (x, w, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Conv.apply(x, w, bias, stride, padding, ane_mode, epilogue)
    return _conv2d_kernel(x, w, bias, stride=stride, padding=padding, ane_mode=ane_mode,
                          epilogue=epilogue)
