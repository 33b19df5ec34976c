"""`attention`: the flash kernel's forward with a recompute backward.

After `src/repro/kernels/flash/ops.py:19-45`. Forward runs the kernel's
wrapper (`flash_attention`: the CUDA kernel on a CUDA tensor, its plain
version on the CPU) and keeps only q, k and v; backward recomputes the
attention through the port's blocked online-softmax `chunked_attention`
(`models/attention.py`) under autograd and returns its gradients, as the
reference differentiates its `chunked_attention`: no (S, S) intermediate is
stored, one extra forward is spent. A call that records no gradient is the
forward alone.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash.flash_attention import flash_attention


def _chunked_bhsd(q, k, v, causal: bool, window: int | None) -> torch.Tensor:
    from repro_torch.models.attention import chunked_attention   # models import kernels

    out = chunked_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window)
    return out.transpose(1, 2)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad[:3])]
            out = _chunked_bhsd(*leaves, ctx.causal, ctx.window)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(got) if t.requires_grad else None for t in leaves), None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              window: int | None = None) -> torch.Tensor:
    """q (B, H, Sq, d), k / v (B, KVH, Skv, d): the flash forward,
    differentiable in q, k and v."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window)
    return flash_attention(q, k, v, causal=causal, window=window)
