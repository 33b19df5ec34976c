"""`matmul`: the anemm route with training gradients.

After `src/repro/kernels/anemm/ops.py:20-36`. Forward runs the kernel's
wrapper (`anemm`: the CUDA kernel on a CUDA tensor) or, on the plain route,
its plain version `anemm_ref`; backward is two plain fp32 products, as the
reference computes them outside any Pallas kernel:

    da = (g32 @ b32.T).to(a.dtype)      db = (a32.T @ g32).to(b.dtype)

with TF32 off on the card, so both are true fp32 products. A call that
records no gradient (no input requires one, or grad mode is off: every
serving program) is the forward alone, with no autograd node.

`save_products` serves the `dots` remat policy (the reference's
`checkpoint_dots_with_no_batch_dims`, `models/transformer.py:166-172`):
inside a `torch.utils.checkpoint` region the products computed by the
forward are kept, and the recompute in the backward takes them back in
call order instead of computing them again, while everything between
them is recomputed. The values are the forward's, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch

from repro_torch.kernels.anemm.anemm import anemm
from repro_torch.kernels.anemm.ref import anemm_ref


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """fp32 products on the card without TF32 (the flag is global; restored
    on the way out)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor,
                fwd: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return fwd(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g32 = g.float()
        da = db = None
        with full_fp32():
            if ctx.needs_input_grad[0]:
                da = (g32 @ b.float().T).to(a.dtype)
            if ctx.needs_input_grad[1]:
                db = (a.float().T @ g32).to(b.dtype)
        return da, db, None


# open `save_products` regions, innermost last: ("keep" | "reuse", products)
_PRODUCTS: list[tuple[str, list[torch.Tensor]]] = []


@contextlib.contextmanager
def _products(mode: str, saved: list[torch.Tensor]) -> Iterator[None]:
    _PRODUCTS.append((mode, saved))
    try:
        yield
    finally:
        _PRODUCTS.pop()


def save_products():
    """`context_fn` of a non-reentrant `torch.utils.checkpoint` region under
    the `dots` policy: (the forward's context, which keeps each product,
    the recompute's, which reuses them in order)."""
    saved: list[torch.Tensor] = []
    return _products("keep", saved), _products("reuse", saved)


def reusing() -> bool:
    """Inside the recompute of a `dots` region: `reuse` hands back kept
    products and launches nothing."""
    return bool(_PRODUCTS) and _PRODUCTS[-1][0] == "reuse"


def reuse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The next kept product, as the output of this call's autograd node."""
    out = _PRODUCTS[-1][1].pop(0)
    return _Matmul.apply(a, b, lambda a, b: out)


def matmul(a: torch.Tensor, b: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """a (M, K) @ b (K, N) through `anemm` (`plain`: through `anemm_ref`),
    differentiable in both operands."""
    fwd = anemm_ref if plain else anemm
    if not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return fwd(a, b)
    out = _Matmul.apply(a, b, fwd)
    if _PRODUCTS and _PRODUCTS[-1][0] == "keep":
        _PRODUCTS[-1][1].append(out.detach())
    return out

