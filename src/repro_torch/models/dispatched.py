"""Dispatcher-routed layers: every weight matmul and attention cell.

After `src/repro/models/dispatched.py`: the dense path of `linear` (:290,
through `_matmul_dense` :264), `flash_route` (:328), `decode_route` (:347),
`route_and_run` (:253) and the dispatcher scope `use_dispatcher` /
`active_dispatcher` (:198). Each cell resolves through the active
`KernelDispatcher`: a CUDA tensor runs the hand-written kernel, a CPU tensor
the kernel's plain PyTorch version. The packed weight forms
(`DispatchedWeight`) wait for the palette slice.

The port has no undispatched matmul path: the reference's plain
`dot_general` fallback would be a library matmul outside any kernel, so
`linear` outside a dispatcher scope raises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Iterator

import torch

from repro_torch.core.dispatch import KernelDispatcher

_SCOPE: list[KernelDispatcher] = []


@contextlib.contextmanager
def use_dispatcher(dispatcher: KernelDispatcher) -> Iterator[None]:
    """Route every `linear`/attention call inside through `dispatcher`."""
    _SCOPE.append(dispatcher)
    try:
        yield
    finally:
        _SCOPE.pop()


def active_dispatcher() -> KernelDispatcher | None:
    return _SCOPE[-1] if _SCOPE else None


def _require_dispatcher(what: str) -> KernelDispatcher:
    disp = active_dispatcher()
    if disp is None:
        raise RuntimeError(f"{what} runs through a KernelDispatcher: "
                           "enter use_dispatcher() first")
    return disp


def route_and_run(disp: KernelDispatcher, name: str, x: torch.Tensor,
                  native: Callable[[], Any], oracle: Callable[[], Any]):
    """One op-by-device cell: resolve by `x`'s device and dtype, record the
    route, run the winning leg."""
    route = disp.resolve(name, x)
    disp.routes[route] += 1
    return native() if route.native else oracle()


def _matmul_dense(disp: KernelDispatcher, a2: torch.Tensor,
                  w2: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.anemm.anemm import anemm
    from repro_torch.kernels.anemm.ref import anemm_ref

    w2 = w2.to(a2.dtype)
    return route_and_run(disp, "anemm", a2, lambda: anemm(a2, w2),
                         lambda: anemm_ref(a2, w2))


def linear(x: torch.Tensor, w: torch.Tensor, *, n_contract: int = 1,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """The matmul every layer calls: contract the trailing `n_contract` dims
    of `x` with the leading dims of `w`, through the `anemm` row."""
    disp = _require_dispatcher("linear()")
    k = math.prod(x.shape[x.ndim - n_contract:])
    out2 = _matmul_dense(disp, x.reshape(-1, k).contiguous(),
                         w.reshape(k, -1).contiguous())
    out = out2.reshape(x.shape[:x.ndim - n_contract] + w.shape[n_contract:])
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def flash_route(disp: KernelDispatcher, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Fused-attention cell for (B, S, H, dh)-layout q/k/v: the flash kernel
    on (B, H, S, dh) transposed views (no copies), or the chunked
    online-softmax plain version."""
    def native():
        from repro_torch.kernels.flash.flash_attention import flash_attention
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)

    def oracle():
        from repro_torch.models.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal)

    return route_and_run(disp, "flash", q, native, oracle)


def decode_route(disp: KernelDispatcher, q: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 positions: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
    """One-token decode cell: q (B, H, dh) against a (B, S, KV, dh) cache."""
    from repro_torch.kernels.flash.decode_attention import (decode_attention,
                                                            decode_attention_ref)
    q = q.contiguous()
    current = current.contiguous()
    return route_and_run(
        disp, "decode_attention", q,
        lambda: decode_attention(q, k_cache, v_cache, positions, current),
        lambda: decode_attention_ref(q, k_cache, v_cache, positions, current))
