"""Dispatcher-routed layers: every weight matmul and attention cell.

After `src/repro/models/dispatched.py`: `linear` (:290, through
`_matmul_dense` :264 and `_matmul_packed` :275), the packed weights
(`DispatchedWeight` :53, `pack_linear_weight` :138, `packable` :181),
`flash_route` (:328), `decode_route` (:347), `route_and_run` (:253), the
dispatcher scope `use_dispatcher` / `active_dispatcher` (:198), the epilogue
fusion scope `fuse_epilogues` / `epilogue_fusion_active` (:220-236) and the
conv family's routes `conv2d`, `avg_pool` and `max_pool` (:368-446). Each
cell resolves through the active `KernelDispatcher`: a CUDA tensor runs the
hand-written kernel, a CPU tensor the kernel's plain PyTorch version.

A packed weight routes to the `palette` or `sparse` kernel, never to
`anemm`. On CUDA its activation must be fp32 or bf16: an fp16 model with a
packed form raises there (the reference's HAL gate would fall back to the
plain version instead; the port has no fallback on the card).

Training differentiates three routes, as the reference does: a dense
`linear` (`kernels.anemm.ops.matmul`: the kernel's or the plain forward,
plain fp32 products backward), `flash_route` (`kernels.flash.ops.attention`:
recompute backward) and `conv2d` (`kernels.conv.ops.conv2d`: the plain
version differentiated). Packed weights, the pools and an unfused `act_lut`
are forward-only and raise where a gradient is asked of them.

The port has no undispatched path: the reference's plain `dot_general`
and conv fallbacks would be library calls outside any kernel, so `linear`
and the conv family outside a dispatcher scope raise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.core.hal import WeightForm
from repro_torch.kernels.common import forward_only
from repro_torch.kernels.palette import palette_matmul as pm
from repro_torch.kernels.palette.ref import palette_matmul_ref
from repro_torch.kernels.sparse import sparse_matmul as sm
from repro_torch.kernels.sparse.ref import sparse_matmul_ref
from repro_torch.tree import register_node

# ---------------------------------------------------------------------------
# Weight-form-tagged packed weights
# ---------------------------------------------------------------------------

Payload = dict[str, torch.Tensor]
# Lloyd rounds of the palette codebook fit on the serving path
PALETTE_ITERS = 4


@dataclasses.dataclass(frozen=True)
class FormKernel:
    """Everything the port knows of one packed weight form.

    `kernel` is the registry row that streams it, `keys` its payload's
    tensors in the kernel's argument order (the first carries the stack
    dims), `k_multiple` what the contraction extent must divide by. `pack`
    turns a 2-D (K, N) weight into a payload, `unpack` a 2-D payload back
    into the dense (K, N) weight (the FOLD path), and `run` / `plain` call
    the kernel's wrapper / its plain version as `fn(a, *payload)`."""

    kernel: str
    keys: tuple[str, ...]
    k_multiple: int
    pack: Callable[[torch.Tensor], Payload]
    unpack: Callable[..., torch.Tensor]
    run: Callable[..., torch.Tensor]
    plain: Callable[..., torch.Tensor]

    def args(self, payload: Payload) -> tuple[torch.Tensor, ...]:
        return tuple(payload[k] for k in self.keys)


# WeightForm -> how the port packs and streams it
FORM_KERNELS: dict[WeightForm, FormKernel] = {
    WeightForm.INT4_PALETTE: FormKernel(
        "palette", ("packed", "lut"), 2,
        lambda w: dict(zip(("packed", "lut"), pm.pack_kn(w, iters=PALETTE_ITERS))),
        pm.unpack_dense, pm.palette_matmul, palette_matmul_ref),
    WeightForm.SPARSE: FormKernel(
        "sparse", ("values", "selector"), 16,
        lambda w: dict(zip(("values", "selector"), sm.pack_pair_sparse(w))),
        sm.unpack_dense, sm.sparse_matmul, sparse_matmul_ref),
}


@dataclasses.dataclass
class DispatchedWeight:
    """A packed weight and its static routing tag.

    `payload` holds the form's tensors (`FORM_KERNELS[form].keys`), packed
    over the 2-D matmul view (K = product of the contracted dims, N =
    product of the output dims) with any stack dims (the layer axis)
    leading. `contract_shape` / `out_shape` keep the logical dense layout
    and `dtype_name` the dense dtype. The class is a node of
    `repro_torch.tree`: a walk goes into `payload` and rebuilds the node
    with its tag, as `jax.tree` does through the reference's pytree
    registration, so slicing a layer out of a stack keeps the form."""

    form: WeightForm
    contract_shape: tuple[int, ...]
    out_shape: tuple[int, ...]
    dtype_name: str
    payload: Payload

    @property
    def spec(self) -> FormKernel:
        return FORM_KERNELS[self.form]

    @property
    def kernel(self) -> str:
        return self.spec.kernel

    @property
    def n_stack(self) -> int:
        """Leading stack dims still carried by the payload; 0 at the 2-D
        matmul view."""
        return self.payload[self.spec.keys[0]].ndim - 2

    def index(self, i) -> "DispatchedWeight":
        """Slice the leading stack dim."""
        return dataclasses.replace(self, payload={k: v[i] for k, v in self.payload.items()})

    def dense(self) -> torch.Tensor:
        """Decode the 2-D payload to the logical dense weight: the FOLD path."""
        if self.n_stack:
            raise ValueError("dense() wants the 2-D matmul view; slice stack dims first")
        w2 = self.spec.unpack(*self.spec.args(self.payload))
        return w2.reshape(self.contract_shape + self.out_shape).to(
            getattr(torch, self.dtype_name))


register_node(
    DispatchedWeight,
    lambda w: ((w.form.value, w.contract_shape, w.out_shape, w.dtype_name), w.payload),
    lambda static, payload: DispatchedWeight(WeightForm(static[0]), *static[1:], payload))


def pack_linear_weight(w: torch.Tensor, form: WeightForm, *, n_contract: int,
                       n_out: int) -> DispatchedWeight:
    """Pack one logical weight (stack dims + contract dims + out dims) into
    `form` on `w`'s device. Stack dims stay leading payload dims, with one
    codebook per slice, in `np.ndindex` order as the reference packs them."""
    pack = FORM_KERNELS[form].pack
    n_stack = w.ndim - n_contract - n_out
    if n_stack < 0:
        raise ValueError(f"weight rank {w.ndim} < contract {n_contract} + out {n_out}")
    contract_shape = tuple(w.shape[n_stack:n_stack + n_contract])
    out_shape = tuple(w.shape[n_stack + n_contract:])
    lead = tuple(w.shape[:n_stack])
    w2 = w.reshape(lead + (math.prod(contract_shape), math.prod(out_shape)))
    if not lead:
        payload = pack(w2)
    else:
        slices = [pack(w2[idx]) for idx in np.ndindex(*lead)]
        payload = {key: torch.stack([s[key] for s in slices]).reshape(
            lead + tuple(slices[0][key].shape)) for key in slices[0]}
    return DispatchedWeight(form, contract_shape, out_shape,
                            str(w.dtype).removeprefix("torch."), payload)


def packable(form: WeightForm, k: int) -> bool:
    """Can a matmul view with contraction extent `k` pack into `form`?"""
    return form in FORM_KERNELS and k % FORM_KERNELS[form].k_multiple == 0


# ---------------------------------------------------------------------------
# Dispatcher scope and routed execution
# ---------------------------------------------------------------------------

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


_FUSION: list[bool] = []


@contextlib.contextmanager
def fuse_epilogues(on: bool) -> Iterator[None]:
    """Scope the conv LUT-epilogue fusion choice. Fused (the default) runs
    the activation at the producing kernel's output port, one launch;
    unfused routes a separate `act_lut` afterwards, the two-launch pipeline.
    Both give the same bits."""
    _FUSION.append(on)
    try:
        yield
    finally:
        _FUSION.pop()


def epilogue_fusion_active() -> bool:
    return _FUSION[-1] if _FUSION else True


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
    disp.count(route)
    return native() if route.native else oracle()


def _matmul_dense(disp: KernelDispatcher, a2: torch.Tensor,
                  w2: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.anemm import ops as anemm_ops

    # a weight of another dtype than the activation converts in one
    # contiguous copy (`to` aliases a same-dtype view whatever the memory
    # format); the heads arrive in fp32 already (`layers.fp32_head`)
    w2 = w2.to(a2.dtype, memory_format=torch.contiguous_format) \
        if w2.dtype != a2.dtype else w2.contiguous()
    if anemm_ops.reusing():           # a `dots` recompute: the kept product
        return anemm_ops.reuse(a2, w2)
    return route_and_run(disp, "anemm", a2, lambda: anemm_ops.matmul(a2, w2),
                         lambda: anemm_ops.matmul(a2, w2, plain=True))


def _matmul_packed(disp: KernelDispatcher, a2: torch.Tensor,
                   w: DispatchedWeight) -> torch.Tensor:
    forward_only(f"a packed {w.form.value} weight", a2, *w.payload.values())
    spec, args = w.spec, w.spec.args(w.payload)
    return route_and_run(disp, w.kernel, a2, lambda: spec.run(a2, *args),
                         lambda: spec.plain(a2, *args))


def linear(x: torch.Tensor, w: torch.Tensor | DispatchedWeight, *, n_contract: int = 1,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """The matmul every layer calls: contract the trailing `n_contract` dims
    of `x` with the leading dims of `w`. A dense weight runs through the
    `anemm` row, a packed one through its form's row (`palette`/`sparse`)."""
    disp = _require_dispatcher("linear()")
    k = math.prod(x.shape[x.ndim - n_contract:])
    a2 = x.reshape(-1, k).contiguous()
    if isinstance(w, DispatchedWeight):
        if w.n_stack:
            raise ValueError(f"packed weight still carries {w.n_stack} stack dims; "
                             "slice before linear()")
        out2 = _matmul_packed(disp, a2, w)
        out_shape = w.out_shape
    else:
        out2 = _matmul_dense(disp, a2, w.reshape(k, -1))
        out_shape = tuple(w.shape[n_contract:])
    out = out2.reshape(x.shape[:x.ndim - n_contract] + out_shape)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def flash_route(disp: KernelDispatcher, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Fused-attention cell for (B, S, H, dh)-layout q/k/v: the flash kernel
    on (B, H, S, dh) transposed views (no copies; recompute backward), or
    the chunked online-softmax plain version."""
    def native():
        from repro_torch.kernels.flash import ops as flash_ops
        out = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal)
        return out.transpose(1, 2)

    def oracle():
        from repro_torch.models.attention import chunked_attention
        return chunked_attention(q, k, v, causal=causal)

    return route_and_run(disp, "flash", q, native, oracle)


def decode_route(disp: KernelDispatcher, q: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 positions: torch.Tensor, current: torch.Tensor, *,
                 window: int | None = None) -> torch.Tensor:
    """One-token decode cell: q (B, H, dh) against a (B, S, KV, dh) cache;
    `window` masks slots `window` or more positions behind `current` (a
    sliding-window layer's ring)."""
    from repro_torch.kernels.flash.decode_attention import (decode_attention,
                                                            decode_attention_ref)
    q = q.contiguous()
    current = current.contiguous()
    return route_and_run(
        disp, "decode_attention", q,
        lambda: decode_attention(q, k_cache, v_cache, positions, current, window=window),
        lambda: decode_attention_ref(q, k_cache, v_cache, positions, current, window=window))


# ---------------------------------------------------------------------------
# Conv-family routes (encoder stems, vision front ends)
# ---------------------------------------------------------------------------


def conv2d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
           stride: tuple[int, int] = (1, 1), padding: str = "SAME",
           act: str | None = None) -> torch.Tensor:
    """The conv every encoder stem calls (NHWC x, HWIO w). With `act` and
    fusion on (the default): ONE routed `conv2d` with the LUT activation at
    its output port; with fusion off: a routed `conv2d`, then a routed
    `act_lut`, bit-identical."""
    from repro_torch.kernels.act_lut.ops import lut_activation, lut_apply_ref, table_operands
    from repro_torch.kernels.conv.ops import conv2d as conv_kernel
    from repro_torch.kernels.conv.ref import conv2d_ref

    disp = _require_dispatcher("conv2d()")
    epilogue = act if act is not None and epilogue_fusion_active() else None
    table = None if epilogue is None else table_operands(epilogue, x.device)
    out = route_and_run(
        disp, "conv2d", x,
        lambda: conv_kernel(x, w, bias, stride=stride, padding=padding, epilogue=epilogue),
        lambda: conv2d_ref(x, w, bias, stride=stride, padding=padding,
                           epilogue_table=table))
    if act is None or epilogue is not None:
        return out
    forward_only("an unfused act_lut", out)
    return route_and_run(disp, "act_lut", out, lambda: lut_activation(act)(out),
                         lambda: lut_apply_ref(out, act))


def _pool(x: torch.Tensor, *, window, stride, padding, kind: str) -> torch.Tensor:
    from repro_torch.kernels.conv import ops as conv_ops
    from repro_torch.kernels.conv import ref as conv_ref

    native = getattr(conv_ops, kind)
    plain = getattr(conv_ref, f"{kind}_ref")
    disp = _require_dispatcher(f"{kind}()")
    forward_only(kind, x)
    return route_and_run(
        disp, kind, x,
        lambda: native(x, window=window, stride=stride, padding=padding),
        lambda: plain(x, window=window, stride=stride, padding=padding))


def avg_pool(x: torch.Tensor, *, window: tuple[int, int],
             stride: tuple[int, int] | None = None, padding: str = "VALID") -> torch.Tensor:
    """Routed NHWC average pooling (count-include-pad)."""
    return _pool(x, window=window, stride=stride or window, padding=padding, kind="avg_pool")


def max_pool(x: torch.Tensor, *, window: tuple[int, int],
             stride: tuple[int, int] | None = None, padding: str = "VALID") -> torch.Tensor:
    """Routed NHWC max pooling."""
    return _pool(x, window=window, stride=stride or window, padding=padding, kind="max_pool")
