"""Model-weight compression for serving, and int8 gradient compression for
training.

After `src/repro/optim/compression.py`. The weight-form half (:50-142): tag
the matmul weights of a parameter tree with a `WeightForm` and pack them
(`compress_model_params`), so the dispatcher streams them through the
`palette` / `sparse` kernels instead of folding them to dense. Packing runs
on the parameters' own device.

The gradient half (:145-204): per-block symmetric int8 (`quantize_int8`,
blocks of `_BLOCK` = 256 values, one fp32 scale a block, round half to
even as `jnp.round` does), `dequantize_int8`, and error feedback over a
gradient tree (`compress_grads` / `decompress_grads`, the residual from
`init_residual`): every step is an exact IEEE operation, so the codes and
the residuals equal the reference's bit for bit. The all-reduce of the
codes (`compressed_psum`) comes with the multi-device slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.hal import WeightForm
from repro_torch.models import dispatched as dsp
from repro_torch.tree import leaves_with_path, map_with_path, tree_map


def _is_packed(x: Any) -> bool:
    return isinstance(x, dsp.DispatchedWeight)


# Module names that give a leaf its matmul view (reference :54-58). The
# attention test comes first: an attention "wo" contracts two dims, an MLP
# "wo" one.
_ATTN_CONTEXT = ("mix", "attn", "self_attn", "cross_attn")
_MLP_CONTEXT = ("mlp", "moe", "shared", "mtp")


def matmul_view(path: str) -> tuple[int, int] | None:
    """(n_contract, n_out) of the leaf at `path`, or None if it is not an
    eligible matmul weight (reference :63): the attention projections of a
    decoder, an encoder and both attentions of an encoder-decoder's decoder,
    the MLPs (gated or plain), the MoE expert banks and shared MLP, MLA's
    `wq_a` / `wkv_a`, the MTP module's `proj`, and the head. Leading dims
    beyond the view are stack dims (the layer axis, the expert axis); the
    conv stem and the router stay dense, and so do MLA's `wq_b` / `wkv_b`:
    the absorbed decode slices `wkv_b`, which a packed form cannot do."""
    parts = path.split("/")
    name = parts[-1]
    in_attn = any(c in parts for c in _ATTN_CONTEXT)
    if in_attn and name in ("wq", "wk", "wv"):
        return (1, 2)
    if in_attn and name == "wo":
        return (2, 1)
    if in_attn and name in ("wq_a", "wkv_a"):
        return (1, 1)
    if name in ("wi", "wg", "wu", "wd", "wo") and any(c in parts for c in _MLP_CONTEXT):
        return (1, 1)
    if name == "unembed" or (name == "proj" and "mtp" in parts):
        return (1, 1)
    return None


def compress_model_params(params: Any, form: WeightForm | str) -> Any:
    """Tag and pack every eligible matmul weight of a parameter tree, on the
    parameters' device (reference :87). Leaves whose contraction extent
    cannot pack into `form` (palette wants K even, sparse K % 16 == 0) stay
    dense and keep routing through `anemm`."""
    form = WeightForm(form)
    if form not in dsp.FORM_KERNELS:
        raise ValueError(f"{form} has no streaming kernel; "
                         f"have {sorted(f.value for f in dsp.FORM_KERNELS)}")

    def one(path: str, leaf: Any) -> Any:
        view = matmul_view(path)
        if view is None:
            return leaf
        n_contract, n_out = view
        if leaf.ndim < n_contract + n_out:
            return leaf
        n_stack = leaf.ndim - n_contract - n_out
        if not dsp.packable(form, int(np.prod(leaf.shape[n_stack:n_stack + n_contract]))):
            return leaf
        return dsp.pack_linear_weight(leaf, form, n_contract=n_contract, n_out=n_out)

    return map_with_path(one, params)


def decompress_model_params(params: Any) -> Any:
    """The FOLD path (reference :117): every packed weight decoded back to a
    dense tensor with its logical shape and dtype."""
    def one(leaf: Any) -> Any:
        if not _is_packed(leaf):
            return leaf
        lead = next(iter(leaf.payload.values())).shape[:leaf.n_stack]
        if not lead:
            return leaf.dense()
        flat = [leaf.index(idx).dense() for idx in np.ndindex(*lead)]
        return torch.stack(flat).reshape(tuple(lead) + tuple(flat[0].shape))
    return tree_map(one, params, is_leaf=_is_packed)


def weight_form_census(params: Any) -> dict[str, str]:
    """path -> form tag of every packed leaf (reference :133)."""
    return {path: leaf.form.value
            for path, leaf in leaves_with_path(params, is_leaf=_is_packed) if _is_packed(leaf)}


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback (reference :145-204)
# ---------------------------------------------------------------------------

_BLOCK = 256


def _pad_len(n: int) -> int:
    return (-n) % _BLOCK


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8. Returns (q (N/B, B) int8, scales (N/B,))."""
    flat = x.float().reshape(-1)
    pad = _pad_len(flat.numel())
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    # over a tensor on the same device: a CUDA tensor over a Python number
    # multiplies by its reciprocal, which is not the same rounding
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full((), 127.0, device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: tuple[int, ...]) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:int(np.prod(shape, dtype=np.int64))].reshape(shape)


def compress_grads(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Error-feedback compression of a gradient tree: (a tree of (q, scales)
    pairs, the new residual tree). The residual holds what quantization
    dropped and is added back into the next step's gradients."""
    def one(g, r):
        g32 = g.float() + (r if r is not None else 0.0)
        q, s = quantize_int8(g32)
        return (q, s), g32 - dequantize_int8(q, s, tuple(g.shape))

    flat_r = [r for _, r in leaves_with_path(residual)] if residual is not None else None
    pairs = [one(g, None if flat_r is None else flat_r[i])
             for i, (_, g) in enumerate(leaves_with_path(grads))]
    it_c, it_r = iter([c for c, _ in pairs]), iter([r for _, r in pairs])
    return tree_map(lambda _: next(it_c), grads), tree_map(lambda _: next(it_r), grads)


def decompress_grads(comp: Any, like: Any) -> Any:
    """The (q, scales) tree back to dense gradients of `like`'s shapes and
    dtypes."""
    pairs = [c for _, c in leaves_with_path(comp, is_leaf=lambda x: isinstance(x, tuple))]
    it = iter(pairs)
    return tree_map(lambda l: dequantize_int8(*next(it), tuple(l.shape)).to(l.dtype), like)


def init_residual(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads)
