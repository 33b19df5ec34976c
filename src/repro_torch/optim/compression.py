"""Model-weight compression for serving (the weight-form half).

After `src/repro/optim/compression.py:50-142`: tag the matmul weights of a
parameter tree with a `WeightForm` and pack them (`compress_model_params`),
so the dispatcher streams them through the `palette` / `sparse` kernels
instead of folding them to dense. Packing runs on the parameters' own device.
The int8 gradient compression of the reference's second half comes with the
training slice.
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


def matmul_view(path: str) -> tuple[int, int] | None:
    """(n_contract, n_out) of the leaf at `path`, or None if it is not an
    eligible matmul weight (reference :63, cut to the layouts of the
    configurations the port has: attention under "mix", the gated MLP under
    "mlp", and the head). Leading dims beyond the view are stack dims; an
    attention "wo" contracts two dims."""
    parts = path.split("/")
    name = parts[-1]
    if "mix" in parts and name in ("wq", "wk", "wv"):
        return (1, 2)
    if "mix" in parts and name == "wo":
        return (2, 1)
    if "mlp" in parts and name in ("wg", "wu", "wd"):
        return (1, 1)
    if name == "unembed":
        return (1, 1)
    return None


def compress_model_params(params: Any, form: WeightForm | str) -> Any:
    """Tag and pack every eligible matmul weight of a parameter tree, on the
    parameters' device (reference :87). Leaves whose contraction extent
    cannot pack into `form` (palette wants K even, sparse K % 16 == 0) stay
    dense and keep routing through `anemm`."""
    form = WeightForm(form)
    if "encdec" in params:
        raise NotImplementedError("packed weight forms of the encoder-decoder's "
                                  "layouts are not ported yet")
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
