"""Bridge trees of numpy arrays into the port's tensors, and caches back.

The reference draws its weights from `jax.random`, which torch cannot
reproduce, so a run that must match the reference takes the reference's
parameters: the caller hands over each leaf as `np.asarray(leaf)` in the
reference's tree layout, e.g. for tinyllama

    {"embed": {"table", "unembed"}, "final_ln": {"scale"},
     "layers": [{"sub0": {"ln1", "ln2", "mix": {"wq", "wk", "wv", "wo"},
                          "mlp": {"wg", "wu", "wd"}}}]}

bfloat16 leaves arrive with numpy's extension dtype named "bfloat16"; they
are reinterpreted bit for bit, so no value changes on the way in. A shrink
drafter's params (the reference `Drafter.params`, a one-layer tree of the
same layout) cross the same way, with `draft_of(cfg)` as the config, and
serve through `launch.speculative.Drafter.shrink(..., params=...)`.

A packed weight arrives as any object with `form` (an enum with `.value`,
or its string), `contract_shape`, `out_shape`, `dtype_name` and a `payload`
dict of numpy arrays — the reference's `DispatchedWeight` after
`jax.tree.map(np.asarray, ...)` has that shape — and becomes the port's
`DispatchedWeight` with the same payload, bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hal import WeightForm
from repro_torch.models.dispatched import DispatchedWeight
from repro_torch.tree import map_with_path, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int32": torch.int32, "uint8": torch.uint8}
_PACKED_FIELDS = ("form", "contract_shape", "out_shape", "dtype_name", "payload")


def tensor_from_numpy(x: Any, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if arr.dtype.name not in _DTYPES:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def packed_from_numpy(leaf: Any, device) -> DispatchedWeight:
    """A packed weight with numpy payload arrays as the port's node."""
    form = getattr(leaf.form, "value", leaf.form)
    return DispatchedWeight(WeightForm(form), tuple(leaf.contract_shape),
                            tuple(leaf.out_shape), str(leaf.dtype_name),
                            {k: tensor_from_numpy(v, device) for k, v in leaf.payload.items()})


def params_from_numpy(tree: Any, cfg: ModelConfig, device) -> Any:
    """The reference's parameter tree (numpy leaves, packed weights allowed)
    as the port's params. Checks the model's dtype against each dense matmul
    weight's dtype (a sparse payload's fp16 values serve a bf16 model)."""
    want = cfg.dtype

    def convert(path, leaf):
        if all(hasattr(leaf, f) for f in _PACKED_FIELDS):
            return packed_from_numpy(leaf, device)
        t = tensor_from_numpy(leaf, device)
        if path.rsplit("/", 1)[-1].startswith("w") or path.endswith("table"):
            if str(t.dtype).removeprefix("torch.") != want:
                raise TypeError(f"param {path!r}: {t.dtype}, config says {want}")
        return t

    return map_with_path(convert, tree)


def caches_from_numpy(tree: Any, device) -> Any:
    return tree_map(lambda leaf: tensor_from_numpy(leaf, device), tree)


def caches_to_numpy(tree: Any) -> Any:
    """The port's caches as numpy arrays; bf16 leaves widen exactly to fp32
    (numpy has no bfloat16 of its own)."""
    def convert(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(convert, tree)
