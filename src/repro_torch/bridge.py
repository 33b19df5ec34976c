"""Bridge trees of numpy arrays into the port's tensors, and caches back.

The reference draws its weights from `jax.random`, which torch cannot
reproduce, so a run that must match the reference takes the reference's
parameters: the caller hands over each leaf as `np.asarray(leaf)` in the
reference's tree layout, e.g. for tinyllama

    {"embed": {"table", "unembed"}, "final_ln": {"scale"},
     "layers": [{"sub0": {"ln1", "ln2", "mix": {"wq", "wk", "wv", "wo"},
                          "mlp": {"wg", "wu", "wd"}}}]}

and for the other archs the same with QK-norm's fp32 `mix/q_scale` and
`mix/k_scale` (chameleon), or `moe: {"router", "wg", "wu", "wd"}` (and an
optional `shared` MLP) in place of `mlp` (dbrx: the fp32 router, the
expert banks stacked (layers, E, ...)); whisper's `encdec` tree likewise.
A recurrent stack's groups hold one `subN` a layer of the unit (the
hybrid's period: sub0/sub1 RG-LRU, sub2 attention): an RG-LRU mixer is
`{"linear_x", "linear_y", "w_r", "w_i", "out", "conv_w", "conv_b", "lam"}`,
an SSM mixer `{"w_z", "w_x", "w_b", "w_c", "w_dt", "out_proj", "conv_x_w",
"conv_x_b", "conv_bc_w", "conv_bc_b", "dt_bias", "a_log", "d_skip",
"norm_scale"}` (an SSM layer has `ln1` only); every leaf keeps its
reference dtype: `lam`, `dt_bias`, `a_log`, `d_skip` and `norm_scale` in
fp32, the projections and the conv banks in the model's dtype. An MLA
mixer (deepseek-v3-671b) is `{"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm",
"wkv_b", "wo"}` (the norms fp32, `wq_b` / `wkv_b` / `wo` 3-D), and a config
with `mtp_depth` adds `mtp: {"proj", "ln_h", "ln_e", "layer"}`, `layer` one
unstacked layer (no leading layer axis).

bfloat16 leaves arrive with numpy's extension dtype named "bfloat16"; they
are reinterpreted bit for bit, so no value changes on the way in. A shrink
drafter's params (the reference `Drafter.params`, a one-layer tree of the
same layout) cross the same way, with `draft_of(cfg)` as the config, and
serve through `launch.speculative.Drafter.shrink(..., params=...)`.

A packed weight arrives as any object with `form` (an enum with `.value`,
or its string), `contract_shape`, `out_shape`, `dtype_name` and a `payload`
dict of numpy arrays — the reference's `DispatchedWeight` after
`jax.tree.map(np.asarray, ...)` has that shape — and becomes the port's
`DispatchedWeight` with the same payload, bit for bit, stack dims (the
layer axis, an expert bank's expert axis) leading as they came.
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
