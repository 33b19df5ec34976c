"""Decoder stack: residual blocks, layer groups, stacked parameters and caches.

After `src/repro/models/transformer.py`: `init_layer` (:37) and
`apply_layer` (:57) with their MoE branch (:50-51, :88-91), the runs of equal
`layer_signature` (:107-133, so leading dense layers before MoE ones form a
group of their own) and `init_stack` / `init_stack_cache` / `apply_stack`
(:136-239). Parameters and caches keep the reference's stacked layout — a
list of groups, each `{"sub0": {...}}` with a leading layer axis — so both
compare leaf for leaf with the reference's trees. A Python loop over a
group's layers replaces `lax.scan`; layer `i` reads `leaf[i]`, a view.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import Params, apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.tree import tree_map


def layer_signature(cfg: ModelConfig, idx: int) -> tuple[str, bool]:
    return (cfg.block_kind(idx), cfg.layer_is_moe(idx))


def check_supported(cfg: ModelConfig) -> None:
    """The port serves GQA decoders (dense, QK-norm, one-device MoE) and the
    encoder-decoder so far; refuse anything else loudly."""
    unsupported = [name for name, on in (
        (f"family {cfg.family!r}", cfg.family not in ("dense", "moe", "encdec")),
        ("block_pattern", bool(cfg.block_pattern)),
        ("MLA", cfg.use_mla),
        ("attn_window", cfg.attn_window is not None),
        ("mtp_depth", cfg.mtp_depth > 0),
    ) if on]
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(unsupported)}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, sig: tuple[str, bool], dtype,
               count: int) -> Params:
    """`count` stacked attention layers with an MLP, or with the MoE block
    where `sig` says so."""
    _, is_moe = sig
    stack, dev = (count,), gen.device
    p = {"ln1": init_norm(cfg, cfg.d_model, dev, stack),
         "ln2": init_norm(cfg, cfg.d_model, dev, stack),
         "mix": attn_lib.init_attention(gen, cfg, dtype, stack)}
    if is_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, stack)
    else:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, dtype, stack)
    return p


def apply_layer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str,
                cache: Params | None) -> tuple[torch.Tensor, Params | None]:
    """One residual block; the MoE's load-balance loss is a training term
    and is dropped here."""
    h = apply_norm(cfg, p["ln1"], x)
    out, new_cache = attn_lib.attention_forward(cfg, p["mix"], h, positions,
                                                mode=mode, cache=cache)
    x = x + out
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        out, _ = moe_lib.moe_forward(cfg, p["moe"], h)
    else:
        out = apply_mlp(cfg, p["mlp"], h)
    return x + out, new_cache


def layer_groups(cfg: ModelConfig) -> list[tuple[tuple[tuple[str, bool], ...], int]]:
    """Runs of layers with one structure; a dense stack is one group, an MoE
    stack with leading dense layers two."""
    groups: list[tuple[tuple[tuple[str, bool], ...], int]] = []
    i = 0
    while i < cfg.n_layers:
        sig = layer_signature(cfg, i)
        j = i
        while j < cfg.n_layers and layer_signature(cfg, j) == sig:
            j += 1
        groups.append(((sig,), j - i))
        i = j
    return groups


def init_stack(gen: torch.Generator, cfg: ModelConfig, dtype) -> list[Params]:
    """One stacked-param tree per group (leading dim = group length)."""
    return [{"sub0": init_layer(gen, cfg, sigs[0], dtype, count)}
            for sigs, count in layer_groups(cfg)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> list[Params]:
    return [{"sub0": attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device,
                                            (count,))}
            for _, count in layer_groups(cfg)]


def apply_stack(cfg: ModelConfig, stacks: list[Params], x: torch.Tensor,
                positions: torch.Tensor, *, mode: str,
                caches: list[Params] | None = None) -> tuple[torch.Tensor, list[Params]]:
    """prefill: builds and returns stacked caches; decode: updates `caches`
    in place and returns them."""
    new_caches: list[Params] = []
    for gi, (_, count) in enumerate(layer_groups(cfg)):
        stacked = stacks[gi]["sub0"]
        gcache = caches[gi]["sub0"] if caches is not None else None
        per_layer: list[Any] = []
        for i in range(count):
            unit_p = tree_map(lambda a: a[i], stacked)
            unit_c = tree_map(lambda a: a[i], gcache) if gcache is not None else None
            x, nc = apply_layer(cfg, unit_p, x, positions, mode=mode, cache=unit_c)
            per_layer.append(nc)
        if mode == "prefill":
            new_caches.append({"sub0": {name: torch.stack([c[name] for c in per_layer])
                                        for name in per_layer[0]}})
        else:
            new_caches.append(caches[gi])
    return x, new_caches
