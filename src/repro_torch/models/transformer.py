"""Decoder stack: residual blocks, layer groups, stacked parameters and caches.

After `src/repro/models/transformer.py`: `init_layer` (:37) and
`apply_layer` (:57) with their block kinds (attention, `rglru`, `ssm`: an
SSM layer is a norm and the mixer, with no `ln2` and no MLP, :42-44, :81-84)
and their MoE branch (:50-51, :88-91), `init_layer_cache` (:97-104),
`layer_groups` (:107-133: a block-patterned hybrid groups whole pattern
periods, then its remaining layers one by one; otherwise runs of equal
`layer_signature`, so leading dense layers before MoE ones form a group of
their own) and `init_stack` / `init_stack_cache` / `apply_stack`
(:136-239); an MLA layer's mixer and cache are MLA's (`models.attention`).
Parameters and caches keep the reference's stacked layout — a
list of groups, each `{"sub0": {...}, "sub1": ...}` (one entry a layer of
the group's unit) with a leading unit axis — so both compare leaf for leaf
with the reference's trees. A Python loop over a group's units replaces
`lax.scan`; unit `i` reads `leaf[i]`, a view.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.anemm.ops import save_products
from repro_torch.models import attention as attn_lib
from repro_torch.models import dispatched as dsp
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import Params, apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.tree import tree_map

Signature = tuple[str, bool]


def layer_signature(cfg: ModelConfig, idx: int) -> tuple[str, bool]:
    return (cfg.block_kind(idx), cfg.layer_is_moe(idx))


FAMILIES = ("dense", "moe", "encdec", "ssm", "hybrid")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves every family of the reference: GQA and MLA decoders
    (dense, QK-norm, sliding-window, one-device MoE, an MTP module's
    parameters), the RG-LRU hybrid, the SSM and the encoder-decoder; refuse
    any other family loudly."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: not ported: family {cfg.family!r}")


def init_layer(gen: torch.Generator, cfg: ModelConfig, sig: Signature, dtype,
               count: int | None) -> Params:
    """`count` stacked layers of kind `sig` (`count=None`: one layer with no
    stack axis, as the reference's `init_layer` returns it, :37): a norm and
    the SSM mixer, or a norm, the attention or RG-LRU mixer, a norm and the
    MLP (the MoE block where `sig` says so)."""
    kind, is_moe = sig
    stack, dev = (() if count is None else (count,)), gen.device
    p: Params = {"ln1": init_norm(cfg, cfg.d_model, dev, stack)}
    if kind == "ssm":
        p["mix"] = ssm_lib.init_ssm(gen, cfg, dtype, stack)
        return p
    p["ln2"] = init_norm(cfg, cfg.d_model, dev, stack)
    if kind == "rglru":
        p["mix"] = rglru_lib.init_rglru(gen, cfg, dtype, stack)
    else:
        p["mix"] = attn_lib.init_attention(gen, cfg, dtype, stack)
    if is_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, stack)
    else:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, dtype, stack)
    return p


def apply_layer(cfg: ModelConfig, sig: Signature, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *, mode: str,
                cache: Params | None) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """One residual block: (x, its cache or None, the MoE's load-balance
    loss as an fp32 scalar, or None for a dense block)."""
    kind, _ = sig
    aux = None
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "ssm":
        out, new_cache = ssm_lib.ssm_forward(cfg, p["mix"], h, mode=mode, cache=cache)
        return x + out, new_cache, aux
    if kind == "rglru":
        out, new_cache = rglru_lib.rglru_forward(cfg, p["mix"], h, mode=mode, cache=cache)
    else:
        out, new_cache = attn_lib.attention_forward(cfg, p["mix"], h, positions,
                                                    mode=mode, cache=cache)
    x = x + out
    h = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        out, aux = moe_lib.moe_forward(cfg, p["moe"], h)
    else:
        out = apply_mlp(cfg, p["mlp"], h)
    return x + out, new_cache, aux


def init_layer_cache(cfg: ModelConfig, sig: Signature, batch: int, max_len: int, dtype,
                     device, count: int) -> Params:
    """`count` stacked caches of kind `sig`: the SSM's state and conv
    tails, the RG-LRU's h and conv tail, or attention's K/V (a ring for a
    sliding-window layer)."""
    kind, _ = sig
    stack = (count,)
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device, stack)
    if kind == "rglru":
        return rglru_lib.init_rglru_cache(cfg, batch, dtype, device, stack)
    return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device, stack)


def layer_groups(cfg: ModelConfig) -> list[tuple[tuple[Signature, ...], int]]:
    """Groups of stacked units. A block-patterned hybrid's unit is one whole
    pattern period (recurrentgemma-9b: 12 periods of (rglru, rglru, attn)),
    then its remaining layers one group each (2); otherwise a unit is one
    layer and a group a run of equal signatures (a dense stack one group,
    an MoE stack with leading dense layers two)."""
    if cfg.block_pattern:
        period = len(cfg.block_pattern)
        n_periods = cfg.n_layers // period
        groups = [(tuple(layer_signature(cfg, i) for i in range(period)), n_periods)]
        for li in range(n_periods * period, cfg.n_layers):
            groups.append(((layer_signature(cfg, li),), 1))
        return groups
    groups: list[tuple[tuple[Signature, ...], int]] = []
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
    return [{f"sub{i}": init_layer(gen, cfg, sig, dtype, count) for i, sig in enumerate(sigs)}
            for sigs, count in layer_groups(cfg)]


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> list[Params]:
    return [{f"sub{i}": init_layer_cache(cfg, sig, batch, max_len, dtype, device, count)
             for i, sig in enumerate(sigs)}
            for sigs, count in layer_groups(cfg)]


def remat(fn: Callable, policy: str) -> Callable:
    """`fn` under the config's remat policy (reference :166-172), as a
    non-reentrant `torch.utils.checkpoint` region: `full` keeps only the
    region's inputs and recomputes the rest in the backward, `dots` keeps
    the routed matmul products as well (`kernels.anemm.ops.save_products`),
    `none` keeps everything. The values are the same under every policy.
    The recompute runs under the dispatcher that was active in the forward."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"remat {policy!r} not in ('full', 'dots', 'none')")
    kw = {"context_fn": save_products} if policy == "dots" else {}
    disp = dsp.active_dispatcher()

    def scoped(*args):
        with dsp.use_dispatcher(disp):
            return fn(*args)

    return lambda *args: checkpoint(scoped, *args, use_reentrant=False, **kw)


def apply_stack(cfg: ModelConfig, stacks: list[Params], x: torch.Tensor,
                positions: torch.Tensor, *, mode: str,
                caches: list[Params] | None = None
                ) -> tuple[torch.Tensor, list[Params] | None, torch.Tensor | None]:
    """(x, caches, the MoE balance loss summed over layers). train: no
    caches, each unit under `cfg.remat`, the balance loss summed (None
    where no layer is MoE); prefill: builds and returns stacked caches;
    decode: updates `caches` in place and returns them. Serving sums no
    balance loss and returns None for it."""
    new_caches: list[Params] | None = None if mode == "train" else []
    aux_total = None
    for gi, (sigs, count) in enumerate(layer_groups(cfg)):
        def unit_fn(x, unit_p, unit_c, sigs=sigs):
            aux = None
            ncache = {}
            for j, sig in enumerate(sigs):
                sub = f"sub{j}"
                x, ncache[sub], a = apply_layer(
                    cfg, sig, unit_p[sub], x, positions, mode=mode,
                    cache=None if unit_c is None else unit_c[sub])
                if a is not None and mode == "train":
                    aux = a if aux is None else aux + a
            return x, ncache, aux

        if mode == "train":
            run = remat(lambda x, unit_p, fn=unit_fn: fn(x, unit_p, None)[::2], cfg.remat)
            for i in range(count):
                x, aux = run(x, tree_map(lambda a: a[i], stacks[gi]))
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
            continue
        per_unit = []
        for i in range(count):
            unit_p = tree_map(lambda a: a[i], stacks[gi])
            unit_c = tree_map(lambda a: a[i], caches[gi]) if caches is not None else None
            x, ncache, _ = unit_fn(x, unit_p, unit_c)
            per_unit.append(ncache)
        if mode == "prefill":
            new_caches.append({sub: {name: torch.stack([u[sub][name] for u in per_unit])
                                     for name in per_unit[0][sub]}
                               for sub in per_unit[0]})
        else:
            new_caches.append(caches[gi])
    return x, new_caches, aux_total
