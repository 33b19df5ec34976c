"""Mixture-of-experts on one device: the dense path.

After `src/repro/models/moe.py`: `init_moe` (:38), `_route` (:55-67), the
dispatched loop of `_expert_ffn` (:70-86), `moe_dense` (:100-129) and
`moe_forward` (:277-293), which takes the dense path here: every expert
runs on every token, and the combine keeps each token's top-k outputs by
their renormalised gates. Exact, no capacity drops. The expert-parallel
path (`moe_ep`) waits for the mesh.

Every expert matmul is a routed `linear`, one bank at a time (a packed
bank sliced with `DispatchedWeight.index`); each token's k outputs are
picked a group of `EXPERT_GROUP` banks at a time, so no more than one
group's outputs are ever stacked. The router runs outside any
kernel, as in the reference, and every step of it is computed per row in an
order that does not depend on how many rows run: the fp32 product as a
pairwise tree of elementwise adds (`layers.row_sum`; no library GEMM, whose
algorithm may change with the row count), the softmax per row, and the
top-k as a stable descending sort, which puts the lower expert first on
ties as `jax.lax.top_k` does (`torch.topk` promises no order among equal
values).
The combine sums each token's k outputs in k order, in fp32, and rounds
once to the output dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp
from repro_torch.models.layers import Params, apply_mlp, gelu, init_mlp, normal, row_sum


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype,
             stack: tuple[int, ...] = ()) -> Params:
    """An fp32 router (d, E), stacked expert banks (E, d, f) / (E, f, d) and
    the optional shared MLP; `stack` leading dims for a layer group."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    std = d ** -0.5
    p: Params = {
        "router": normal(gen, stack + (d, e), torch.float32, std),
        "wg": normal(gen, stack + (e, d, f), dtype, std),
        "wu": normal(gen, stack + (e, d, f), dtype, std),
        "wd": normal(gen, stack + (e, f, d), dtype, f ** -0.5),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d, cfg.d_ff_expert * cfg.n_shared_experts,
                               dtype, stack)
    return p


# The router's (rows, E, d) fp32 products are formed this many bytes at a
# time at most (deepseek's 256 experts of 7,168 over a 512-token prefill
# would be 3.8 GB, held by the prefill's captured graph)
ROUTER_CHUNK_BYTES = 256 << 20


def router_logits(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, d) fp32 @ (d, E) fp32 -> (T, E): the products summed over d by
    `row_sum`'s pairwise tree, so every row's bits are the same whatever T
    is; the rows go in chunks of `ROUTER_CHUNK_BYTES` of products, which
    changes no row's bits."""
    wt = w.T[None]
    rows = max(1, ROUTER_CHUNK_BYTES // (wt[0].numel() * 4))
    return torch.cat([row_sum(x32[i:i + rows, None, :] * wt)[..., 0]   # (rows, E, d)
                      for i in range(0, x32.shape[0], rows)])


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k`: the k largest values per row, descending, the lower
    index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x (T, d) -> (gates (T, k) fp32, idx (T, k) int64, aux loss): the
    router in fp32, softmax, top-k, gates renormalised, and the Switch-style
    load-balance loss E · sum_e f_e · P_e (reference :55)."""
    logits = router_logits(x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, cfg.experts_per_token)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    me = probs.mean(0)                                           # P_e
    ce = F.one_hot(idx.reshape(-1), e).float().sum(0) * (
        1.0 / (x.shape[0] * cfg.experts_per_token))              # f_e
    return gates, idx, e * (me * ce).sum()


def _bank(w, e: int):
    return w.index(e) if isinstance(w, dsp.DispatchedWeight) else w[e]


# Experts run in groups of this many; a group's outputs (G, T, d) are the
# only stacked expert outputs alive at a time (deepseek's 256 banks over a
# 512-token prefill would stack 1.9 GB in bf16).
EXPERT_GROUP = 32


def expert_ffn(cfg: ModelConfig, wg, wu, wd, x: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """x (T, d) through every expert bank, one bank at a time, and each
    token's k routed outputs picked as the banks of a group finish:
    (T, k, d), slot j the output of expert `idx[:, j]`. The reference
    broadcasts the tokens to (E, T, d) and stacks every expert's output;
    each expert reads the same rows and the picks are the same values."""
    act = gelu if cfg.act == "gelu" else F.silu
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    picked = None
    for e0 in range(0, cfg.n_experts, EXPERT_GROUP):
        outs = []
        for e in range(e0, min(e0 + EXPERT_GROUP, cfg.n_experts)):
            g = act(dsp.linear(x, _bank(wg, e)))
            u = dsp.linear(x, _bank(wu, e))
            outs.append(dsp.linear((g * u).to(x.dtype), _bank(wd, e)))
        rel = idx - e0
        hit = (rel >= 0) & (rel < len(outs))
        got = torch.stack(outs)[rel.clamp(0, len(outs) - 1), t]      # (T, k, d)
        picked = got if picked is None else torch.where(hit[..., None], got, picked)
    return picked


def combine(picked: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """The reference's `einsum("tke,etd,tk->td", one_hot(idx), ye, gates)`
    with the gates in the outputs' dtype: each token's k picked expert
    outputs (T, k, d), summed in k order in fp32 and rounded once."""
    g = gates.to(picked.dtype).float()
    acc = g[:, 0, None] * picked[:, 0].float()
    for j in range(1, picked.shape[1]):
        acc = acc + g[:, j, None] * picked[:, j].float()
    return acc.to(picked.dtype)


def moe_dense(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux): every expert on every token,
    the exact combine, plus the shared MLP where the config has one."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, idx, aux = route(cfg, p["router"], xt)
    out = combine(expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xt, idx), gates).reshape(b, s, d)
    if "shared" in p:
        out = out + apply_mlp(cfg, p["shared"], x).reshape(b, s, d)
    return out, aux


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The reference's dispatch to the expert-parallel or the dense path: on
    one device, always the dense one."""
    return moe_dense(cfg, p, x)
