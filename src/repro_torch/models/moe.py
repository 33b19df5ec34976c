"""Mixture-of-experts on one device: the dense path.

After `src/repro/models/moe.py`: `init_moe` (:38), `_route` (:55-67), the
dispatched loop of `_expert_ffn` (:70-86), `moe_dense` (:100-129) and
`moe_forward` (:277-293), which takes the dense path here: every expert
runs on every token, and the combine keeps each token's top-k outputs by
their renormalised gates. Exact, no capacity drops. The expert-parallel
path (`moe_ep`) waits for the mesh.

Every expert matmul is a routed `linear`, one bank at a time (a packed
bank sliced with `DispatchedWeight.index`). The router runs outside any
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


def router_logits(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, d) fp32 @ (d, E) fp32 -> (T, E): the products summed over d by
    `row_sum`'s pairwise tree, so every row's bits are the same whatever T
    is."""
    return row_sum(x32[:, None, :] * w.T[None])[..., 0]   # (T, E, d) -> (T, E)


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


def expert_ffn(cfg: ModelConfig, wg, wu, wd, x: torch.Tensor) -> torch.Tensor:
    """x (T, d) through every expert bank, one bank at a time: (E, T, d).
    The reference broadcasts the tokens to (E, T, d) first; each expert
    reads the same rows."""
    act = gelu if cfg.act == "gelu" else F.silu
    outs = []
    for e in range(cfg.n_experts):
        g = act(dsp.linear(x, _bank(wg, e)))
        u = dsp.linear(x, _bank(wu, e))
        outs.append(dsp.linear((g * u).to(x.dtype), _bank(wd, e)))
    return torch.stack(outs)


def combine(ye: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The reference's `einsum("tke,etd,tk->td", one_hot(idx), ye, gates)`
    with the gates in ye's dtype: the one-hot picks each token's k expert
    outputs, summed in k order in fp32 and rounded once to ye's dtype."""
    t = torch.arange(ye.shape[1], device=ye.device)
    g = gates.to(ye.dtype).float()
    acc = g[:, 0, None] * ye[idx[:, 0], t].float()
    for j in range(1, idx.shape[1]):
        acc = acc + g[:, j, None] * ye[idx[:, j], t].float()
    return acc.to(ye.dtype)


def moe_dense(cfg: ModelConfig, p: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux): every expert on every token,
    the exact combine, plus the shared MLP where the config has one."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, idx, aux = route(cfg, p["router"], xt)
    ye = expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xt)             # (E, T, d)
    out = combine(ye, gates, idx).reshape(b, s, d)
    if "shared" in p:
        out = out + apply_mlp(cfg, p["shared"], x).reshape(b, s, d)
    return out, aux


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The reference's dispatch to the expert-parallel or the dense path: on
    one device, always the dense one."""
    return moe_dense(cfg, p, x)
