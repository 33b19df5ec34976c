"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

After `src/repro/models/rglru.py`: `init_rglru` (:32), `_gates` (:51),
`rglru_forward` (:61) in its modes and `init_rglru_cache` (:110). The
real-gated linear recurrent unit:

    r_t = sigmoid(W_r x_t)          (recurrence gate)
    i_t = sigmoid(W_i x_t)          (input gate)
    a_t = a ^ (c * r_t)             with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block: a temporal conv (`ssm.causal_conv`) then the RG-LRU on one branch,
a gelu gate (tanh form, `jax.nn.gelu`'s default) on the other, merged by
an output projection. The five projections (`linear_x`, `linear_y`,
`w_r`, `w_i`, `out`) are routed `linear`s; the gates, the conv and the
scan are plain PyTorch, as the reference computes them outside any kernel.

Prefill runs the recurrence as `associative_scan`, a copy of
`jax.lax.associative_scan`'s recursion over the same `combine`, so the tree
of products and sums is the reference's. Decode (one token a lane) and a
prefill chunk (C tokens, the carried h folded into the first element)
write the cache in place.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import dispatched as dsp
from repro_torch.models.layers import Params, gelu, normal
from repro_torch.models.ssm import causal_conv

_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype,
               stack: tuple[int, ...] = ()) -> Params:
    """The reference's tree: the fp32 `lam` drawn so a = sigmoid(lam) lies in
    [0.9, 0.999], the conv bank (width 4) and the five projections."""
    d, w = cfg.d_model, cfg.lru_width
    dev = gen.device
    u = 0.9 + (0.999 - 0.9) * torch.rand(stack + (w,), generator=gen, device=dev,
                                         dtype=torch.float32)
    return {
        "linear_x": normal(gen, stack + (d, w), dtype, d ** -0.5),
        "linear_y": normal(gen, stack + (d, w), dtype, d ** -0.5),
        "conv_w": normal(gen, stack + (4, w), dtype, 0.5),
        "conv_b": torch.zeros(stack + (w,), dtype=dtype, device=dev),
        "w_r": normal(gen, stack + (w, w), dtype, w ** -0.5),
        "w_i": normal(gen, stack + (w, w), dtype, w ** -0.5),
        "lam": torch.log(u) - torch.log1p(-u),
        "out": normal(gen, stack + (w, d), dtype, w ** -0.5),
    }


# ---------------------------------------------------------------------------
# jax.lax.associative_scan's recursion (jax/_src/lax/control_flow/loops.py)
# ---------------------------------------------------------------------------


def _slice(x: torch.Tensor, axis: int, start: int, stop: int | None,
           step: int = 1) -> torch.Tensor:
    index = [slice(None)] * x.ndim
    index[axis] = slice(start, stop, step)
    return x[tuple(index)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a0, b0, a1, b1, ... along `axis`; a holds as many elements as b or one
    more. Exact: the reference adds zero-padded copies, which changes no
    value."""
    n = a.shape[axis] + b.shape[axis]
    if b.shape[axis] < a.shape[axis]:
        pad = [0, 0] * (b.ndim - 1 - axis) + [0, 1]
        b = F.pad(b, pad)
    both = torch.stack([a, b], dim=axis + 1)
    return _slice(both.flatten(axis, axis + 1), axis, 0, n)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     axis: int = 0) -> list[torch.Tensor]:
    """`jax.lax.associative_scan(fn, elems, axis=axis)` for a tuple of
    tensors, by the same recursion: combine adjacent pairs, scan the half
    recursively (the odd outputs), combine those with the even inputs, and
    interleave. `fn(a, b)` takes and returns tuples like `elems`."""
    def combine(a, b):
        return list(fn(tuple(a), tuple(b)))

    def scan(xs: list[torch.Tensor]) -> list[torch.Tensor]:
        n = xs[0].shape[axis]
        if n < 2:
            return xs
        reduced = combine([_slice(x, axis, 0, n - 1, 2) for x in xs],
                          [_slice(x, axis, 1, None, 2) for x in xs])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([_slice(o, axis, 0, o.shape[axis] - 1) for o in odd],
                           [_slice(x, axis, 2, None, 2) for x in xs])
        else:
            even = combine(odd, [_slice(x, axis, 2, None, 2) for x in xs])
        even = [torch.cat([_slice(x, axis, 0, 1), r], dim=axis) for x, r in zip(xs, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return scan(list(elems))


def _combine(e1, e2):
    """h_t = a_t h_{t-1} + b_t as an associative pair."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


def _gates(p: Params, xi: torch.Tensor):
    r = torch.sigmoid(dsp.linear(xi, p["w_r"]).float())
    i = torch.sigmoid(dsp.linear(xi, p["w_i"]).float())
    log_a_base = F.logsigmoid(p["lam"])                  # log a, negative
    log_a = _C * r * log_a_base                          # (..., w)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * xi.float()


def rglru_forward(cfg: ModelConfig, p: Params, xin: torch.Tensor, *, mode: str,
                  cache: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """xin (B, S, D). train: the scan from h = 0, no cache. prefill: the
    same, returns the new cache;
    decode with S == 1: h = a h + b; decode with S > 1 (a prefill chunk):
    the scan resumed from the cache's h. Both decode forms write the cache
    in place and return it."""
    gate = gelu(dsp.linear(xin, p["linear_y"]))
    xi = dsp.linear(xin, p["linear_x"])
    s = xin.shape[1]
    if mode in ("train", "prefill"):
        xi, conv_state = causal_conv(xi, p["conv_w"], p["conv_b"])
        a, b = _gates(p, xi)                              # (B,S,w) each
        _, h = associative_scan(_combine, (a, b), axis=1)
        new_cache = {"h": h[:, -1].to(xin.dtype), "conv": conv_state} \
            if mode == "prefill" else None
    elif mode == "decode":
        if cache is None:
            raise ValueError("decode: the RG-LRU steps from a cache")
        xi, conv_state = causal_conv(xi, p["conv_w"], p["conv_b"], state=cache["conv"])
        a, b = _gates(p, xi)
        if s == 1:
            h = a[:, 0] * cache["h"].float() + b[:, 0]
            last = h
            h = h[:, None]
        else:
            # fold h_{-1} into the first scan element: h_0 = a_0 h_{-1} + b_0
            b = torch.cat([b[:, :1] + a[:, :1] * cache["h"].float()[:, None], b[:, 1:]], dim=1)
            _, h = associative_scan(_combine, (a, b), axis=1)
            last = h[:, -1]
        cache["h"].copy_(last.to(xin.dtype))
        cache["conv"].copy_(conv_state)
        new_cache = cache
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', 'decode')")
    out = dsp.linear(h.to(xin.dtype) * gate, p["out"])
    return out, new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device,
                     stack: tuple[int, ...] = ()) -> Params:
    """One layer's hidden state and conv tail (`stack` leading dims for a
    layer group): no time axis."""
    return {"h": torch.zeros(stack + (batch, cfg.lru_width), dtype=dtype, device=device),
            "conv": torch.zeros(stack + (batch, 3, cfg.lru_width), dtype=dtype,
                                device=device)}

