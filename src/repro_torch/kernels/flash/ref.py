"""Plain PyTorch version of flash attention (after
`src/repro/kernels/flash/ref.py`): materialized fp32 scores in the
(B, H, S, d) layout, GQA by repeating each kv head over its query group,
masked scores -1e30, one rounding of the output to the input dtype."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None, scale=None):
    b, h, sq, d = q.shape
    _, kvh, skv, _ = k.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    kq = k.float().repeat_interleave(g, dim=1)
    vq = v.float().repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    allow = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allow &= kpos <= qpos
    if window is not None:
        allow &= (qpos - kpos) < window
    s = s.masked_fill(~allow[None, None], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq).to(q.dtype)
