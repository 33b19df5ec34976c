"""Plain versions of the verify/accept kernels (reference `kernels/specdec/ref.py`).

Per-position first-index argmax over fp32 score rows (`torch.argmax`, whose
contract is the first index on ties), then the matched-prefix length against
the draft tokens: the sum of the cumulative product of matches. The CPU path
of the wrappers runs these, and `chip_smoke.py` holds the CUDA kernels
against them on the card.
"""

from __future__ import annotations

import torch


def verify_accept_tree_ref(scores: torch.Tensor, draft: torch.Tensor):
    """scores (B, NBR, T, V) fp32, draft (B, NBR, T-1) int32 ->
    (samples (B, T) i32, accept_len (B,) i32, branch (B,) i32): per-branch
    accept-prefix lengths, then the first branch attaining the max; the
    returned samples are that branch's per-position picks."""
    b, nbr, t, _ = scores.shape
    picks = torch.argmax(scores.float(), dim=-1).to(torch.int32)
    if t == 1:
        acc = torch.zeros((b, nbr), dtype=torch.int32, device=scores.device)
    else:
        matches = draft.to(torch.int32) == picks[:, :, :t - 1]
        acc = torch.cumprod(matches.to(torch.int32), dim=2).sum(dim=2).to(torch.int32)
    branch = torch.argmax(acc, dim=1).to(torch.int32)      # first index on ties
    samples = torch.take_along_dim(picks, branch.long()[:, None, None], dim=1)[:, 0]
    return samples, acc.max(dim=1).values, branch


def verify_accept_ref(scores: torch.Tensor, draft: torch.Tensor):
    """scores (B, T, V) fp32, draft (B, T-1) int32 ->
    (samples (B, T) int32, accept_len (B,) int32)."""
    b, t, _ = scores.shape
    samples = torch.argmax(scores.float(), dim=-1).to(torch.int32)
    if t == 1:
        return samples, torch.zeros((b,), dtype=torch.int32, device=scores.device)
    matches = draft.to(torch.int32) == samples[:, :t - 1]
    alive = torch.cumprod(matches.to(torch.int32), dim=1)
    return samples, alive.sum(dim=1).to(torch.int32)
