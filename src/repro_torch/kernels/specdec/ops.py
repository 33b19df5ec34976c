"""Public specdec surface: score rows and the routed verify/accept.

After `src/repro/kernels/specdec/ops.py`. `seeded_scores` turns target
logits into the rows the verify/accept kernels reduce: for greedy streams
the raw fp32 logits, so the first-index argmax is the host's greedy pick.
Seeded categorical scores (gumbel-perturbed by `jax.random`'s threefry
chain) wait for the port of that generator (ROADMAP A.2).

`verify_accept` / `verify_accept_tree` resolve through the dispatcher's
`specdec` / `specdec_tree` rows: on a CUDA tensor the hand-written kernel,
on a CPU tensor its plain version, with the route recorded.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.specdec.ref import verify_accept_ref, verify_accept_tree_ref
from repro_torch.kernels.specdec.specdec import (verify_accept_kernel,
                                                 verify_accept_tree_kernel)
from repro_torch.models.dispatched import route_and_run


def seeded_scores(logits: torch.Tensor, mode: str) -> torch.Tensor:
    """logits (B, T, V) -> score rows for `verify_accept` (greedy: fp32 logits)."""
    if mode == "greedy":
        return logits.to(torch.float32)
    if mode == "categorical":
        raise NotImplementedError(
            "categorical scores need jax.random's threefry fold_in and gumbel in "
            "torch (ROADMAP A.2)")
    raise ValueError(f"unknown sampling mode {mode!r}")


def verify_accept(scores: torch.Tensor, draft: torch.Tensor, *, dispatcher):
    """Routed verify/accept: (samples (B, T) i32, accept_len (B,) i32)."""
    return route_and_run(dispatcher, "specdec", scores,
                         lambda: verify_accept_kernel(scores, draft),
                         lambda: verify_accept_ref(scores, draft))


def verify_accept_tree(scores: torch.Tensor, draft: torch.Tensor, *, dispatcher):
    """Routed tree verify/accept: (samples (B, T), accept_len (B,), branch (B,))."""
    return route_and_run(dispatcher, "specdec_tree", scores,
                         lambda: verify_accept_tree_kernel(scores, draft),
                         lambda: verify_accept_tree_ref(scores, draft))
