"""Public specdec surface: seeded score rows and the routed verify/accept.

After `src/repro/kernels/specdec/ops.py`. `seeded_scores` turns target
logits into the rows the verify/accept kernels reduce: for greedy streams
the raw fp32 logits, so the first-index argmax is the host's greedy pick;
for seeded categorical streams the logits plus the gumbel noise of
`jax.random.categorical` (`categorical(key, row)` is `argmax(gumbel(key) +
row)`) under the per-(rid, position) key fold_in(fold_in(root, rid), pos)
the port's `TokenSampler` draws with (`core.prng`, jax's threefry in
torch). A first-index argmax over the perturbed row is then the sampler's
draw at that (request, position), computed by the same code on the same
device.

`verify_accept` / `verify_accept_tree` resolve through the dispatcher's
`specdec` / `specdec_tree` rows: on a CUDA tensor the hand-written kernel,
on a CPU tensor its plain version, with the route recorded.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.specdec.ref import verify_accept_ref, verify_accept_tree_ref
from repro_torch.kernels.specdec.specdec import (verify_accept_kernel,
                                                 verify_accept_tree_kernel)
from repro_torch.models.dispatched import route_and_run


def seeded_scores(logits: torch.Tensor, root: torch.Tensor, rids: torch.Tensor,
                  positions: torch.Tensor, mode: str) -> torch.Tensor:
    """logits (B, T, V) -> score rows for `verify_accept`: greedy, the fp32
    logits; categorical, each row plus the gumbel noise of its key
    fold_in(fold_in(root, rids[b]), positions[b, t]) over the row's width V,
    so argmax(scores[b, t]) is `jax.random.categorical(key, logits[b, t])`."""
    lg = logits.to(torch.float32)
    if mode == "greedy":
        return lg
    if mode != "categorical":
        raise ValueError(f"unknown sampling mode {mode!r}")
    keys = prng.request_keys(root, rids, positions)             # (B, T, 2)
    return lg + prng.gumbel(keys, lg.shape[-1])


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
