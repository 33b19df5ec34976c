"""specdec: the hand-written CUDA verify/accept kernels, chain and tree.

Replace the Pallas TPU kernels `verify_accept_kernel`
(`src/repro/kernels/specdec/specdec.py:147`) and `verify_accept_tree_kernel`
(:98); both live in `src/repro_torch/csrc/specdec.cu`, which also says what
bounds them on an H100. The target's pick at every position is a
first-index argmax over the score row's first `vocab` columns; the accept
length is the matched prefix of the draft; a window emits
`samples[:, :accept + 1]`. The tree form reduces over NBR sibling branches
per lane and keeps the first branch with the longest prefix.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version of `ref.py`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.specdec.ref import verify_accept_ref, verify_accept_tree_ref


def _operands(name: str, scores: torch.Tensor, draft: torch.Tensor, vocab: int | None):
    """fp32 scores and int32 draft on one device, and the vocab the argmax
    may pick from (1 <= vocab <= V)."""
    v = scores.shape[-1]
    vocab = v if vocab is None else int(vocab)
    if not 1 <= vocab <= v:
        raise ValueError(f"{name}: vocab {vocab} outside [1, {v}]")
    if scores.device != draft.device:
        raise ValueError(f"{name}: scores on {scores.device}, draft on {draft.device}")
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for tensors on {scores.device}")
    return (scores.to(torch.float32).contiguous(), draft.to(torch.int32).contiguous(),
            vocab)


def verify_accept_kernel(scores: torch.Tensor, draft: torch.Tensor, *,
                         vocab: int | None = None):
    """scores (B, T, V) fp32, draft (B, T-1) int32 -> (samples (B, T) int32,
    accept_len (B,) int32)."""
    b, t, v = scores.shape
    if tuple(draft.shape) != (b, t - 1):
        raise ValueError(f"draft {tuple(draft.shape)} does not pair with scores "
                         f"{tuple(scores.shape)}; want ({b}, {t - 1})")
    scores, draft, vocab = _operands("verify_accept_kernel", scores, draft, vocab)
    if scores.device.type == "cpu":
        return verify_accept_ref(scores[..., :vocab], draft)
    samples = torch.empty((b, t), dtype=torch.int32, device=scores.device)
    accept = torch.empty((b,), dtype=torch.int32, device=scores.device)
    if b == 0:
        return samples, accept
    with torch.cuda.device(scores.device):
        native.launch("specdec", scores.data_ptr(), draft.data_ptr(), samples.data_ptr(),
                      accept.data_ptr(), b, t, v, vocab,
                      torch.cuda.current_stream(scores.device).cuda_stream)
    return samples, accept


def verify_accept_tree_kernel(scores: torch.Tensor, draft: torch.Tensor, *,
                              vocab: int | None = None):
    """scores (B, NBR, T, V) fp32, draft (B, NBR, T-1) int32 ->
    (samples (B, T) int32, accept_len (B,) int32, branch (B,) int32)."""
    b, nbr, t, v = scores.shape
    if nbr < 1:
        raise ValueError(f"tree needs >= 1 branch, got {nbr}")
    if tuple(draft.shape) != (b, nbr, t - 1):
        raise ValueError(f"draft {tuple(draft.shape)} does not pair with scores "
                         f"{tuple(scores.shape)}; want ({b}, {nbr}, {t - 1})")
    scores, draft, vocab = _operands("verify_accept_tree_kernel", scores, draft, vocab)
    if scores.device.type == "cpu":
        return verify_accept_tree_ref(scores[..., :vocab], draft)
    samples = torch.empty((b, t), dtype=torch.int32, device=scores.device)
    accept = torch.empty((b,), dtype=torch.int32, device=scores.device)
    branch = torch.empty((b,), dtype=torch.int32, device=scores.device)
    if b == 0:
        return samples, accept, branch
    with torch.cuda.device(scores.device):
        native.launch("specdec_tree", scores.data_ptr(), draft.data_ptr(),
                      samples.data_ptr(), accept.data_ptr(), branch.data_ptr(),
                      b, nbr, t, v, vocab,
                      torch.cuda.current_stream(scores.device).cuda_stream)
    return samples, accept, branch
