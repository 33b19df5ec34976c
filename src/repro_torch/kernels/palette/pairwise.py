"""Float32 means in numpy's summation order, computed in torch.

The reference's Lloyd step takes each codebook entry as `sel.mean()` of a
float32 numpy array (`src/repro/kernels/palette/palette_matmul.py:46`). For
numpy 2 that mean is, bit for bit:

  * the array cut into consecutive pieces of `np.getbufsize()` = 8192
    elements (the reduction's buffer);
  * each piece's pairwise sum (numpy's `pairwise_sum`): fewer than 8
    elements, a sequential sum from zero; up to 128, eight accumulators over
    the first n - n%8 elements combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))
    and then the tail added in order; longer, the sums of the halves split at
    n//2 - (n//2)%8, added;
  * the piece sums added in order, in float32, to a zero, and one float32
    division by the count.

`grouped_means` computes that mean for consecutive groups of one tensor (the
members of each code, in flat order) with torch ops on the tensor's device:
every full piece reduces through the fixed tree of an 8192-element piece (64
leaves of 16 x 8, then 6 levels), the last, partial piece of each group
through its own tree, all groups together. Only the chain of piece sums runs
on the host, as numpy's own sequential float32 `add.accumulate`: it is a few
values a group, and strictly sequential.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PIECE = 8192     # numpy's reduction buffer (np.getbufsize())
LEAF = 128       # numpy's PW_BLOCKSIZE: the longest run summed without a split
LANES = 8        # numpy's accumulators inside a leaf


@functools.lru_cache(maxsize=None)
def _plan(n: int) -> tuple[np.ndarray, np.ndarray]:
    """numpy's pairwise sum of n values as a tree: its leaves (offset,
    length) in order, and its inner nodes (height, left, right), children
    before parents, over node ids that number the leaves first."""
    leaves, inner = [], []

    def visit(off: int, n: int) -> tuple[int, int]:
        if n <= LEAF:
            leaves.append((off, n))
            return -len(leaves), 0          # leaf j as -(j + 1)
        n2 = n // 2
        n2 -= n2 % LANES
        a, ha = visit(off, n2)
        b, hb = visit(off + n2, n - n2)
        inner.append((max(ha, hb) + 1, a, b))
        return len(inner) - 1, max(ha, hb) + 1

    visit(0, n)
    node = lambda x: -x - 1 if x < 0 else len(leaves) + x     # noqa: E731
    return (np.array(leaves, np.int64).reshape(-1, 2),
            np.array([(h, node(a), node(b)) for h, a, b in inner], np.int64).reshape(-1, 3))


def _combine(r: torch.Tensor) -> torch.Tensor:
    """A leaf's eight accumulators (last dim), combined in numpy's order."""
    return ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
           ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))


def _leaf_sums(vals: torch.Tensor, start: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """The sum of each leaf vals[start:start+length] (length <= LEAF)."""
    last = vals.numel() - 1
    lane = torch.arange(LANES, device=vals.device)
    rounds, tail = length // LANES, length % LANES

    def at(i: torch.Tensor) -> torch.Tensor:
        return vals[i.clamp(max=last)]

    r = torch.where((rounds >= 1)[:, None], at(start[:, None] + lane), 0.0)
    for t in range(1, LEAF // LANES):
        r = torch.where((t < rounds)[:, None], r + at(start[:, None] + LANES * t + lane), r)
    s = _combine(r)      # a leaf under 8 values: +0 here, then its values in order
    base = start + LANES * rounds
    for e in range(LANES - 1):
        s = torch.where(e < tail, s + at(base + e), s)
    return s


def _piece_sums(x: torch.Tensor) -> torch.Tensor:
    """The pairwise sum of each row of x (P, PIECE)."""
    r = x.view(x.shape[0], PIECE // LEAF, LEAF // LANES, LANES)
    acc = r[:, :, 0]
    for t in range(1, LEAF // LANES):
        acc = acc + r[:, :, t]
    s = _combine(acc)                    # (P, 64) leaves
    while s.shape[1] > 1:                # 6 levels: halves of halves
        s = s[:, 0::2] + s[:, 1::2]
    return s[:, 0]


def _segment_sums(vals: torch.Tensor, starts: list[int], lengths: list[int]) -> torch.Tensor:
    """The pairwise sum of each segment vals[s:s+n], any n >= 1: every
    segment's leaves at once, then its inner nodes level by level."""
    plans = [_plan(n) for n in lengths]
    n_leaf = np.array([len(p[0]) for p in plans])
    n_inner = np.array([len(p[1]) for p in plans])
    leaf_base = np.cumsum(n_leaf) - n_leaf
    inner_base = np.cumsum(n_inner) - n_inner
    total_leaves = int(n_leaf.sum())
    inner = np.concatenate([p[1] for p in plans])
    # inner nodes sorted by height follow the leaves: a level is one slice
    order = np.argsort(inner[:, 0], kind="stable")
    slot = np.empty(len(inner), np.int64)
    slot[order] = total_leaves + np.arange(len(inner))
    own_leaves, own_leaf_base, own_inner_base = (np.repeat(x, n_inner)
                                                 for x in (n_leaf, leaf_base, inner_base))

    def global_id(x: np.ndarray) -> np.ndarray:
        is_leaf = x < own_leaves
        j = np.where(is_leaf, 0, own_inner_base + x - own_leaves)
        return np.where(is_leaf, own_leaf_base + x, slot[j] if len(slot) else 0)

    left, right = global_id(inner[:, 1])[order], global_id(inner[:, 2])[order]
    height = inner[order, 0]
    root = np.where(n_inner > 0, slot[np.maximum(inner_base + n_inner - 1, 0)]
                    if len(slot) else 0, leaf_base)
    dev = vals.device
    nodes = torch.empty(total_leaves + len(inner), dtype=vals.dtype, device=dev)
    leaf_start = np.concatenate([s + p[0][:, 0] for s, p in zip(starts, plans)])
    leaf_len = np.concatenate([p[0][:, 1] for p in plans])
    nodes[:total_leaves] = _leaf_sums(vals, torch.from_numpy(leaf_start).to(dev),
                                      torch.from_numpy(leaf_len).to(dev))
    left, right = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    lo = 0
    for cnt in np.unique(height, return_counts=True)[1]:
        hi = lo + int(cnt)
        nodes[total_leaves + lo:total_leaves + hi] = nodes[left[lo:hi]] + nodes[right[lo:hi]]
        lo = hi
    return nodes[torch.from_numpy(root).to(dev)]


def grouped_means(vals: torch.Tensor, counts: list[int]) -> np.ndarray:
    """The float32 mean, in numpy's order, of each of the consecutive groups
    of the 1-D float32 `vals` (group g: the next counts[g] values); NaN for
    an empty group. Returns a float32 numpy array."""
    counts = [int(c) for c in counts]
    if vals.dtype != torch.float32 or vals.ndim != 1 or sum(counts) != vals.numel():
        raise ValueError(f"grouped_means: want 1-D float32 values in groups of {counts}, "
                         f"got {vals.dtype} {tuple(vals.shape)}")
    offsets = np.cumsum(counts) - counts
    full = [vals[o:o + c // PIECE * PIECE].view(-1, PIECE)
            for o, c in zip(offsets, counts) if c >= PIECE]
    part = [(int(o) + c // PIECE * PIECE, c % PIECE)
            for o, c in zip(offsets, counts) if c % PIECE]
    sums = ([_piece_sums(torch.cat(full))] if full else []) + \
        ([_segment_sums(vals, *map(list, zip(*part)))] if part else [])
    sums = torch.cat(sums).cpu().numpy() if sums else np.zeros(0, np.float32)
    full_sums, part_sums = sums[:len(sums) - len(part)], sums[len(sums) - len(part):]
    # row g: a zero, its full pieces' sums, its partial piece's, zeros after
    chain = np.zeros((len(counts), max(counts, default=0) // PIECE + 2), np.float32)
    i = j = 0
    for g, c in enumerate(counts):
        p = c // PIECE
        chain[g, 1:1 + p] = full_sums[i:i + p]
        i += p
        if c % PIECE:
            chain[g, 1 + p] = part_sums[j]
            j += 1
    total = np.add.accumulate(chain, axis=1)[:, -1]
    with np.errstate(invalid="ignore"):
        return total / np.array(counts, np.float32)
