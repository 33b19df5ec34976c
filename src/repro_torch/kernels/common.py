"""Shared by the matmul kernel wrappers: the packed kernels' operand checks
and forward-only gate, and the plan of the streaming tile loop
(`csrc/tile_matmul.cuh`, namespace `tile::stream`) that every 16-bit
product runs: bf16 / fp16 `anemm` and `conv2d`, bf16 `sparse` and
`palette`.

The plan has two halves. `chunk_plan` fixes the sum order: K cut into at
most `MAX_CHUNKS` chunks, each a multiple of `STREAM_BK`; a chunk's partial
starts from zero and the partials are added in chunk order. It reads
(K, N, dtype) and never M, so a row's bits do not change with the number of
rows beside it (8-row decode against a 16- to 80-row verify window, a
prefix hit's short prefill against a cold one). `launch_plan` decides who
computes what, which may read M: the activation rows a block owns, and
whether a tile's chunks go to the blocks of one cluster (`split`, few tiles:
decode) or one block walks them all (many tiles: prefill).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

STREAM_BK = 64                  # K a ring stage holds; a chunk is a multiple
STREAM_BN = 64                  # weight columns a block owns
STREAM_ROWS = (8, 16, 32, 64)   # activation rows a block may own (the kernel's BM)
MAX_CHUNKS = 8                  # chunks a plan may have: a portable cluster
SPLIT_TILES = 132               # fewer output tiles than SMs: chunks go to a cluster


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """Raise where a gradient is asked of `tensors`: packed weights, the
    pools and an unfused `act_lut` have no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{what} is forward-only: no gradient flows through it "
                         "(the reference trains dense weights only)")


class ChunkPlan(NamedTuple):
    kc: int       # K a chunk covers (the last may be shorter)
    chunks: int   # ceil(K / kc)


class LaunchPlan(NamedTuple):
    bm: int       # activation rows a block owns
    split: int    # blocks a tile's chunks go to: 1, or every chunk its own block


@functools.lru_cache(maxsize=1024)       # called on every launch: a lookup, not a plan
def chunk_plan(k: int, n: int, dtype: torch.dtype) -> ChunkPlan:
    """The sum order of a (M, k) x (k, n) product in `dtype`, for any M.
    bf16 / fp16: the fewest K steps a chunk that keep the chunks within
    MAX_CHUNKS (N does not change the order). fp32 runs the blocked loop, one
    fmaf chain over all of K in order: one chunk."""
    if dtype == torch.float32:
        return ChunkPlan(k, 1)
    steps = max(1, -(-k // STREAM_BK))
    per = -(-steps // MAX_CHUNKS)
    return ChunkPlan(per * STREAM_BK, -(-steps // per))


@functools.lru_cache(maxsize=1024)
def launch_plan(m: int, n: int, plan: ChunkPlan) -> LaunchPlan:
    """Who computes which piece of an (m, n) output: the fewest rows a block
    that hold m (at most 64), and the chunks spread over a cluster when the
    output has fewer than SPLIT_TILES tiles. Every choice sums the same
    chunks in the same order."""
    bm = next((b for b in STREAM_ROWS if m <= b), STREAM_ROWS[-1])
    tiles = -(-n // STREAM_BN) * -(-m // bm)
    return LaunchPlan(bm, plan.chunks if tiles < SPLIT_TILES else 1)


def check_operands(name: str, a: torch.Tensor, dtypes: tuple,
                   weights: dict[str, tuple]) -> None:
    """The packed kernels' operand contract: `a` (M, K) is in `dtypes`; each
    weight array is `weights[name] = (tensor, shape, allowed dtypes)`; all
    contiguous and on `a`'s device. Raises on anything else."""
    if a.dtype not in dtypes:
        raise TypeError(f"{name}: a is {a.dtype}; want one of {dtypes}")
    for what, (t, shape, allowed) in weights.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} must have shape {shape} for a "
                             f"{tuple(a.shape)}, got {tuple(t.shape)}")
        if t.dtype not in allowed:
            raise TypeError(f"{name}: {what} is {t.dtype}; want one of {allowed}")
        if t.device != a.device:
            raise ValueError(f"{name}: {what} on {t.device}, a on {a.device}")
    if not all(t.is_contiguous() for t in [a] + [w[0] for w in weights.values()]):
        raise ValueError(f"{name}: operands must be contiguous row-major")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for tensors on {a.device}")
