"""avg_pool / max_pool: the hand-written CUDA NHWC window reductions.

Replace the Pallas TPU kernel `_pool` (`src/repro/kernels/conv/pool.py:44`,
entry points `avg_pool` :73 and `max_pool` :82); the kernels are
`src/repro_torch/csrc/pool.cu`, which also says what bounds them on an H100.
avg is count-include-pad (SAME pads count as zeros), max pads with -inf and
propagates NaN. `stride` defaults to the window, padding to VALID.

`pool_plan` maps the launch: a block stages the input patch of a tile of
output pixels of one image and a chunk of channels in shared memory, then
its threads fold each output's taps from there.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (`avg_pool_ref` / `max_pool_ref`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.conv.ref import avg_pool_ref, max_pool_ref, out_extent, pad_explicit

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_PLAIN = {"avg_pool": avg_pool_ref, "max_pool": max_pool_ref}

THREADS = 256               # a block (csrc/pool.cu kThreads)
CHUNK_BYTES = 128           # a block's channels: one 128-byte line of a pixel
SCALAR_CHUNK = 32           # ... or this many channels on the scalar path
TILE_W = 4                  # output columns a block, at most (a power of two)
SMEM_BYTES = 48 * 1024      # the staged patch, at most (no opt-in needed)
MAX_GRID_YZ = 65535


class PoolPlan(NamedTuple):
    vec: int                # elements a thread loads at once: 16 bytes' worth, or 1
    fold: int               # elements a thread folds: vec, or 4 bytes' worth
    chunk: int              # channels a block owns (a multiple of vec)
    tile_h: int             # output rows a block
    tile_w: int             # output columns a block (a power of two)
    row_tiles: int          # tiles down one image; grid x is batch * row_tiles
    col_tiles: int          # grid y
    n_chunks: int           # grid z
    patch_h: int            # staged input rows: (tile_h - 1) * sh + wh
    patch_w: int            # staged input columns: (tile_w - 1) * sw + ww

    @property
    def block(self) -> tuple[int, int]:
        """(lanes over the chunk's folds, rows over the tile's pixels)."""
        lanes = self.chunk // self.fold
        return lanes, THREADS // lanes


def pool_plan(shape, window, stride, padding: str, itemsize: int, aligned: bool) -> PoolPlan:
    """The pool kernel's launch for x of NHWC `shape`: 16-byte vectors when
    a pixel's channels are whole vectors (C * itemsize % 16 == 0) and both
    pointers are 16-byte `aligned`, else one channel at a time; a chunk of
    one 128-byte line of channels (SCALAR_CHUNK on the scalar path); tiles of
    up to TILE_W columns and about half a pixel a thread row, shrunk (rows,
    then columns, then the chunk) until the patch fits SMEM_BYTES. A block
    with fewer outputs than half its threads (a global pool) folds 4 bytes a
    thread, so that more threads share the taps."""
    b, h, w, c = shape
    (wh, ww), (sh, sw) = window, stride
    oh, ow = out_extent(h, wh, sh, padding), out_extent(w, ww, sw, padding)
    if max(h * w * c, oh * ow * c) >= 2 ** 31:
        raise ValueError(f"pool: an image of {(h, w, c)} is too large for 32-bit offsets")
    vec = 16 // itemsize if aligned and (c * itemsize) % 16 == 0 else 1
    chunk = min(c, CHUNK_BYTES // itemsize if vec > 1 else SCALAR_CHUNK)
    tile_w = min(TILE_W, 1 << (ow - 1).bit_length())
    tile_h = min(oh, max(1, THREADS // (chunk // vec) // 2 // tile_w))

    def patch_bytes():
        return ((tile_h - 1) * sh + wh) * ((tile_w - 1) * sw + ww) * chunk * itemsize

    while patch_bytes() > SMEM_BYTES:
        if tile_h > 1:
            tile_h = (tile_h + 1) // 2
        elif tile_w > 1:
            tile_w //= 2
        elif chunk > vec:
            chunk = max(vec, chunk // 2 // vec * vec)
        else:
            raise ValueError(f"pool: a {window} window's patch of {patch_bytes()} bytes "
                             f"exceeds the kernel's {SMEM_BYTES}")
    narrow = vec > 1 and tile_h * tile_w * (chunk // vec) < THREADS // 2
    plan = PoolPlan(vec, 4 // itemsize if narrow else vec, chunk, tile_h, tile_w,
                    -(-oh // tile_h), -(-ow // tile_w), -(-c // chunk),
                    (tile_h - 1) * sh + wh, (tile_w - 1) * sw + ww)
    if max(plan.col_tiles, plan.n_chunks) > MAX_GRID_YZ or b * plan.row_tiles >= 2 ** 31:
        raise ValueError(f"pool: {shape} needs a grid beyond the card's limits ({plan})")
    return plan


def _pool(x: torch.Tensor, window, stride, padding: str, kind: str) -> torch.Tensor:
    if x.ndim != 4:
        raise ValueError(f"{kind}: want x (B, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{kind}: x is {x.dtype}; want one of {DTYPES}")
    (wh, ww), (sh, sw) = window, stride
    if min(wh, ww, sh, sw) < 1:
        raise ValueError(f"{kind}: window {window} and stride {stride} must be >= 1")
    b, h, w, c = x.shape
    oh, ow = out_extent(h, wh, sh, padding), out_extent(w, ww, sw, padding)
    ph, pw = pad_explicit(h, wh, sh, padding), pad_explicit(w, ww, sw, padding)
    if x.device.type == "cpu":
        return _PLAIN[kind](x, window=window, stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"{kind}: no kernel for tensors on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{kind}: x must be contiguous (NHWC)")
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = pool_plan(x.shape, window, stride, padding, x.element_size(),
                     (x.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        native.launch(kind, x.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow, wh, ww, sh, sw,
                      ph[0], pw[0], plan.vec, plan.fold, plan.chunk, plan.tile_h,
                      plan.tile_w.bit_length() - 1, plan.row_tiles, plan.col_tiles,
                      plan.n_chunks, plan.patch_h, plan.patch_w,
                      float(np.float32(1.0 / (wh * ww))), native.dtype_code(x.dtype),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return out


def avg_pool(x: torch.Tensor, *, window: tuple[int, int],
             stride: tuple[int, int] | None = None, padding: str = "VALID") -> torch.Tensor:
    """NHWC average pooling (count-include-pad, like the engine)."""
    return _pool(x, window, stride or window, padding, "avg_pool")


def max_pool(x: torch.Tensor, *, window: tuple[int, int],
             stride: tuple[int, int] | None = None, padding: str = "VALID") -> torch.Tensor:
    """NHWC max pooling."""
    return _pool(x, window, stride or window, padding, "max_pool")
