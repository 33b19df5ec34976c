"""`jax.random`'s threefry2x32 chain in torch integer ops.

The port's own copy of the generator the reference samples with, so that a
seeded categorical stream of the port is the reference's, draw for draw.
After jax 0.9.0's `_src/prng.py` (`threefry_2x32` :1092 and its lowering's
20 rounds, `threefry_seed` :802, `threefry_fold_in` :1163,
`_threefry_random_bits_partitionable` :1184) and `_src/random.py`
(`_uniform` :435, `_gumbel` :1723 in mode "low", `categorical` :1739), under
the settings the reference runs with: `jax_threefry_partitionable` True (the
bits of element i come from the counter (i >> 32, i & 0xFFFFFFFF) alone, so
they do not depend on the row's length) and `jax_high_dynamic_range_gumbel`
False.

torch has few unsigned 32-bit operations, so every 32-bit word is carried
in an int64 tensor, masked with `& 0xFFFFFFFF` after each add and left
shift; right shifts of those non-negative values are logical. A key is an
int64 tensor whose last axis holds its two words. Every function is a
plain tensor function on the caller's device, with no host sync, so it can
be captured inside a CUDA graph. Float32 `log` differs by about an ulp
between builds (XLA's CPU, torch's CPU, CUDA's `logf`), so gumbel noise
matches jax's to ~1e-7 and draws from one device agree bit for bit only
with draws made by this same code on a device of the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of the counters (x0, x1) under the key (k1, k2),
    all int64 tensors of 32-bit words, broadcast together: five blocks of
    four rounds, a key injection after each."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for block in range(1, 6):
        for r in _ROTATIONS[(block - 1) % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[block % 3]) & MASK
        x1 = (x1 + ks[(block + 1) % 3] + block) & MASK
    return x0, x1


def seed_key(seed: int, device: str | torch.device | None = None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`'s key data: the words [seed >> 32, seed &
    0xFFFFFFFF] of a seed in [-2**31, 2**32) (a 32-bit seed, as jax takes it
    without x64: the high word is 0)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the hash of the counter (0, data),
    broadcast over the batch axes of `key` (..., 2) and `data` (an int or an
    integer tensor, taken modulo 2**32)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack((o0, o1), dim=-1)


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2) keys -> (..., n) int64 words: element i is bits1 ^ bits2 of
    the hash of the counter (i >> 32, i & 0xFFFFFFFF)."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], i >> 32, i & MASK)
    return b0 ^ b1


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """(..., 2) keys -> (..., n) float32 uniforms in [minval, maxval): the 23
    mantissa bits under the exponent of 1.0, minus 1, scaled, shifted, and
    floored at minval, every step in float32. Bit-equal to jax's where the
    scale maxval - minval is 1 in float32 ([0, 1) and gumbel's [tiny, 1));
    elsewhere XLA's CPU build may fuse the scale and shift into one fma."""
    bits = (random_bits32(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds as float32 values passed as Python scalars (exact in
    # float32, so no host-to-device copy, which a graph capture forbids)
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 2) keys -> (..., n) float32 Gumbel noise, mode "low":
    -log(-log(uniform(tiny, 1)))."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, row)` over the last axis: the first index
    of the largest gumbel(key) + row, one draw per row of `logits` (...,
    V) float32 under the matching key (..., 2)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def request_keys(root: torch.Tensor, rids, positions) -> torch.Tensor:
    """The sampler's key of the token at absolute position p of request r:
    fold_in(fold_in(root, r), p), broadcast over `rids` and `positions`
    (the rids' shape must broadcast against the positions' leading axes)."""
    rids = torch.as_tensor(rids, device=root.device)
    positions = torch.as_tensor(positions, device=root.device)
    by_rid = fold_in(root, rids)                                     # (..., 2)
    extra = positions.dim() - rids.dim()
    by_rid = by_rid.reshape(tuple(by_rid.shape[:-1]) + (1,) * extra + (2,))
    return fold_in(by_rid, positions)
