"""decode_attention and paged_decode_attention: the hand-written CUDA
one-token GQA decode kernels.

Replace the Pallas TPU kernels `src/repro/kernels/flash/decode_attention.py:67`
(`decode_attention`) and :200 (`paged_decode_attention`); both launch one
body, `src/repro_torch/csrc/decode_attention.cuh` (which also says what
bounds it on an H100), built from `decode_attention.cu` and
`paged_decode_attention.cu`. q (B, H, d) attends a (B, S, KV, d) cache whose slot s holds
absolute position `positions[b, s]` (-1: empty); a slot is valid when
`0 <= pos <= current[b]` and, with a window, `current - pos < window`. The
paged form reads the same cache through (B, nb) block tables from a shared
(N, bs, KV, d) arena (`launch/kv_pool.py` fills it); a -1 entry is an
unmapped page, whose slots are masked.

On the card both split the cache length over blocks (`decode_plan`, a
function of the cache length and the chunk alone) and merge the splits'
partials in split order, in one launch.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version (`decode_attention_ref`, `paged_decode_attention_ref`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import native

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 32      # query heads per kv head the kernel stages at once
CHUNKS = (8, 16, 64)   # cache slots of a chunk (a page of the paged form)
DEFAULT_CHUNK = 64
SPLIT_SLOTS = 128      # cache slots a split reads, at the least (PERF.md §6)
MAX_SPLITS = 8         # the splits of a (lane, kv head) merge in one portable cluster


class DecodePlan(NamedTuple):
    n_split: int            # splits of the cache length; more than one merge in a cluster
    chunks_per_split: int   # whole chunks a split owns


def decode_plan(s: int, bk: int) -> DecodePlan:
    """The kernel's split of an s-slot cache read in bk-slot chunks. A
    function of (s, bk) alone, never of the batch, the heads or the card: a
    lane's bits must not change with how many lanes run beside it, and the
    paged form (s = nb·bs, bk = bs) takes the plan of `decode_attention(bk=bs)`
    on its gathered pages. Splits of whole chunks, SPLIT_SLOTS slots or more
    (more where MAX_SPLITS would not cover s), tile [0, s) in order; none is
    empty."""
    if bk not in CHUNKS:
        raise ValueError(f"decode_plan: chunk of {bk} slots; the kernel takes {CHUNKS}")
    if s < 1:
        raise ValueError(f"decode_plan: a cache needs >= 1 slot, got {s}")
    chunks = -(-s // bk)
    per = max(-(-SPLIT_SLOTS // bk), -(-chunks // MAX_SPLITS))
    return DecodePlan(-(-chunks // per), per)


def decode_attention_ref(q, k_cache, v_cache, positions, current, *,
                         window=None, scale=None):
    """Plain version (reference :121, mirroring models/attention's decode):
    fp32 scores over every cache slot, invalid slots -1e30, softmax, one
    rounding to q's dtype."""
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, kvh, g, d)
    sc = torch.einsum("bkgd,bckd->bkgc", qg.float(), k_cache.float()) * scale
    valid = (positions >= 0) & (positions <= current[:, None])
    if window is not None:
        valid &= (current[:, None] - positions) < window
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def _check_common(name, q, kvh, d, current, window) -> None:
    b, h, dq = q.shape
    if dq != d or h % kvh != 0:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match {kvh} kv heads "
                         f"of dim {d}")
    if current.shape != (b,):
        raise ValueError(f"{name}: current {tuple(current.shape)}; want ({b},)")
    if current.dtype != torch.int32:
        raise TypeError(f"{name}: current must be int32, got {current.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got {window}")


def _check_kernel_surface(name, q, kvh, d, chunk) -> None:
    """What the CUDA body takes: raise on anything else."""
    if d not in HEAD_DIMS or q.shape[1] // kvh > MAX_GROUP:
        raise ValueError(f"{name}: head dim {d} (want {HEAD_DIMS}), "
                         f"group {q.shape[1] // kvh} (want <= {MAX_GROUP})")
    if chunk not in CHUNKS:
        raise ValueError(f"{name}: chunk of {chunk} slots; the kernel takes {CHUNKS}")


def _check_rows_aligned(name, *tensors) -> None:
    """The kernel stages q and K/V rows with 16-byte copies: each tensor
    must start 16-byte aligned and its leading stride (a paged arena's
    block stride) must keep every row so; a view that does not is refused,
    never copied."""
    for t in tensors:
        if t.data_ptr() % 16 or (t.stride(0) * t.element_size()) % 16:
            raise ValueError(f"{name}: rows must start 16-byte aligned (data_ptr "
                             f"{t.data_ptr():#x}, strides {t.stride()}, {t.dtype})")


def _launch(name, q, args, plan: DecodePlan) -> None:
    """One launch with its plan, on q's device and current stream."""
    with torch.cuda.device(q.device):
        native.launch(name, *args, native.dtype_code(q.dtype), plan.n_split,
                      plan.chunks_per_split, torch.cuda.current_stream(q.device).cuda_stream)


def _device_of(name, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on {sorted(map(str, devices))}")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for tensors on {dev}")
    return dev


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, current: torch.Tensor, *,
                     window: int | None = None, bk: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """`bk` is the number of cache slots per online-softmax step (None: 64).
    The plain version ignores it, as the reference's oracle does."""
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: want q (B,H,d), caches (B,S,KV,d); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    if k_cache.shape[0] != b:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not match "
                         f"cache {tuple(k_cache.shape)}")
    _check_common("decode_attention", q, kvh, k_cache.shape[3], current, window)
    if positions.shape != (b, s):
        raise ValueError(f"decode_attention: positions {tuple(positions.shape)}; "
                         f"want ({b}, {s})")
    if positions.dtype != torch.int32:
        raise TypeError("decode_attention: positions and current must be int32")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}; want one of {DTYPES}")
    dev = _device_of("decode_attention", q, k_cache, v_cache, positions, current)
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, positions, current,
                                    window=window, scale=scale)
    chunk = DEFAULT_CHUNK if bk is None else bk
    _check_kernel_surface("decode_attention", q, kvh, d, chunk)
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, positions, current)):
        raise ValueError("decode_attention: operands must be contiguous")
    _check_rows_aligned("decode_attention", q, k_cache, v_cache)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    _launch("decode_attention", q,
            (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
             current.data_ptr(), out.data_ptr(), b, h, kvh, s, d,
             -1 if window is None else int(window), float(scale), chunk),
            decode_plan(s, chunk))
    return out


# ---------------------------------------------------------------------------
# Paged decode: the cache lives in a shared block arena, read through tables
# ---------------------------------------------------------------------------


def gather_pages(arena: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """The per-lane monolithic view of a block arena (reference :185):
    `arena` (N, bs, ...), `block_tables` (B, nb) with -1 for an unmapped page
    (read as row 0; callers mask it through the positions). Returns
    (B, nb·bs, ...)."""
    b, nb = block_tables.shape
    rows = torch.index_select(arena, 0, block_tables.clamp(min=0).reshape(-1).long())
    return rows.reshape((b, nb * arena.shape[1]) + tuple(arena.shape[2:]))


def gathered_positions(pos_arena: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(B, nb·bs) positions of the gathered pages; an unmapped page reads as
    empty slots (-1), as at reference :266-277."""
    bs = pos_arena.shape[1]
    mapped = (block_tables >= 0).repeat_interleave(bs, dim=1)
    return torch.where(mapped, gather_pages(pos_arena, block_tables),
                       torch.full_like(mapped, -1, dtype=pos_arena.dtype))


def paged_decode_attention_ref(q, k_arena, v_arena, pos_arena, block_tables, current, *,
                               window=None, scale=None):
    """Plain version (reference :290): gather the pages, then the plain
    decode."""
    return decode_attention_ref(q, gather_pages(k_arena, block_tables),
                                gather_pages(v_arena, block_tables),
                                gathered_positions(pos_arena, block_tables), current,
                                window=window, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
                           pos_arena: torch.Tensor, block_tables: torch.Tensor,
                           current: torch.Tensor, *, window: int | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """q (B, H, d); k/v arena (N, bs, KV, d) and pos arena (N, bs), each a
    view whose rows — (bs, KV, d) and (bs,) — are contiguous, so a layer's
    slice `arena[:, l]` of the pool's (N, stack, bs, ...) arena reads in
    place; block tables (B, nb) int32, -1 an unmapped page; current (B,)
    int32. The chunk is one page: on the card it equals
    `decode_attention(gather_pages(...), bk=bs)` bit for bit."""
    if q.ndim != 3 or k_arena.ndim != 4 or k_arena.shape != v_arena.shape:
        raise ValueError(f"paged_decode_attention: want q (B,H,d), arenas (N,bs,KV,d); "
                         f"got {tuple(q.shape)}, {tuple(k_arena.shape)}, "
                         f"{tuple(v_arena.shape)}")
    b, h, d = q.shape
    n, bs, kvh, _ = k_arena.shape
    _check_common("paged_decode_attention", q, kvh, k_arena.shape[3], current, window)
    if pos_arena.shape != (n, bs) or block_tables.ndim != 2 or block_tables.shape[0] != b:
        raise ValueError(f"paged_decode_attention: pos arena {tuple(pos_arena.shape)}, "
                         f"block tables {tuple(block_tables.shape)}; want ({n}, {bs}), "
                         f"({b}, nb)")
    if pos_arena.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise TypeError("paged_decode_attention: pos arena, block tables and current "
                        "must be int32")
    if not (q.dtype == k_arena.dtype == v_arena.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"paged_decode_attention: dtypes {q.dtype}, {k_arena.dtype}, "
                        f"{v_arena.dtype}; want one of {DTYPES}")
    dev = _device_of("paged_decode_attention", q, k_arena, v_arena, pos_arena,
                     block_tables, current)
    if dev.type == "cpu":
        return paged_decode_attention_ref(q, k_arena, v_arena, pos_arena, block_tables,
                                          current, window=window, scale=scale)
    _check_kernel_surface("paged_decode_attention", q, kvh, d, bs)
    row = (kvh * d, d, 1)
    if tuple(k_arena.stride()[1:]) != row or k_arena.stride() != v_arena.stride() or \
            pos_arena.stride(1) != 1:
        raise ValueError(f"paged_decode_attention: arena rows must be contiguous with "
                         f"one block stride (k {k_arena.stride()}, v {v_arena.stride()}, "
                         f"pos {pos_arena.stride()})")
    if not all(t.is_contiguous() for t in (q, block_tables, current)):
        raise ValueError("paged_decode_attention: q, block tables and current must be "
                         "contiguous")
    _check_rows_aligned("paged_decode_attention", q, k_arena, v_arena)
    scale = scale if scale is not None else d ** -0.5
    nb = block_tables.shape[1]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    _launch("paged_decode_attention", q,
            (q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), pos_arena.data_ptr(),
             block_tables.data_ptr(), current.data_ptr(), out.data_ptr(), b, h, kvh, bs, nb,
             d, k_arena.stride(0), pos_arena.stride(0),
             -1 if window is None else int(window), float(scale)),
            decode_plan(nb * bs, bs))
    return out
