"""Kernel registry of the port: each ported kernel with its plain version.

After `src/repro/kernels/registry.py`. Each row mirrors the reference's
`KernelSpec`: the same name, the same shape classes (names, dims and `edge`
flags), the same dtypes and the same tolerance function, so a test can hold
one registry against the other. One extension: `decode_attention` and
`paged_decode_attention` add float16 after the reference's dtypes (the
reference serves an fp16 decode through its plain jnp version; the port
has no plain route on the card). A row also names its CUDA source and the
Pallas kernel it replaces, and counts the work its inputs need (operations
and bytes), from which `chip_smoke.py` computes each kernel's bound.

Rows: `anemm` (reference :149), `palette` (:183), `sparse` (:221), `flash`
(:287), `decode_attention` (:332), `paged_decode_attention` (:398),
`act_lut` (:447), `specdec` (:500), `specdec_tree` (:561), `conv2d` (:626),
`avg_pool` (:699) and `max_pool` (:721): every Pallas kernel of the
reference. `anemm`, `flash` and `conv2d` carry the reference's VJP rows
(`_anemm_vjp` :140, `_flash_vjp` :276, `_conv2d_vjp` :614): the gradient
through the kernel's autograd wrapper against autograd through the plain
math, in the inputs' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Spec types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    """One named shape class of a kernel's sweep; `edge=True` marks
    padding/alignment stress cases (ragged extents, tiny dims)."""

    name: str
    dims: tuple[int, ...]
    edge: bool = False


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel's row: its entry points, sweep, tolerance and work."""

    name: str
    dtypes: tuple[torch.dtype, ...]
    cases: tuple[ShapeCase, ...]
    # (case, dtype, numpy Generator, device) -> input bundle
    make_inputs: Callable[[ShapeCase, torch.dtype, np.random.Generator, Any], dict]
    run_kernel: Callable[[dict], torch.Tensor]
    run_oracle: Callable[[dict], torch.Tensor]   # the plain PyTorch version
    tol: Callable[[torch.dtype], tuple[float, float]]   # dtype -> (rtol, atol)
    work: Callable[[dict], tuple[float, float]]   # inputs -> (operations, bytes)
    source: str                                   # the CUDA source in this repo
    replaces: str                                 # file:line of the TPU kernel
    # inputs -> (scalar function through the kernel's differentiable
    # wrapper, the same through the plain version, the tensors to
    # differentiate, each requiring grad): the VJP leg (reference :72).
    # None: forward-only
    make_vjp: Callable[[dict], tuple[Callable, Callable, tuple]] | None = None


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} registered twice")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_specs() -> list[KernelSpec]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _normal(rng: np.random.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=shape)).to(device=device, dtype=dtype)


def _mm_tol(dtype) -> tuple[float, float]:
    # fp32 tolerance covers blocked-K accumulation-order differences; narrow
    # dtypes add one rounding at the store (reference :120)
    return (1e-3, 1e-3) if dtype == torch.float32 else (2.5e-2, 2.5e-2)


def _flash_tol(dtype) -> tuple[float, float]:
    return (2e-3, 2e-3) if dtype == torch.float32 else (3e-2, 3e-2)   # reference :272


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


# ---------------------------------------------------------------------------
# anemm — blocked matmul with the ANE-mode epilogue
# ---------------------------------------------------------------------------


def _anemm_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    m, k, n = case.dims
    return {"a": _normal(rng, (m, k), dtype, device),
            "b": _normal(rng, (k, n), dtype, device)}


def _anemm_work(i: dict) -> tuple[float, float]:
    (m, k), n = i["a"].shape, i["b"].shape[1]
    out_bytes = m * n * i["a"].element_size()
    return 2.0 * m * k * n, _nbytes(i["a"], i["b"]) + out_bytes


def _grad_leaves(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return tuple(t.detach().clone().requires_grad_(True) for t in tensors)


def _anemm_vjp(inputs: dict):
    from repro_torch.kernels.anemm import ops as anemm_ops

    return (lambda a, b: anemm_ops.matmul(a, b).sum(),
            lambda a, b: (a @ b).sum(), _grad_leaves(inputs["a"], inputs["b"]))


def _register_anemm() -> None:
    from repro_torch.kernels.anemm.anemm import anemm
    from repro_torch.kernels.anemm.ref import anemm_ref

    register(KernelSpec(
        name="anemm",
        dtypes=(torch.float32, torch.bfloat16, torch.float16),
        cases=(
            ShapeCase("aligned", (128, 512, 128)),
            ShapeCase("tall", (256, 256, 64)),
            ShapeCase("ragged", (200, 300, 100), edge=True),
            ShapeCase("tiny", (8, 32, 8), edge=True),
            ShapeCase("vector", (1, 384, 16), edge=True),
            ShapeCase("off_block", (129, 257, 130), edge=True),
        ),
        make_inputs=_anemm_inputs,
        run_kernel=lambda i: anemm(i["a"], i["b"]),
        run_oracle=lambda i: anemm_ref(i["a"], i["b"]),
        tol=_mm_tol,
        work=_anemm_work,
        source="src/repro_torch/csrc/anemm.cu",
        replaces="src/repro/kernels/anemm/anemm.py:69",
        make_vjp=_anemm_vjp,
    ))


# ---------------------------------------------------------------------------
# palette / sparse — packed weights decoded at the matrix unit's input
# ---------------------------------------------------------------------------


def _packed_work(i: dict) -> tuple[float, float]:
    """2·M·K·N operations; bytes of the real tensors: the activation, the
    packed payload (nibbles + codebook, or values + selector) and the output."""
    a, payload = i["a"], [t for key, t in i.items() if key != "a"]
    (m, k), n = a.shape, payload[0].shape[1]
    return 2.0 * m * k * n, _nbytes(a, *payload) + m * n * a.element_size()


def _palette_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    from repro_torch.kernels.palette.palette_matmul import pack_kn

    m, k, n = case.dims
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(device)
    packed, lut = pack_kn(w, iters=4)
    return {"a": _normal(rng, (m, k), dtype, device), "packed": packed, "lut": lut}


def _register_palette() -> None:
    from repro_torch.kernels.palette.palette_matmul import palette_matmul
    from repro_torch.kernels.palette.ref import palette_matmul_ref

    register(KernelSpec(
        name="palette",
        dtypes=(torch.float32, torch.bfloat16),
        cases=(
            ShapeCase("aligned", (64, 256, 192)),
            ShapeCase("wide", (128, 512, 256)),
            ShapeCase("ragged", (32, 130, 72), edge=True),
            ShapeCase("tiny", (4, 32, 16), edge=True),
        ),
        make_inputs=_palette_inputs,
        run_kernel=lambda i: palette_matmul(i["a"], i["packed"], i["lut"]),
        run_oracle=lambda i: palette_matmul_ref(i["a"], i["packed"], i["lut"]),
        tol=_mm_tol,
        work=_packed_work,
        source="src/repro_torch/csrc/palette_matmul.cu",
        replaces="src/repro/kernels/palette/palette_matmul.py:88",
    ))


def _sparse_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    from repro_torch.kernels.sparse.sparse_matmul import pack_pair_sparse

    m, k, n = case.dims
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(device)
    values, selector = pack_pair_sparse(w)
    return {"a": _normal(rng, (m, k), dtype, device), "values": values,
            "selector": selector}


def _register_sparse() -> None:
    from repro_torch.kernels.sparse.ref import sparse_matmul_ref
    from repro_torch.kernels.sparse.sparse_matmul import sparse_matmul

    register(KernelSpec(
        name="sparse",
        dtypes=(torch.float32, torch.bfloat16),
        cases=(
            # K must be a multiple of 16 (selector bits pack 8 pairs a byte)
            ShapeCase("aligned", (64, 256, 192)),
            ShapeCase("wide", (96, 512, 128)),
            ShapeCase("ragged", (48, 144, 72), edge=True),
            ShapeCase("tiny", (8, 32, 16), edge=True),
        ),
        make_inputs=_sparse_inputs,
        run_kernel=lambda i: sparse_matmul(i["a"], i["values"], i["selector"]),
        run_oracle=lambda i: sparse_matmul_ref(i["a"], i["values"], i["selector"]),
        tol=_mm_tol,
        work=_packed_work,
        source="src/repro_torch/csrc/sparse_matmul.cu",
        replaces="src/repro/kernels/sparse/sparse_matmul.py:85",
    ))


# ---------------------------------------------------------------------------
# flash — fused attention, online softmax
# ---------------------------------------------------------------------------


def _flash_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    b, h, kvh, sq, skv, d = case.dims
    return {"q": _normal(rng, (b, h, sq, d), dtype, device),
            "k": _normal(rng, (b, kvh, skv, d), dtype, device),
            "v": _normal(rng, (b, kvh, skv, d), dtype, device)}


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal mask allows: query i sees keys 0..i."""
    q = np.arange(sq)
    return int(np.minimum(q + 1, skv).sum())


def _flash_work(i: dict) -> tuple[float, float]:
    b, h, sq, d = i["q"].shape
    skv = i["k"].shape[2]
    ops = 4.0 * b * h * d * causal_pairs(sq, skv)
    return ops, 2.0 * _nbytes(i["q"]) + _nbytes(i["k"], i["v"])   # q in, out


def _flash_vjp(inputs: dict):
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import flash_attention_ref

    return (lambda q, k, v: flash_ops.attention(q, k, v).sum(),
            lambda q, k, v: flash_attention_ref(q, k, v).sum(),
            _grad_leaves(inputs["q"], inputs["k"], inputs["v"]))


def _register_flash() -> None:
    from repro_torch.kernels.flash.flash_attention import flash_attention
    from repro_torch.kernels.flash.ref import flash_attention_ref

    register(KernelSpec(
        name="flash",
        dtypes=(torch.float32, torch.bfloat16, torch.float16),
        cases=(
            # dims = (B, H, KVH, Sq, Skv, d)
            ShapeCase("gqa", (2, 4, 2, 128, 128, 64)),
            ShapeCase("mha", (1, 4, 4, 128, 128, 32)),
            ShapeCase("ragged", (1, 2, 2, 100, 100, 32), edge=True),
            ShapeCase("odd_len", (1, 2, 1, 77, 77, 16), edge=True),
        ),
        make_inputs=_flash_inputs,
        run_kernel=lambda i: flash_attention(i["q"], i["k"], i["v"], causal=True),
        run_oracle=lambda i: flash_attention_ref(i["q"], i["k"], i["v"], causal=True),
        tol=_flash_tol,
        work=_flash_work,
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash/flash_attention.py:93",
        make_vjp=_flash_vjp,
    ))


# ---------------------------------------------------------------------------
# decode_attention — one-token GQA decode against a long cache
# ---------------------------------------------------------------------------


def _decode_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    b, h, kvh, s, d, length = case.dims
    pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)
    return {"q": _normal(rng, (b, h, d), dtype, device),
            "k_cache": _normal(rng, (b, s, kvh, d), dtype, device),
            "v_cache": _normal(rng, (b, s, kvh, d), dtype, device),
            "positions": torch.where(pos < length, pos, -1).contiguous(),
            "current": torch.full((b,), length - 1, dtype=torch.int32, device=device)}


def _decode_work(i: dict) -> tuple[float, float]:
    """Counts the slots this run's positions make valid: an invalid slot's
    K/V row need not be read at all."""
    b, h, d = i["q"].shape
    kvh = i["k_cache"].shape[2]
    pos, cur = i["positions"], i["current"]
    n_valid = int(((pos >= 0) & (pos <= cur[:, None])).sum())
    row_bytes = kvh * d * i["k_cache"].element_size()
    return (4.0 * h * d * n_valid,
            2.0 * _nbytes(i["q"]) + _nbytes(pos, cur) + 2.0 * n_valid * row_bytes)


def _register_decode() -> None:
    from repro_torch.kernels.flash.decode_attention import (decode_attention,
                                                            decode_attention_ref)

    register(KernelSpec(
        name="decode_attention",
        # float16 extends the reference's surface: its dispatcher sends an
        # fp16 decode to the plain jnp version (reference core/dispatch.py
        # :456), and the port has no plain route on the card
        dtypes=(torch.float32, torch.bfloat16, torch.float16),
        cases=(
            # dims = (B, H, KVH, S, d, written_length)
            ShapeCase("gqa", (2, 8, 2, 256, 64, 200)),
            ShapeCase("mha", (1, 4, 4, 128, 32, 100)),
            ShapeCase("ragged", (3, 4, 2, 96, 64, 50), edge=True),
            ShapeCase("short_cache", (2, 4, 1, 24, 16, 9), edge=True),
        ),
        make_inputs=_decode_inputs,
        run_kernel=lambda i: decode_attention(
            i["q"], i["k_cache"], i["v_cache"], i["positions"], i["current"]),
        run_oracle=lambda i: decode_attention_ref(
            i["q"], i["k_cache"], i["v_cache"], i["positions"], i["current"]),
        tol=_flash_tol,
        work=_decode_work,
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/flash/decode_attention.py:67",
    ))


# ---------------------------------------------------------------------------
# paged_decode_attention — decode against a block arena through a page table
# ---------------------------------------------------------------------------


def _paged_decode_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    """The reference's draws (:376), in its order: per-lane written lengths
    shrinking from the full prefix (ragged tables, partial last pages; the
    empty_lane case's last lane has none), pages on scattered arena rows
    from `rng.permutation`, then q and the K/V arenas."""
    b, h, kvh, n, bs, nb, d, length = case.dims
    lens = [max(0, length - i * (length // max(b, 1))) for i in range(b)]
    if case.name == "empty_lane":
        lens[-1] = 0
    pos_arena = np.full((n, bs), -1, np.int32)
    tables = np.full((b, nb), -1, np.int32)
    perm = rng.permutation(n)
    nxt = 0
    for i in range(b):
        for j in range(-(-lens[i] // bs)):
            row = int(perm[nxt])
            nxt += 1
            tables[i, j] = row
            pp = j * bs + np.arange(bs)
            pos_arena[row] = np.where(pp < lens[i], pp, -1)
    return {"q": _normal(rng, (b, h, d), dtype, device),
            "k_arena": _normal(rng, (n, bs, kvh, d), dtype, device),
            "v_arena": _normal(rng, (n, bs, kvh, d), dtype, device),
            "pos_arena": torch.from_numpy(pos_arena).to(device),
            "block_tables": torch.from_numpy(tables).to(device),
            "current": torch.from_numpy(
                np.maximum(np.asarray(lens) - 1, 0).astype(np.int32)).to(device)}


def _paged_decode_work(i: dict) -> tuple[float, float]:
    """The reference's cost (:422: 4·H·d operations per slot, K and V rows
    and the int32 table read once), over the slots this run's tables map to
    a valid position rather than every page of every lane; q read and the
    output written once, the positions of the mapped pages read once."""
    from repro_torch.kernels.flash.decode_attention import gathered_positions

    b, h, d = i["q"].shape
    kvh = i["k_arena"].shape[2]
    tables, cur = i["block_tables"], i["current"]
    pos = gathered_positions(i["pos_arena"], tables)
    n_valid = int(((pos >= 0) & (pos <= cur[:, None])).sum())
    n_mapped = int((tables >= 0).sum())
    row_bytes = kvh * d * i["k_arena"].element_size()
    return (4.0 * h * d * n_valid,
            2.0 * _nbytes(i["q"]) + _nbytes(tables, cur) + 2.0 * n_valid * row_bytes
            + 4.0 * n_mapped * i["pos_arena"].shape[1])


def _register_paged_decode() -> None:
    from repro_torch.kernels.flash.decode_attention import (paged_decode_attention,
                                                            paged_decode_attention_ref)

    names = ("q", "k_arena", "v_arena", "pos_arena", "block_tables", "current")
    register(KernelSpec(
        name="paged_decode_attention",
        dtypes=(torch.float32, torch.bfloat16, torch.float16),   # fp16: as decode_attention
        cases=(
            # dims = (B, H, KVH, N arena blocks, bs, nb pages/lane, d, length)
            ShapeCase("gqa", (2, 8, 2, 16, 8, 6, 64, 41)),
            ShapeCase("mha", (1, 4, 4, 8, 16, 4, 32, 64)),
            ShapeCase("ragged_pages", (3, 4, 2, 24, 8, 5, 64, 27), edge=True),
            ShapeCase("empty_lane", (2, 4, 1, 12, 8, 4, 16, 9), edge=True),
        ),
        make_inputs=_paged_decode_inputs,
        run_kernel=lambda i: paged_decode_attention(*(i[k] for k in names)),
        run_oracle=lambda i: paged_decode_attention_ref(*(i[k] for k in names)),
        tol=_flash_tol,
        work=_paged_decode_work,
        source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/flash/decode_attention.py:200",
    ))


# ---------------------------------------------------------------------------
# specdec / specdec_tree — fused speculative-decoding verify/accept
# ---------------------------------------------------------------------------


def _force_prefix(draft: np.ndarray, picks: np.ndarray, rng, t: int, v: int) -> None:
    """One chain's draft: copy the target's picks for a random-length prefix,
    then force the first mismatch (reference :486-491), in place."""
    keep = int(rng.integers(0, t))                 # 0..t-1 matching tokens
    draft[:keep] = picks[:keep]
    if keep < t - 1:
        draft[keep] = (picks[keep] + 1) % v


def _specdec_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    b, t, v = case.dims
    scores = rng.normal(size=(b, t, v)).astype(np.float32)
    picks = np.argmax(scores, axis=-1)
    draft = rng.integers(0, v, size=(b, max(t - 1, 0))).astype(np.int32)
    for i in range(b):
        _force_prefix(draft[i], picks[i], rng, t, v)
    return {"scores": torch.from_numpy(scores).to(device),
            "draft": torch.from_numpy(draft).to(device)}


def _specdec_tree_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    b, nbr, t, v = case.dims
    scores = rng.normal(size=(b, nbr, t, v)).astype(np.float32)
    picks = np.argmax(scores, axis=-1)
    draft = rng.integers(0, v, size=(b, nbr, max(t - 1, 0))).astype(np.int32)
    for i in range(b):
        for j in range(nbr):
            _force_prefix(draft[i, j], picks[i, j], rng, t, v)
        if case.name == "tie_branches" and nbr > 1 and t > 1:
            # two siblings with equal accept lengths: the first must win
            draft[i, 1] = draft[i, 0]
            scores[i, 1] = scores[i, 0]
    return {"scores": torch.from_numpy(scores).to(device),
            "draft": torch.from_numpy(draft).to(device)}


def _specdec_work(i: dict) -> tuple[float, float]:
    """A max and a first-index compare per score (2 operations); the scores
    and draft read once, the int32 samples, accept (and branch) written once."""
    scores, draft = i["scores"], i["draft"]
    b, t = scores.shape[0], scores.shape[-2]
    n_out = b * t + b * (2 if scores.ndim == 4 else 1)
    return 2.0 * scores.numel(), _nbytes(scores, draft) + 4.0 * n_out


def _packed_ints(*outs: torch.Tensor) -> torch.Tensor:
    """(samples (B, T), accept (B,) [, branch (B,)]) as one (B, T+1[+1])
    int32 array, as the reference's `_specdec_packed` concatenates them."""
    return torch.cat([outs[0]] + [o[:, None] for o in outs[1:]], dim=1)


def _register_specdec() -> None:
    from repro_torch.kernels.specdec.ref import verify_accept_ref, verify_accept_tree_ref
    from repro_torch.kernels.specdec.specdec import (verify_accept_kernel,
                                                     verify_accept_tree_kernel)

    register(KernelSpec(
        name="specdec",
        dtypes=(torch.float32,),          # sampler math is fp32 by contract
        cases=(
            # dims = (B, K+1 window positions, vocab)
            ShapeCase("window", (4, 5, 512)),
            ShapeCase("deep", (2, 9, 384)),
            ShapeCase("ragged_vocab", (3, 4, 301), edge=True),
            ShapeCase("bonus_only", (2, 1, 128), edge=True),   # K = 0
            ShapeCase("tiny", (1, 2, 8), edge=True),
        ),
        make_inputs=_specdec_inputs,
        run_kernel=lambda i: _packed_ints(*verify_accept_kernel(i["scores"], i["draft"])),
        run_oracle=lambda i: _packed_ints(*verify_accept_ref(i["scores"], i["draft"])),
        tol=lambda dt: (0.0, 0.0),        # integer outputs: exact or wrong
        work=_specdec_work,
        source="src/repro_torch/csrc/specdec.cu",
        replaces="src/repro/kernels/specdec/specdec.py:147",
    ))
    register(KernelSpec(
        name="specdec_tree",
        dtypes=(torch.float32,),
        cases=(
            # dims = (B, branches, K+1 window positions, vocab)
            ShapeCase("fanout2", (4, 2, 5, 512)),
            ShapeCase("fanout3", (2, 3, 4, 384)),
            ShapeCase("single_branch", (3, 1, 4, 256), edge=True),  # == chain
            ShapeCase("tie_branches", (3, 2, 5, 256), edge=True),
            ShapeCase("ragged_vocab", (2, 2, 4, 301), edge=True),
            ShapeCase("bonus_only", (2, 2, 1, 128), edge=True),     # K = 0
        ),
        make_inputs=_specdec_tree_inputs,
        run_kernel=lambda i: _packed_ints(*verify_accept_tree_kernel(i["scores"],
                                                                     i["draft"])),
        run_oracle=lambda i: _packed_ints(*verify_accept_tree_ref(i["scores"], i["draft"])),
        tol=lambda dt: (0.0, 0.0),
        work=_specdec_work,
        source="src/repro_torch/csrc/specdec.cu",
        replaces="src/repro/kernels/specdec/specdec.py:98",
    ))


# ---------------------------------------------------------------------------
# act_lut — 33-knot piecewise-linear activation evaluation
# ---------------------------------------------------------------------------


def _act_lut_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    from repro_torch.core.numerics import build_lut
    from repro_torch.kernels.act_lut.ops import table_operands

    (n,) = case.dims
    table = build_lut("sigmoid")
    lo, hi = table.xs[0], table.xs[-1]
    x = rng.uniform(lo - 2.0, hi + 2.0, size=(n,)).astype(np.float32)
    return {"x": torch.from_numpy(x).to(device=device, dtype=dtype),
            "table": table_operands("sigmoid", device), "name": "sigmoid"}


def _act_lut_work(i: dict) -> tuple[float, float]:
    """32 compares and the segment's multiply-add per element (the
    reference's cost, 40 an element); x read once, y written once, the
    table read once."""
    n = i["x"].numel()
    return 40.0 * n, 2.0 * _nbytes(i["x"]) + _nbytes(i["table"])


def _register_act_lut() -> None:
    from repro_torch.kernels.act_lut.ops import lut_activation
    from repro_torch.kernels.act_lut.ref import act_lut_ref

    register(KernelSpec(
        name="act_lut",
        dtypes=(torch.float32, torch.bfloat16),
        cases=(
            ShapeCase("block", (1024,)),
            ShapeCase("long", (4096,)),
            ShapeCase("ragged", (1311,), edge=True),
            ShapeCase("tiny", (7,), edge=True),
        ),
        make_inputs=_act_lut_inputs,
        run_kernel=lambda i: lut_activation(i["name"])(i["x"]),
        run_oracle=lambda i: act_lut_ref(i["x"], i["table"]),
        # the PWL table itself is fp16-grid accurate; bf16 x adds input
        # rounding (reference :467)
        tol=lambda dt: (0.0, 2e-3) if dt == torch.float32 else (0.0, 2e-2),
        work=_act_lut_work,
        source="src/repro_torch/csrc/act_lut.cu",
        replaces="src/repro/kernels/act_lut/act_lut.py:58",
    ))


# ---------------------------------------------------------------------------
# conv2d / avg_pool / max_pool — the conv-engine family (NHWC)
# ---------------------------------------------------------------------------


def _conv_tol(dtype) -> tuple[float, float]:
    # fp32 covers tap-loop accumulation-order differences; narrow dtypes add
    # a store rounding and, for fused-LUT cases, a possible PWL segment flip
    # at a knot boundary (reference :597)
    return (2e-3, 2e-3) if dtype == torch.float32 else (3e-2, 3e-2)


def _conv2d_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    b, h, w, cin, cout, kh, kw, sh, sw, same = case.dims
    out = {"x": _normal(rng, (b, h, w, cin), dtype, device),
           "w": torch.from_numpy(rng.normal(size=(kh, kw, cin, cout)) * 0.2).to(
               device=device, dtype=dtype),
           "bias": _normal(rng, (cout,), dtype, device),
           "stride": (sh, sw), "padding": "SAME" if same else "VALID"}
    if case.name.startswith("fused_"):
        out["epilogue"] = case.name.split("_", 1)[1]
    return out


def _conv2d_work(i: dict) -> tuple[float, float]:
    """2·B·OH·OW·KH·KW·Cin·Cout operations (every tap, as the reference's
    cost counts them); x, w, bias (and a fused table) read once, the output
    written once."""
    from repro_torch.kernels.conv.ref import out_extent

    b, h, wd, cin = i["x"].shape
    kh, kw, _, cout = i["w"].shape
    (sh, sw), pad = i["stride"], i["padding"]
    n_out = b * out_extent(h, kh, sh, pad) * out_extent(wd, kw, sw, pad)
    table = 99 * 4 if i.get("epilogue") else 0
    return (2.0 * n_out * kh * kw * cin * cout,
            _nbytes(i["x"], i["w"], i["bias"]) + table + n_out * cout * i["x"].element_size())


def _conv2d_vjp(inputs: dict):
    from repro_torch.kernels.conv import ops as conv_ops
    from repro_torch.kernels.conv.ref import conv2d_ref

    st, pad = inputs["stride"], inputs["padding"]
    return (lambda x, w: conv_ops.conv2d(x, w, stride=st, padding=pad).sum(),
            lambda x, w: conv2d_ref(x, w, stride=st, padding=pad).sum(),
            _grad_leaves(inputs["x"], inputs["w"]))


def _register_conv2d() -> None:
    from repro_torch.kernels.conv.ops import conv2d
    from repro_torch.kernels.conv.ref import conv2d_ref

    def plain(i: dict) -> torch.Tensor:
        from repro_torch.kernels.act_lut.ops import table_operands

        name = i.get("epilogue")
        return conv2d_ref(i["x"], i["w"], i["bias"], stride=i["stride"],
                          padding=i["padding"],
                          epilogue_table=None if name is None else
                          table_operands(name, i["x"].device))

    register(KernelSpec(
        name="conv2d",
        dtypes=(torch.float32, torch.bfloat16, torch.float16),
        cases=(
            # dims = (B, H, W, Cin, Cout, KH, KW, SH, SW, same?)
            ShapeCase("same_s1", (2, 16, 16, 8, 128, 3, 3, 1, 1, 1)),
            ShapeCase("strided", (1, 20, 16, 8, 128, 3, 3, 2, 2, 1)),
            ShapeCase("fused_gelu", (1, 12, 12, 8, 128, 3, 3, 1, 1, 1)),
            ShapeCase("valid_s1", (2, 10, 10, 16, 64, 3, 3, 1, 1, 0)),
            ShapeCase("ragged_tail", (1, 17, 13, 5, 33, 3, 3, 2, 2, 1), edge=True),
            ShapeCase("pointwise", (2, 8, 8, 24, 48, 1, 1, 1, 1, 1), edge=True),
            ShapeCase("stride_gt_k", (1, 12, 12, 8, 16, 2, 2, 3, 3, 0), edge=True),
        ),
        make_inputs=_conv2d_inputs,
        run_kernel=lambda i: conv2d(i["x"], i["w"], i["bias"], stride=i["stride"],
                                    padding=i["padding"], epilogue=i.get("epilogue")),
        run_oracle=plain,
        tol=_conv_tol,
        work=_conv2d_work,
        source="src/repro_torch/csrc/conv2d.cu",
        replaces="src/repro/kernels/conv/conv2d.py:95",
        make_vjp=_conv2d_vjp,
    ))


def _pool_inputs(case: ShapeCase, dtype, rng, device) -> dict:
    b, h, w, c, wh, ww, sh, sw, same = case.dims
    return {"x": _normal(rng, (b, h, w, c), dtype, device),
            "window": (wh, ww), "stride": (sh, sw),
            "padding": "SAME" if same else "VALID"}


_POOL_CASES = (
    # dims = (B, H, W, C, WH, WW, SH, SW, same?)
    ShapeCase("win2_s2", (2, 16, 16, 32, 2, 2, 2, 2, 0)),
    ShapeCase("win3_s2_same", (1, 15, 15, 16, 3, 3, 2, 2, 1)),
    ShapeCase("overlap", (2, 12, 12, 8, 3, 3, 1, 1, 0)),
    ShapeCase("ragged_tail", (1, 17, 13, 5, 3, 3, 2, 2, 1), edge=True),
    ShapeCase("global", (2, 8, 8, 16, 8, 8, 8, 8, 0), edge=True),
)


def _pool_work(i: dict) -> tuple[float, float]:
    """One operation per tap of every output; x read once, the output
    written once."""
    from repro_torch.kernels.conv.ref import out_extent

    b, h, w, c = i["x"].shape
    (wh, ww), (sh, sw), pad = i["window"], i["stride"], i["padding"]
    n_out = b * out_extent(h, wh, sh, pad) * out_extent(w, ww, sw, pad) * c
    return float(n_out * wh * ww), _nbytes(i["x"]) + n_out * i["x"].element_size()


def _register_pools() -> None:
    from repro_torch.kernels.conv.ops import avg_pool, max_pool
    from repro_torch.kernels.conv.ref import avg_pool_ref, max_pool_ref

    for name, kernel, plain, tol, line in (
            # one fp32 sum each side; only the tap order could differ
            ("avg_pool", avg_pool, avg_pool_ref,
             lambda dt: (1e-5, 1e-5) if dt == torch.float32 else (1e-2, 1e-2), 73),
            # max is order-free: exact or wrong
            ("max_pool", max_pool, max_pool_ref, lambda dt: (0.0, 0.0), 82)):
        register(KernelSpec(
            name=name,
            dtypes=(torch.float32, torch.bfloat16, torch.float16),
            cases=_POOL_CASES,
            make_inputs=_pool_inputs,
            run_kernel=lambda i, f=kernel: f(i["x"], window=i["window"], stride=i["stride"],
                                             padding=i["padding"]),
            run_oracle=lambda i, f=plain: f(i["x"], window=i["window"], stride=i["stride"],
                                            padding=i["padding"]),
            tol=tol,
            work=_pool_work,
            source="src/repro_torch/csrc/pool.cu",
            replaces=f"src/repro/kernels/conv/pool.py:{line}",
        ))


_register_anemm()
_register_palette()
_register_sparse()
_register_flash()
_register_decode()
_register_paged_decode()
_register_act_lut()
_register_specdec()
_register_conv2d()
_register_pools()
