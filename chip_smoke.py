#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. It imports the
port (`src/repro_torch`) and nothing of JAX, and runs these phases in order,
printing one JSON line for each:

  1. device  — the card, its power limit, the torch and CUDA versions;
  2. build   — every kernel built from `src/repro_torch/csrc/` with nvcc for
               sm_90a (one nvcc per source, all started together);
  3. kernels — each kernel held against its plain PyTorch version on the
               card, on every registry case and at the main-path shapes of
               full tinyllama-1.1b and whisper-small (the stem's two convs
               with their fused GELU, the GELU table over a stem output, the
               encoder's non-causal attention) and of a pooling pyramid, at
               the registry tolerance; `anemm`'s fused `epilogue=` against
               its plain version and bit for bit against anemm-then-act_lut;
               `paged_decode_attention` on every registry case and with a
               window, bit for bit against `decode_attention(bk=bs)` on the
               gathered pages; the median
               device time (CUDA-graph replay between CUDA events, L2
               flushed) of the kernel, its plain version and one PyTorch
               library call computing the same function, beside the bound
               (bytes at the memory rate or operations at the peak rate,
               whichever is larger), and the kernel's eager per-call time;
  4. parity  — the smoke model's prefill and decode logits on the card
               (kernels) against the same weights on the CPU (plain versions),
               dense and packed (int4_palette, sparse), fp32 and bf16; the
               same for whisper-small smoke (frames through the conv stem);
  5. rows    — full tinyllama-1.1b decode steps on 8 lanes and on the same
               8 lanes twice over (16 rows): the first 8 rows' logits must be
               equal bit for bit (a tree verify window runs 16 rows where
               decode runs 8, and the spec streams must equal the continuous
               ones);
  6. serve   — full-width, full-depth tinyllama-1.1b (random weights from a
               seed, bf16) served by the serve CLI's entry point through the
               continuous schedule, once per weight form: fp16 (dense, anemm),
               int4_palette (palette) and sparse (sparse), each packed on the
               card after init. Each run's launch counts are zeroed just
               before and read just after; every route must be cuda and each
               of the run's kernels must have launched its expected count;
  7. profile — one more round of each serve under torch.profiler: device
               time by kernel and the device's busy share;
  8. prefix  — the same model (fp16 form) served twice by the serve CLI's
               entry point on 8 lanes, 16 requests over two rounds, each
               round one 256-token system prompt (drawn from the seed)
               followed by unique tails (prompts 264..504, 32 tokens each):
               once through the paged prefix pool (`--prefix-cache
               --prefix-block-size 16 --prefix-blocks 64`) and once without.
               The tokens must be equal; the pool must count 2 misses, 14
               hits and 3,584 hit tokens, and the pooled run must make
               exactly 12 fewer dispatches (a miss adds `pool_insert`, a hit
               replaces prefill + `admit_slot` by one `prefix_admit`) with the
               same decode steps; every route cuda, every kernel's launches as
               the run's forwards imply, no page table held at the end, the
               pool's audit clean. Then `paged_decode_attention` on every
               layer's slice of the served arena, read in place (8 lanes on
               the two resident chains, two tables cut short with unmapped
               pages): bit for bit equal to `decode_attention(bk=16)` on the
               gathered pages and within tolerance of its plain version,
               timed as the other kernels are;
  9. spec    — the same model and requests (fp16 form) through the
               speculative schedule (`--schedule spec --draft-depth 4`) three
               ways: `--draft self`, `--draft shrink`, and `--draft shrink
               --draft-branches 2`; then once more with two branches and an
               early-exit drafter (the target's first L-1 layers, final norm
               and head, built beside the CLI's entry point), which accepts
               some proposals and not others, so that windows keep part of
               their writes and roll back the rest, and branch 1 wins some
               lanes. Each run's tokens must equal the fp16 continuous run's,
               every route must be cuda, the self drafter must accept
               everything, the shrink drafter must be rejected somewhere, the
               early-exit drafter must accept strictly between none and all,
               with some partial windows and some branch-1 wins; every window
               must make one verify and (if it drafted) one draft dispatch,
               and every kernel must have launched exactly as often as the
               run's forwards and windows say;
  10. encoder — full whisper-small (12 + 12 layers, d 768, random bf16
               weights from a seed) served by the serve CLI's entry point
               through the continuous schedule: per-request log-mel frames
               (3000, 80) through the two-conv stem (conv2d with the GELU
               fused), the encoder, the cross K/V built at prefill and
               resident in decode. Every route must be cuda and each
               kernel's launches must equal what the run's admissions and
               decode steps imply; then each request's frames encoded with
               the stem fused and unfused (conv2d, then act_lut), which must
               give the same bits with exactly 2 more act_lut launches per
               request; the pools routed once at the pyramid shapes; and one
               more round under the profiler for the device's busy share.

Then a `kernels` line with every kernel's numbers, the card's name and power
limit as nvidia-smi reports them, and last `{"ok": true, "device": ...}`.
Any failure raises and the exit code is not 0; no phase is skipped. Without a
CUDA device it exits with code 1 before printing any result; alone in a
directory, without the port beside it, it fails at the import.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port itself: alone in a directory, the script stops here
from repro_torch import configs  # noqa: E402
from repro_torch.core import hal  # noqa: E402
from repro_torch.core.dispatch import (AsyncExecutionStream, KernelDispatcher,  # noqa: E402
                                       ProgramCache, dtype_name)
from repro_torch.kernels import native, registry  # noqa: E402
from repro_torch.kernels.act_lut.ops import lut_activation, table_operands  # noqa: E402
from repro_torch.kernels.anemm.anemm import anemm  # noqa: E402
from repro_torch.kernels.anemm.ref import anemm_ref  # noqa: E402
from repro_torch.kernels.flash.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, gather_pages, gathered_positions,
    paged_decode_attention, paged_decode_attention_ref)
from repro_torch.kernels.flash.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.scheduler import Request, merge_prefill_caches  # noqa: E402
from repro_torch.launch.speculative import Drafter, SpeculativeSchedule  # noqa: E402
from repro_torch.models import dispatched as dsp  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.compression import compress_model_params  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

# the serve phase: 8 lanes, prompts mixing bucket-exact and ragged lengths
SERVE_LENS = "37,64,100,128,200,256,300,512"
SERVE_GEN = 32
SERVE_ROUNDS = 2
SERVE_MAX_LEN = 512 + SERVE_GEN          # the serve run's cache length
# weight form -> the kernel that runs its every matmul on the serve path
FORM_KERNEL = {"fp16": "anemm", **{f.value: k.kernel for f, k in dsp.FORM_KERNELS.items()}}
# packed kernel -> its form's pack / unpack / wrapper (models.dispatched)
PACKED = {k.kernel: k for k in dsp.FORM_KERNELS.values()}
NAMED_RECORDS = ("admit_slot", "reset_slot", "merge_prefill")   # lane writes
SPEC_DEPTH = 4
# the spec phase's runs: drafter and branches
SPEC_RUNS = (("self", 1), ("shrink", 1), ("shrink", 2), ("early_exit", 2))

# the encoder phase: whisper-small, 8 lanes, prompts that each reach a
# prefill bucket (the cross K/V is built at prefill), 32 tokens each
ENCODER_ARCH = "whisper-small"
ENCODER_LENS = "8,16,24,32,48,64,100,128"
# the pooling pyramid of the kernels phase: a 3x3 stride-2 SAME max pool
# (a ResNet stem's) and a 7x7 global average pool (its head's), bf16
POOL_SHAPES = {"max_pool": ((8, 112, 112, 64), (3, 3), (2, 2), "SAME"),
               "avg_pool": ((8, 7, 7, 2048), (7, 7), (7, 7), "VALID")}

# the prefix phase: per round one shared system prompt, then unique tails;
# every prompt's bucket is 256 and the L-1 match cap still reaches it
PREFIX_SYSTEM = 256
PREFIX_LENS = (264, 280, 300, 320, 360, 400, 450, 504)
PREFIX_ROUNDS = 2
PREFIX_BLOCK = 16
PREFIX_BLOCKS = 64
PREFIX_NAMED = ("admit_slot", "reset_slot", "prefix_admit", "pool_insert")

TIMING_REPS = 20
L2_FLUSH_BYTES = 256 << 20               # > the H100's 50 MB L2


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median time of one call between CUDA events, with the L2 cache flushed
    before every call (the serving path reads each layer's weights once per
    step, from device memory).

    `device_ms` captures the call into a CUDA graph and times its replay: the
    device's time for the work, without the host's launch overhead.
    `eager_ms` times the call as the serving path makes it, host overhead
    included when the host is slower than the device."""

    def __init__(self) -> None:
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def device_ms(self, fn, reps: int = TIMING_REPS) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        ms = self.eager_ms(graph.replay, reps)
        del graph
        return ms

    def eager_ms(self, fn, reps: int = TIMING_REPS) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _compare(out, ref, tol) -> tuple[float, bool]:
    rtol, atol = tol
    o, r = out.float(), ref.float()
    same_inf = torch.equal(torch.isinf(o), torch.isinf(r)) and \
        torch.equal(o[torch.isinf(o)], r[torch.isinf(r)])
    fin = torch.isfinite(r)
    diff = (o[fin] - r[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = same_inf and bool(torch.isfinite(o[fin]).all()) and bool(
        (diff <= atol + rtol * r[fin].abs()).all())
    return err, ok


def main_path_inputs(cfg, rng) -> list[tuple[str, str, dict]]:
    """(kernel, shape label, inputs) at the shapes full tinyllama-1.1b gives
    each kernel on the serve path."""
    dev, bf16 = "cuda", torch.bfloat16
    d, h, kv, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.d_ff, cfg.padded_vocab)

    def normal(shape, dtype, std=1.0):
        return (torch.from_numpy(rng.normal(size=shape) * std)
                .to(device=dev, dtype=dtype))

    cases = []
    projections = {"q_o": (d, h * dh), "k_v": (d, kv * dh),
                   "gate_up": (d, f), "down": (f, d)}
    # the packed forms, packed on the card as the serve path packs them
    packed = {}
    for k, n in list(projections.values()) + [(d, v)]:
        w = normal((k, n), torch.float32, k ** -0.5)
        packed[k, n] = {name: form.pack(w) for name, form in PACKED.items()}
    shapes = [(label, m, k, n, bf16) for m in (8, 512)
              for label, (k, n) in projections.items()]
    # the fp32 head: prefill's last token, decode's lanes
    shapes += [("head", m, d, v, torch.float32) for m in (1, 8)]
    for name in ("anemm", *PACKED):
        for label, m, k, n, dtype in shapes:
            a = normal((m, k), dtype)
            weights = ({"b": normal((k, n), dtype, k ** -0.5)} if name == "anemm"
                       else packed[k, n][name])
            cases.append((name, f"{label} M={m} {k}->{n} {dtype_name(dtype)}",
                          {"a": a, **weights}))
    L = 512
    cases.append(("flash", f"causal L={L} H={h} KV={kv} d={dh} bf16",
                  {"q": normal((1, h, L, dh), bf16), "k": normal((1, kv, L, dh), bf16),
                   "v": normal((1, kv, L, dh), bf16)}))
    B, S = 8, SERVE_MAX_LEN
    lens = torch.tensor([int(x) for x in SERVE_LENS.split(",")], dtype=torch.int32,
                        device=dev) + SERVE_GEN // 2
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    cases.append(("decode_attention", f"B={B} S={S} H={h} KV={kv} d={dh} bf16",
                  {"q": normal((B, h, dh), bf16),
                   "k_cache": normal((B, S, kv, dh), bf16),
                   "v_cache": normal((B, S, kv, dh), bf16),
                   "positions": torch.where(pos < lens[:, None], pos, -1).contiguous(),
                   "current": (lens - 1).contiguous()}))
    # whisper-small: the stem's two convs with the GELU fused at the output
    # port (conv2 first: the headline), the GELU table over the stem's
    # output, the pools of the pyramid
    w = configs.get_config(ENCODER_ARCH)
    t, d_w, kw = w.frame_shape[0], w.d_model, w.stem_width
    for label, cin, stride in (("conv2", d_w, w.stem_stride), ("conv1", w.n_mels, 1)):
        cases.append(("conv2d", f"stem {label} (1,1,{t},{cin})->{d_w} s{stride} gelu bf16",
                      {"x": normal((1, 1, t, cin), bf16),
                       "w": normal((1, kw, cin, d_w), bf16, (kw * cin) ** -0.5),
                       "bias": normal((d_w,), bf16, 0.1), "stride": (1, stride),
                       "padding": "SAME", "epilogue": "gelu"}))
    cases.append(("act_lut", f"gelu ({t},{d_w}) bf16",
                  {"x": normal((t, d_w), bf16, 2.0), "table": table_operands("gelu", dev),
                   "name": "gelu"}))
    for name, (shape, window, stride, pad) in POOL_SHAPES.items():
        cases.append((name, f"{shape} {window[0]}x{window[1]} s{stride[0]} {pad} bf16",
                      {"x": normal(shape, bf16), "window": window, "stride": stride,
                       "padding": pad}))
    # a verify window of the spec phase: 8 lanes, K+1 = 5 positions, the
    # vocab; the tree's 2 branches
    T = SPEC_DEPTH + 1
    for name, dims in (("specdec", (B, T, cfg.vocab)), ("specdec_tree", (B, 2, T, cfg.vocab))):
        inputs = registry.get(name).make_inputs(registry.ShapeCase("main", dims),
                                                torch.float32, rng, dev)
        cases.append((name, "x".join(map(str, dims)) + " fp32", inputs))
    return cases


def library_call(name: str, i: dict):
    """One PyTorch call computing the same function (the yardstick only;
    the port never calls these). For the packed rows it is `torch.matmul`
    on the weight decoded beforehand, in the activation's dtype: the
    reference's FOLD path, which moves the dense weight's bytes."""
    if name == "anemm":
        return lambda: torch.matmul(i["a"], i["b"])
    if name in PACKED:
        w = PACKED[name].unpack(*PACKED[name].args(i)).to(i["a"].dtype)
        return lambda: torch.matmul(i["a"], w)
    if name == "flash":
        return lambda: F.scaled_dot_product_attention(
            i["q"], i["k"], i["v"], is_causal=i.get("causal", True), enable_gqa=True)
    if name in ("specdec", "specdec_tree"):       # the picks alone
        return lambda: torch.argmax(i["scores"], dim=-1)
    if name == "act_lut":                          # no PyTorch call evaluates a table
        return None
    if name in ("conv2d", "avg_pool", "max_pool"):
        # channels-last views of the NHWC tensors; torch pads symmetrically,
        # so a SAME window shifts by one cell where the pads are (0, 1): the
        # same work, not the same cells. conv2d: the conv alone (no GELU).
        x = i["x"].permute(0, 3, 1, 2)
        kh, kw = i["w"].shape[:2] if name == "conv2d" else i["window"]
        pad = (kh // 2, kw // 2) if i["padding"] == "SAME" else (0, 0)
        if name == "conv2d":
            w = i["w"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            return lambda: F.conv2d(x, w, i["bias"], stride=i["stride"], padding=pad)
        if name == "avg_pool":
            return lambda: F.avg_pool2d(x, i["window"], i["stride"], padding=pad,
                                        count_include_pad=True)
        return lambda: F.max_pool2d(x, i["window"], i["stride"], padding=pad)
    q, cur = i["q"][:, :, None], i["current"]
    if name == "paged_decode_attention":           # the gather, then SDPA
        tables = i["block_tables"]

        def paged():
            k = gather_pages(i["k_arena"], tables).transpose(1, 2)
            v = gather_pages(i["v_arena"], tables).transpose(1, 2)
            pos = gathered_positions(i["pos_arena"], tables)
            mask = ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :]
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        return paged
    k = i["k_cache"].transpose(1, 2)
    v = i["v_cache"].transpose(1, 2)
    pos = i["positions"]
    mask = ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


PAGED_NAMES = ("q", "k_arena", "v_arena", "pos_arena", "block_tables", "current")


def decode_on_gathered_pages(i: dict, window=None) -> torch.Tensor:
    """`decode_attention(bk=bs)` on the gathered pages of a paged bundle:
    what `paged_decode_attention` must equal bit for bit (the reference's
    contract)."""
    tables = i["block_tables"]
    return decode_attention(i["q"], gather_pages(i["k_arena"], tables),
                            gather_pages(i["v_arena"], tables),
                            gathered_positions(i["pos_arena"], tables), i["current"],
                            window=window, bk=i["k_arena"].shape[1])


def noncausal_flash(spec):
    """The flash row without the causal mask (the encoder's and the
    cross-attention's): every (query, key) pair is work."""
    def work(i):
        b, h, sq, d = i["q"].shape
        n_bytes = 2 * i["q"].numel() * i["q"].element_size() + sum(
            i[k].numel() * i[k].element_size() for k in ("k", "v"))
        return 4.0 * b * h * d * sq * i["k"].shape[2], float(n_bytes)

    return dataclasses.replace(
        spec, work=work,
        run_kernel=lambda i: flash_attention(i["q"], i["k"], i["v"], causal=False),
        run_oracle=lambda i: flash_attention_ref(i["q"], i["k"], i["v"], causal=False))


def check_case(spec, label, inputs, failures: list, timer=None) -> dict:
    """One kernel call against its plain version on the same inputs; with a
    timer, also the times of the kernel, its plain version and the library
    call, and the bound from this run's inputs. Emits the record; a
    disagreement is appended to `failures`."""
    target = hal.H100
    out = spec.run_kernel(inputs)
    ref = spec.run_oracle(inputs)
    torch.cuda.synchronize()
    dtype = next(t.dtype for t in inputs.values()
                 if isinstance(t, torch.Tensor) and t.is_floating_point())
    tol = spec.tol(dtype)
    err, ok = _compare(out, ref, tol)
    rec = {"kernel": spec.name, "shape": label, "max_abs_err": err,
           "tol": list(tol), "ok": ok}
    if timer is not None:
        ops, nbytes = spec.work(inputs)
        t_ops = ops / target.peak_for(dtype_name(dtype))
        t_bytes = nbytes / target.hbm_bandwidth
        library = library_call(spec.name, inputs)
        rec.update({
            "ms": timer.device_ms(lambda: spec.run_kernel(inputs)),
            "eager_ms": timer.eager_ms(lambda: spec.run_kernel(inputs)),
            "plain_ms": timer.device_ms(lambda: spec.run_oracle(inputs)),
            "library_ms": None if library is None else timer.device_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes})
    emit("kernel", **rec)
    if not ok:
        failures.append(f"{spec.name} {label}: max_abs_err {err} tol {tol}")
    return rec


def check_kernels(cfg, timer) -> dict:
    """Every registry case and every main-path shape: kernel vs plain on the
    card. Returns the headline record of each kernel but the paged decode,
    whose headline the prefix phase measures on the served arena."""
    rng = np.random.default_rng(0)
    failures = []

    def check(spec, label, inputs, timed: bool):
        return check_case(spec, label, inputs, failures, timer if timed else None)

    for spec in registry.all_specs():
        for dtype in spec.dtypes:
            for case in spec.cases:
                inputs = spec.make_inputs(case, dtype, rng, "cuda")
                check(spec, f"registry {case.name} {dtype_name(dtype)}", inputs, False)
    # anemm's epilogue: per-N scale, bias, and saturation hit on purpose
    mm = registry.get("anemm")
    for dtype in mm.dtypes:
        i = mm.make_inputs(mm.cases[2], dtype, rng, "cuda")
        n = i["b"].shape[1]
        i["a"][0] *= 4000.0                      # rows past the 2^15 ceiling
        scale = torch.linspace(0.5, 2.0, n, device="cuda")
        bias = torch.linspace(-1.0, 1.0, n, device="cuda")
        ep = dataclasses.replace(mm, run_kernel=lambda i: anemm(
            i["a"], i["b"], scale, bias, ane_mode=True), run_oracle=lambda i: anemm_ref(
            i["a"], i["b"], scale, bias, ane_mode=True))
        check(ep, f"epilogue scale+bias+ane_mode {dtype_name(dtype)}", i, False)
    # anemm's fused LUT epilogue: against its plain version, and bit for bit
    # against anemm, then act_lut
    for dtype in mm.dtypes:
        for case in mm.cases:
            i = mm.make_inputs(case, dtype, rng, "cuda")
            table = table_operands("gelu", "cuda")
            ep = dataclasses.replace(mm, run_kernel=lambda i: anemm(
                i["a"], i["b"], epilogue="gelu"), run_oracle=lambda i: anemm_ref(
                i["a"], i["b"], epilogue_table=table))
            check(ep, f"epilogue=gelu {case.name} {dtype_name(dtype)}", i, False)
            fused = anemm(i["a"], i["b"], epilogue="gelu")
            if not torch.equal(fused, lut_activation("gelu")(anemm(i["a"], i["b"]))):
                failures.append(f"anemm epilogue=gelu {case.name} {dtype_name(dtype)}: "
                                "fused differs from anemm-then-act_lut")
    # the encoder's non-causal attention, which the registry cases leave off
    fl = registry.get("flash")
    nc = noncausal_flash(fl)
    for dtype in fl.dtypes:
        i = {**fl.make_inputs(fl.cases[0], dtype, rng, "cuda"), "causal": False}
        check(nc, f"non-causal {dtype_name(dtype)}", i, False)
    # the sliding-window mask, which the registry cases leave off
    fl, dec = registry.get("flash"), registry.get("decode_attention")
    for dtype in dec.dtypes:
        i = fl.make_inputs(fl.cases[0], dtype, rng, "cuda")
        win = dataclasses.replace(
            fl, run_kernel=lambda i: flash_attention(i["q"], i["k"], i["v"], window=24),
            run_oracle=lambda i: flash_attention_ref(i["q"], i["k"], i["v"], window=24))
        check(win, f"window=24 {dtype_name(dtype)}", i, False)
        i = dec.make_inputs(dec.cases[0], dtype, rng, "cuda")
        names = ("q", "k_cache", "v_cache", "positions", "current")
        win = dataclasses.replace(
            dec, run_kernel=lambda i: decode_attention(*(i[k] for k in names), window=24),
            run_oracle=lambda i: decode_attention_ref(*(i[k] for k in names), window=24))
        check(win, f"window=24 {dtype_name(dtype)}", i, False)

    # the paged decode: bit for bit against decode_attention(bk=bs) on the
    # gathered pages on every registry case, and with a window
    pg = registry.get("paged_decode_attention")
    for dtype in pg.dtypes:
        for case in pg.cases:
            i = pg.make_inputs(case, dtype, rng, "cuda")
            win = dataclasses.replace(
                pg, run_kernel=lambda i: paged_decode_attention(
                    *(i[k] for k in PAGED_NAMES), window=5),
                run_oracle=lambda i: paged_decode_attention_ref(
                    *(i[k] for k in PAGED_NAMES), window=5))
            check(win, f"window=5 {case.name} {dtype_name(dtype)}", i, False)
            for window in (None, 5):
                same = torch.equal(
                    paged_decode_attention(*(i[k] for k in PAGED_NAMES), window=window),
                    decode_on_gathered_pages(i, window))
                emit("paged_bits", case=case.name, dtype=dtype_name(dtype), window=window,
                     bit_identical=same)
                if not same:
                    failures.append(f"paged_decode_attention {case.name} "
                                    f"{dtype_name(dtype)} window={window}: differs from "
                                    "decode_attention(bk=bs) on the gathered pages")

    # verify/accept on rows with planted equal maxima and rows of all -inf,
    # at the spec phase's shapes
    for name in ("specdec", "specdec_tree"):
        spec = registry.get(name)
        dims = (8, SPEC_DEPTH + 1, cfg.vocab) if name == "specdec" else \
            (8, 2, SPEC_DEPTH + 1, cfg.vocab)
        for kind in ("ties", "-inf"):
            i = spec.make_inputs(registry.ShapeCase("stress", dims), torch.float32, rng, "cuda")
            s = i["scores"]
            if kind == "ties":
                top = s.amax(-1, keepdim=True) + 1.0
                cols = torch.randint(0, cfg.vocab, s.shape[:-1] + (3,), device="cuda")
                s.scatter_(-1, cols, top.expand(*s.shape[:-1], 3).contiguous())
            else:
                s[1::2] = float("-inf")           # every other lane
            check(spec, f"{kind} rows " + "x".join(map(str, dims)), i, False)

    headline = {}
    for name, label, inputs in main_path_inputs(cfg, rng):
        rec = check(registry.get(name), "main " + label, inputs, True)
        headline.setdefault(name, rec)
        if label.startswith("gate_up M=8"):
            headline[name] = rec                  # decode-time projection
    # whisper-small's encoder attention (non-causal, L = 1500) and a decode
    # step's cross-attention (8 lanes, one query against 1500 keys): timed,
    # not headlines
    w = configs.get_config(ENCODER_ARCH)
    h_w, d_h, enc_len = w.n_heads, w.d_head, w.encoder_len
    for b, sq in ((1, enc_len), (8, 1)):
        i = {k: torch.from_numpy(rng.normal(size=(b, h_w, sq if k == "q" else enc_len, d_h)))
             .to(device="cuda", dtype=torch.bfloat16) for k in ("q", "k", "v")}
        check(nc, f"main non-causal B={b} Sq={sq} Skv={enc_len} H={h_w} d={d_h} bf16",
              {**i, "causal": False}, True)
    # the fp32 head widens the bf16 unembed on every call (reference
    # layers.py:158-161): the copy's own device time
    unembed = torch.empty((cfg.d_model, cfg.padded_vocab), dtype=torch.bfloat16,
                          device="cuda").normal_()
    emit("head_widen", shape=list(unembed.shape),
         ms=timer.device_ms(lambda: unembed.to(torch.float32)),
         bytes=unembed.numel() * (2 + 4))
    if failures:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(failures))
    return headline


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs a CUDA card",
              file=sys.stderr)
        return 1
    # fp32 plain versions and library calls in full fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=kind, count=torch.cuda.device_count(), python=sys.version.split()[0],
         bound_target=hal.H100.name, bound_sku_matches=kind == hal.H100.sku)

    built = native.build()
    ptxas = {n: [ln.strip() for ln in txt.splitlines() if "registers" in ln or "spill" in ln]
             for n, txt in built["log"].items()}
    emit("build", seconds=built["seconds"], built=built["built"], ptxas=ptxas)

    cfg = configs.get_config("tinyllama-1.1b")
    timer = Timer()
    headline = check_kernels(cfg, timer)
    check_parity()
    check_parity_encdec()
    check_rows(cfg)
    # each kernel's launches come from the serve run whose path uses it
    launches, tokens = {}, {}
    for form in FORM_KERNEL:
        run, tokens[form] = serve_main_path(form)
        kernels_of_run = ("anemm", "flash", "decode_attention") if form == "fp16" \
            else (FORM_KERNEL[form],)
        launches.update({k: run[k] for k in kernels_of_run})
        profile_serve(form, serve_argv(cfg, 1, form))
    headline["paged_decode_attention"], launches["paged_decode_attention"] = \
        serve_prefix(cfg, timer)
    for draft, branches in SPEC_RUNS:
        run = serve_spec(cfg, draft, branches, tokens["fp16"])
        if (draft, branches) == ("self", 1):
            launches["specdec"] = run["specdec"]
        if branches > 1:
            launches["specdec_tree"] = run["specdec_tree"]
    launches.update(serve_encoder(timer))

    kernels = []
    for spec in registry.all_specs():
        rec = headline[spec.name]
        kernels.append({
            "name": spec.name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces, "launches": launches[spec.name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def check_parity() -> None:
    """The smoke model, same weights, on the card (kernels) and on the CPU
    (plain versions), dense and in both packed forms (packed once, on the
    CPU, so both sides run the same payload): prefill and three
    teacher-forced decode steps must agree at 4x the tolerance of the row
    that streams the weights."""
    for form, kernel in FORM_KERNEL.items():
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get_smoke("tinyllama-1.1b"), dtype=dtype)
            cpu = build_model(cfg, device="cpu")
            gpu = build_model(cfg, device="cuda")
            params_cpu = cpu.init(torch.Generator().manual_seed(0))
            if form != "fp16":
                params_cpu = compress_model_params(params_cpu, form)
            params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
            rtol, atol = (4 * x for x in registry.get(kernel).tol(gpu.dtype))
            tokens = torch.randint(0, cfg.vocab, (2, 24), dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(1))
            c_cpu, lg_cpu = cpu.prefill(params_cpu, {"tokens": tokens})
            c_gpu, lg_gpu = gpu.prefill(params_gpu, {"tokens": tokens.cuda()})
            errs = [float((lg_gpu.cpu() - lg_cpu).abs().max())]
            torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=rtol, atol=atol)
            c_cpu = merge_prefill_caches(cpu.init_cache(2, 32), c_cpu)
            c_gpu = merge_prefill_caches(gpu.init_cache(2, 32), c_gpu)
            tok = lg_cpu[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
            for i in range(3):
                pos = torch.full((2,), 24 + i, dtype=torch.int32)
                c_cpu, d_cpu = cpu.decode_step(params_cpu, c_cpu, tok, pos)
                c_gpu, d_gpu = gpu.decode_step(params_gpu, c_gpu, tok.cuda(), pos.cuda())
                if not bool(torch.isfinite(d_gpu).all()):
                    raise AssertionError(f"{cfg.name} {form} {dtype}: non-finite decode logits")
                errs.append(float((d_gpu.cpu() - d_cpu).abs().max()))
                torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=rtol, atol=atol)
                tok = d_cpu[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
            routes = {k for k, _ in gpu.dispatcher.census()}
            if routes != {kernel, "flash", "decode_attention"}:
                raise AssertionError(f"{form} {dtype}: card routes {routes}")
            emit("parity", config=cfg.name, weight_form=form, dtype=dtype,
                 max_abs_err=max(errs), tol=[rtol, atol], ok=True)


def serve_main_path(form: str) -> tuple[dict, np.ndarray]:
    """Full tinyllama-1.1b in weight form `form` through the serve CLI's
    entry point; returns the kernels' launch counts from this run alone and
    the tokens, after checking them: every route is cuda, the form's matmul kernel ran
    once per matmul of every forward (7 per layer plus the head) and no
    other matmul kernel ran, flash once per layer of every prefill and
    decode_attention once per layer of every decode step."""
    cfg = configs.get_config("tinyllama-1.1b")
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    out = serve.run(serve_argv(cfg, SERVE_ROUNDS, form))
    launches = native.launch_counts()

    tokens = out["tokens"]
    n_lanes = len(SERVE_LENS.split(","))
    if tokens.shape != (n_lanes, SERVE_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"{form} serve tokens: shape {tokens.shape}, range "
                             f"[{tokens.min()}, {tokens.max()}]")
    backends = {b for _, b in out["routes"]}
    if backends != {"cuda"}:
        raise AssertionError(f"{form} serve routes {out['routes']}: every route must be cuda")
    # the run ends on a decode step: its key is the decode program's; every
    # other program key is a prefill bucket's
    recs = out["records"]
    decode_key = recs[-1].key
    by_kind: dict[str, list[float]] = {}
    for r in recs:
        kind = r.key if r.key in NAMED_RECORDS else \
            "decode" if r.key == decode_key else "prefill"
        by_kind.setdefault(kind, []).append(r.wall_s)
    n_prefill, n_decode = len(by_kind["prefill"]), len(by_kind["decode"])
    matmuls_per_forward = 7 * cfg.n_layers + 1
    want = {k: 0 for k in launches}
    want.update({FORM_KERNEL[form]: matmuls_per_forward * (n_prefill + n_decode),
                 "flash": cfg.n_layers * n_prefill,
                 "decode_attention": cfg.n_layers * n_decode})
    if launches != want:
        raise AssertionError(f"{form} serve launches {launches}, expected {want}")
    census = out["weight_form_census"]
    if form != "fp16" and census != {form: 8}:   # 7 stacked layer matrices + unembed
        raise AssertionError(f"{form} packed leaves {census}")
    dispatches = {k: {"n": len(w), "wall_s": sum(w), "median_ms": statistics.median(w) * 1e3}
                  for k, w in by_kind.items()}
    emit("serve", config=cfg.name, dtype=cfg.dtype, weight_form=form,
         tokens_sha256=hashlib.sha256(np.ascontiguousarray(tokens).tobytes()).hexdigest(),
         n_layers=cfg.n_layers, lanes=n_lanes, prompt_lens=SERVE_LENS, gen=SERVE_GEN,
         rounds=SERVE_ROUNDS, tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
         build_s=out["build_s"], pack_s=out["pack_s"], weight_form_census=census,
         n_dispatches=out["n_dispatches"], dispatches=dispatches,
         cache_hits=out["cache_hits"], cache_misses=out["cache_misses"],
         floor_measured_s=out["floor_measured_s"],
         dispatch_wall_s=out["dispatch_wall_s"], work_s=out["work_s"],
         routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
         launches=launches,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, tokens


def prefix_rounds(cfg) -> list[list[np.ndarray]]:
    """The prefix phase's requests: per round one system prompt of
    PREFIX_SYSTEM tokens, drawn from the seed, each request's unique tail
    after it."""
    rng = np.random.default_rng(0)
    rounds = []
    for _ in range(PREFIX_ROUNDS):
        system = rng.integers(0, cfg.vocab, size=(PREFIX_SYSTEM,))
        rounds.append([np.concatenate([system, rng.integers(0, cfg.vocab,
                                                           size=(n - PREFIX_SYSTEM,))])
                       .astype(np.int32) for n in PREFIX_LENS])
    return rounds


def prefix_argv(cfg, pooled: bool) -> list[str]:
    argv = ["--arch", cfg.name, "--schedule", "continuous", "--batch", str(len(PREFIX_LENS)),
            "--gen", str(SERVE_GEN), "--seed", "0", "--device", "cuda", "--weight-form",
            "fp16"]
    if pooled:
        argv += ["--prefix-cache", "--prefix-block-size", str(PREFIX_BLOCK),
                 "--prefix-blocks", str(PREFIX_BLOCKS)]
    return argv


def serve_prefix(cfg, timer) -> tuple[dict, int]:
    """Full tinyllama-1.1b (fp16 form) through the serve CLI's entry point
    on the prefix phase's requests, with the paged pool and without; then
    `paged_decode_attention` on every layer's slice of the pool's served
    arena. Returns the paged kernel's headline record and its launches in
    that check."""
    rounds = prefix_rounds(cfg)
    runs = {}
    for pooled in (False, True):
        tag = "pooled" if pooled else "pool-less"
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        out = serve.run(prefix_argv(cfg, pooled), prompts=rounds)
        launches = native.launch_counts()
        for r, toks in enumerate(out["round_tokens"]):
            if toks.shape != (len(PREFIX_LENS), SERVE_GEN) or toks.min() < 0 or \
                    toks.max() >= cfg.vocab:
                raise AssertionError(f"prefix {tag} round {r} tokens: shape {toks.shape}, "
                                     f"range [{toks.min()}, {toks.max()}]")
        if {b for _, b in out["routes"]} != {"cuda"}:
            raise AssertionError(f"prefix {tag} routes {out['routes']}: every route must "
                                 "be cuda")
        # the run ends on a decode step; every other program key is a prefill
        recs = out["records"]
        decode_key = recs[-1].key
        kinds = [r.key if r.key in PREFIX_NAMED else
                 "decode" if r.key == decode_key else "prefill" for r in recs]
        counts = {k: kinds.count(k) for k in ("prefill", "decode") + PREFIX_NAMED}
        want = {k: 0 for k in launches}
        want.update({"anemm": (7 * cfg.n_layers + 1) * (counts["prefill"] + counts["decode"]),
                     "flash": cfg.n_layers * counts["prefill"],
                     "decode_attention": cfg.n_layers * counts["decode"]})
        if launches != want:
            raise AssertionError(f"prefix {tag} launches {launches}, expected {want}")
        walls = {k: [r.wall_s for r, kind in zip(recs, kinds) if kind == k]
                 for k in counts if counts[k]}
        emit("prefix_serve", config=cfg.name, dtype=cfg.dtype, pooled=pooled,
             lanes=len(PREFIX_LENS), system_prompt=PREFIX_SYSTEM, prompt_lens=PREFIX_LENS,
             gen=SERVE_GEN, rounds=PREFIX_ROUNDS, block_size=PREFIX_BLOCK,
             blocks=PREFIX_BLOCKS, tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
             n_dispatches=out["n_dispatches"], dispatch_counts=counts,
             median_ms={k: statistics.median(w) * 1e3 for k, w in walls.items()},
             wall_s_by_kind={k: sum(w) for k, w in walls.items()},
             prefix_cache=out.get("prefix_cache"), cache_hits=out["cache_hits"],
             cache_misses=out["cache_misses"], floor_measured_s=out["floor_measured_s"],
             routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
             launches=launches, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        # keep what the checks read, and drop the run's model before the next
        runs[pooled] = {"round_tokens": out["round_tokens"], "counts": counts,
                        "n_dispatches": out["n_dispatches"],
                        "prefix_cache": out.get("prefix_cache"), "pool": out["engine"].pool}
        del out

    plain, pooled = runs[False], runs[True]
    for r, (a, b) in enumerate(zip(plain["round_tokens"], pooled["round_tokens"])):
        if not np.array_equal(a, b):
            raise AssertionError(f"prefix round {r}: {int((a != b).any(axis=1).sum())} "
                                 "streams differ from the pool-less run's")
    n_req = len(PREFIX_LENS) * PREFIX_ROUNDS
    n_hits = n_req - PREFIX_ROUNDS
    pc, counts = pooled["prefix_cache"], pooled["counts"]
    if (pc["misses"], pc["hits"], pc["hit_tokens"]) != \
            (PREFIX_ROUNDS, n_hits, n_hits * PREFIX_SYSTEM):
        raise AssertionError(f"prefix pool stats {pc}: want {PREFIX_ROUNDS} misses, "
                             f"{n_hits} hits, {n_hits * PREFIX_SYSTEM} hit tokens")
    # a miss adds pool_insert to prefill + admit_slot; a hit is one
    # prefix_admit in place of both
    if plain["n_dispatches"] - pooled["n_dispatches"] != n_hits - PREFIX_ROUNDS or \
            counts["decode"] != plain["counts"]["decode"] or \
            (counts["prefill"], counts["pool_insert"], counts["prefix_admit"]) != \
            (PREFIX_ROUNDS, PREFIX_ROUNDS, n_hits):
        raise AssertionError(f"prefix dispatches: pooled {pooled['n_dispatches']} {counts}, "
                             f"pool-less {plain['n_dispatches']} {plain['counts']}")
    pool = pooled["pool"]
    if pool.owners():
        raise AssertionError(f"prefix pool: page tables still held by {pool.owners()}")
    pool.audit()

    # paged_decode_attention on the served arena, each layer's slice read in
    # place: lanes 0-3 on round 0's chain, 4-7 on round 1's; lanes 3 and 7
    # cut short by unmapped pages
    chains = [pool.bids_of(pool.match(r[0][:PREFIX_SYSTEM])) for r in rounds]
    n_pages = PREFIX_SYSTEM // PREFIX_BLOCK
    if any(len(c) != n_pages for c in chains):
        raise AssertionError(f"prefix pool chains {[len(c) for c in chains]}, want {n_pages}")
    lanes = len(PREFIX_LENS)
    tables = torch.tensor([chains[0]] * (lanes // 2) + [chains[1]] * (lanes // 2),
                          dtype=torch.int32)
    tables[lanes // 2 - 1, n_pages - 3:] = -1
    tables[lanes - 1, n_pages - 7:] = -1
    covered = (tables >= 0).sum(1).to(torch.int32) * PREFIX_BLOCK
    tables, current = tables.cuda().contiguous(), (covered - 1).cuda().contiguous()
    leaf = {name: next(a for loc, a in pool.arenas.items() if loc.rsplit("/", 1)[-1] == name)
            for name in ("k", "v", "pos")}
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((lanes, cfg.n_heads, cfg.d_head), generator=gen,
                    device="cuda").to(leaf["k"].dtype)      # bf16, as the cache
    spec = registry.get("paged_decode_attention")
    layers, failures, errs, paged = [], [], [], 0
    for layer in range(cfg.n_layers):
        i = {"q": q, "k_arena": leaf["k"][:, layer], "v_arena": leaf["v"][:, layer],
             "pos_arena": leaf["pos"][:, layer], "block_tables": tables, "current": current}
        layers.append(i)
        native.reset_launch_counts()
        got = paged_decode_attention(*(i[k] for k in PAGED_NAMES))
        torch.cuda.synchronize()
        paged += native.launch_counts()["paged_decode_attention"]
        err, ok = _compare(got, spec.run_oracle(i), spec.tol(q.dtype))
        errs.append(err)
        if not torch.equal(got, decode_on_gathered_pages(i)):
            failures.append(f"layer {layer}: differs from decode_attention(bk="
                            f"{PREFIX_BLOCK}) on the gathered pages")
        if not ok:
            failures.append(f"layer {layer}: max_abs_err {err} against its plain version")
    emit("prefix_arena", layers=cfg.n_layers, lanes=lanes, pages=n_pages,
         block_size=PREFIX_BLOCK, mapped_pages=(tables >= 0).sum(1).tolist(),
         max_abs_err=max(errs), bit_identical=not any("differs" in f for f in failures),
         launches=paged)
    if failures or paged != cfg.n_layers:
        raise AssertionError(f"paged decode on the served arena ({paged} launches): "
                             + "; ".join(failures))
    label = (f"served arena layer 0: B={lanes} H={cfg.n_heads} KV={cfg.n_kv_heads} "
             f"d={cfg.d_head} bs={PREFIX_BLOCK} nb={n_pages} {dtype_name(q.dtype)}")
    rec = check_case(spec, "main " + label, layers[0], failures, timer)
    if failures:
        raise AssertionError("; ".join(failures))
    return rec, paged


def serve_argv(cfg, rounds: int, form: str, schedule: str = "continuous") -> list[str]:
    return ["--arch", cfg.name, "--schedule", schedule, "--batch", "8",
            "--prompt-lens", SERVE_LENS, "--gen", str(SERVE_GEN),
            "--requests", str(rounds), "--seed", "0", "--device", "cuda",
            "--weight-form", form]


def check_rows(cfg) -> None:
    """Decode steps of full tinyllama-1.1b on 8 lanes, and on the same 8
    lanes twice over: the first 8 rows' logits must agree bit for bit, or a
    16-row tree verify window could pick other tokens than 8-row decode."""
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (8, 4), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2))

    def run(repeat: int) -> torch.Tensor:
        caches, rows = model.init_cache(8 * repeat, 64), []
        for step in range(tokens.shape[1]):
            tok = tokens[:, step:step + 1].repeat(repeat, 1).cuda()
            pos = torch.full((8 * repeat,), step, dtype=torch.int32, device="cuda")
            caches, lg = model.decode_step(params, caches, tok, pos)
            rows.append(lg[:8])
        return torch.stack(rows)

    a, b = run(1), run(2)
    err = float((a - b).abs().max())
    emit("rows", config=cfg.name, steps=tokens.shape[1], rows=[8, 16], max_abs_err=err,
         ok=err == 0.0)
    if err != 0.0:
        raise AssertionError(f"decode logits at 16 rows differ from 8 rows by {err}")
    del model, params


def serve_spec(cfg, draft: str, branches: int, want_tokens: np.ndarray) -> dict:
    """Full tinyllama-1.1b (fp16 form) through the speculative schedule with
    `draft` and `branches`; returns the launch counts of this run alone,
    after checking the tokens against the continuous run's, the routes, the
    acceptance, the dispatches per window and every kernel's launches:
    anemm once per matmul of every forward of either model (7 per layer plus
    the head), flash once per layer of either model per admission prefill,
    decode_attention once per layer of every decode forward of either model,
    specdec once per chain window and specdec_tree once per tree window."""
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    if draft == "early_exit":
        out = serve_early_exit(cfg, branches)
    else:
        out = serve.run(serve_argv(cfg, SERVE_ROUNDS, "fp16", "spec") + [
            "--draft", draft, "--draft-branches", str(branches),
            "--draft-depth", str(SPEC_DEPTH)])
    launches = native.launch_counts()
    engine = out["engine"]
    tag = f"spec {draft} x{branches}"
    if not np.array_equal(out["tokens"], want_tokens):
        bad = int((out["tokens"] != want_tokens).any(axis=1).sum())
        raise AssertionError(f"{tag}: {bad} of {len(want_tokens)} streams differ from the "
                             "continuous run's")
    backends = {b for _, b in out["routes"]}
    if backends != {"cuda"}:
        raise AssertionError(f"{tag} routes {out['routes']}: every route must be cuda")
    if draft == "self" and out["acceptance_rate"] != 1.0:
        raise AssertionError(f"{tag}: acceptance {out['acceptance_rate']}, want 1.0")
    if draft == "shrink" and not out["accepted"] < out["proposed"]:
        raise AssertionError(f"{tag}: accepted {out['accepted']} of {out['proposed']}")
    if draft == "early_exit" and not (0 < out["accepted"] < out["proposed"]
                                      and out["partial_accepts"] > 0
                                      and any(b > 0 for b in out["branch_wins"])):
        raise AssertionError(f"{tag}: accepted {out['accepted']} of {out['proposed']}, "
                             f"{out['partial_accepts']} partial lane-windows, branch wins "
                             f"{out['branch_wins']}: the mixed rollback or a branch > 0 "
                             "did not run")
    n_windows, kinds = out["n_windows"], out["windows_by_kind"]
    if out["verify_dispatches"] != n_windows or \
            out["draft_dispatches"] != n_windows - out["bonus_windows"]:
        raise AssertionError(f"{tag}: {n_windows} windows ({out['bonus_windows']} with K=0), "
                             f"{out['draft_dispatches']} draft and "
                             f"{out['verify_dispatches']} verify dispatches")
    recs = out["records"]
    n_prefill = sum(r.key == "spec_admit_slot" for r in recs)
    l_t, l_d = cfg.n_layers, engine.drafter.cfg.n_layers
    t_fwd = n_prefill + out["catchup_steps"] + out["verify_steps"]
    d_fwd = n_prefill + out["catchup_steps"] + out["draft_steps"]
    want = {k: 0 for k in launches}
    want.update({"anemm": (7 * l_t + 1) * t_fwd + (7 * l_d + 1) * d_fwd,
                 "flash": (l_t + l_d) * n_prefill,
                 "decode_attention": l_t * (t_fwd - n_prefill) + l_d * (d_fwd - n_prefill),
                 "specdec": kinds.get("chain", 0), "specdec_tree": kinds.get("tree", 0)})
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    walls = {"draft": [r.wall_s for r in recs if r.key in engine._draft_keys],
             "verify": [r.wall_s for r in recs if r.key in engine._verify_keys]}
    emit("spec", config=cfg.name, dtype=cfg.dtype, weight_form="fp16", drafter=draft,
         drafter_layers=l_d, draft_branches=branches, draft_depth=SPEC_DEPTH,
         lanes=len(want_tokens), prompt_lens=SERVE_LENS, gen=SERVE_GEN, rounds=SERVE_ROUNDS,
         tok_per_s=out["tok_per_s"], wall_s=out["wall_s"], tokens_match_continuous=True,
         acceptance_rate=out["acceptance_rate"], proposed=out["proposed"],
         accepted=out["accepted"], partial_accepts=out["partial_accepts"],
         branch_wins=out["branch_wins"], n_windows=n_windows, windows_by_kind=kinds,
         bonus_windows=out["bonus_windows"], draft_dispatches=out["draft_dispatches"],
         verify_dispatches=out["verify_dispatches"], emitted_tokens=out["emitted_tokens"],
         draft_steps=out["draft_steps"], verify_steps=out["verify_steps"],
         catchup_steps=out["catchup_steps"], prefills=n_prefill,
         target_forwards=t_fwd, drafter_forwards=d_fwd, n_dispatches=out["n_dispatches"],
         median_dispatch_ms={k: statistics.median(w) * 1e3 if w else None
                             for k, w in walls.items()},
         cache_hits=out["cache_hits"], cache_misses=out["cache_misses"],
         routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
         launches=launches, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def early_exit_drafter(model, params, cfg, n_layers: int) -> Drafter:
    """The target's own first `n_layers` layers, final norm and head: a
    drafter that agrees with the target often, and not always."""
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-exit{n_layers}", n_layers=n_layers)
    dparams = {**params, "layers": tree_map(lambda t: t[:n_layers], params["layers"])}
    return Drafter(build_model(dcfg, model.dispatcher, device=model.device), dparams, dcfg,
                   kind="early_exit", trained=True)


def serve_early_exit(cfg, branches: int) -> dict:
    """What `serve.run` does for the spec phase's argv (the same weights,
    prompts, lanes and rounds), with an early-exit drafter of L-1 layers in
    place of the CLI's drafters; returns the same keys the checks read."""
    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    lens = [int(x) for x in SERVE_LENS.split(",")]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in lens]
    cache = ProgramCache()
    stream = AsyncExecutionStream(cache, device="cuda")
    engine = SpeculativeSchedule(
        model, params, cfg, n_slots=len(lens), max_len=SERVE_MAX_LEN, stream=stream,
        drafter=early_exit_drafter(model, params, cfg, cfg.n_layers - 1),
        draft_depth=SPEC_DEPTH, draft_branches=branches)
    native.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(SERVE_ROUNDS):
        results = engine.run([Request(rid=r * len(lens) + i, prompt=p, max_new_tokens=SERVE_GEN)
                              for i, p in enumerate(prompts)])
    wall = time.perf_counter() - t0
    stream.close()
    n_requests = len(lens) * SERVE_ROUNDS
    return {"tokens": np.stack([r.tokens for r in results]), "engine": engine,
            "routes": model.dispatcher.census(), "records": list(stream.records),
            "wall_s": wall, "tok_per_s": SERVE_GEN * n_requests / wall,
            "cache_hits": cache.stats.hits, "cache_misses": cache.stats.misses,
            **engine.stats(n_requests)}


def profile_serve(label: str, argv: list[str]) -> None:
    """One round of a serve run (the CLI's `argv`) with the profiler
    tracing the device only: device time by kernel, and the device's busy
    share between the first and the last kernel of the round (its complement
    is the time the card sat idle waiting for the host). Tracing slows the
    host a little, so the profiled round's wall is reported beside it."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = serve.run(argv)
    kernels = [(e.time_range.start, e.time_range.end,
                e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
                .split("(")[0].split("<")[0])
               for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # the served round starts at the first of the port's kernels (before it:
    # weight init and the floor measurement)
    ours = [s for s, _, n in kernels
            if n.startswith(("repro::tile::matmul", "flash_fwd", "decode_fwd"))]
    first = min(ours) if ours else 0.0
    spans, by_name = [], {}
    for start, end, name in kernels:
        if start >= first:
            spans.append((start, end))
            by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - first
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", run=label, device_events=len(spans),
         profiled_wall_s=out["wall_s"], profiled_tok_per_s=out["tok_per_s"],
         device_busy_ms=busy / 1e3,
         device_busy_share=busy / window if spans else None,
         window_ms=window / 1e3 if spans else None,
         device_ms_by_kernel={k: v / 1e3 for k, v in top})


def check_parity_encdec() -> None:
    """whisper-small smoke, same weights and frames, on the card (kernels)
    and on the CPU (plain versions): prefill (frames through the conv stem
    and the encoder, the cross K/V built) and three teacher-forced decode
    steps must agree at 4x the `anemm` tolerance, in fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(configs.get_smoke(ENCODER_ARCH), dtype=dtype)
        cpu = build_model(cfg, device="cpu")
        gpu = build_model(cfg, device="cuda")
        params_cpu = cpu.init(torch.Generator().manual_seed(0))
        params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
        rtol, atol = (4 * x for x in registry.get("anemm").tol(gpu.dtype))
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32, generator=gen)
        frames = torch.randn((2,) + cfg.frame_shape, generator=gen).to(gpu.dtype)
        c_cpu, lg_cpu = cpu.prefill(params_cpu, {"tokens": tokens, "frames": frames})
        c_gpu, lg_gpu = gpu.prefill(params_gpu, {"tokens": tokens.cuda(),
                                                 "frames": frames.cuda()})
        errs = [float((lg_gpu.cpu() - lg_cpu).abs().max())]
        torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=rtol, atol=atol)
        c_cpu = merge_prefill_caches(cpu.init_cache(2, 24), c_cpu)
        c_gpu = merge_prefill_caches(gpu.init_cache(2, 24), c_gpu)
        tok = lg_cpu[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
        for i in range(3):
            pos = torch.full((2,), 16 + i, dtype=torch.int32)
            c_cpu, d_cpu = cpu.decode_step(params_cpu, c_cpu, tok, pos)
            c_gpu, d_gpu = gpu.decode_step(params_gpu, c_gpu, tok.cuda(), pos.cuda())
            if not bool(torch.isfinite(d_gpu).all()):
                raise AssertionError(f"{cfg.name} {dtype}: non-finite decode logits")
            errs.append(float((d_gpu.cpu() - d_cpu).abs().max()))
            torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=rtol, atol=atol)
            tok = d_cpu[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
        routes = set(gpu.dispatcher.census())
        want = {(k, "cuda") for k in ("anemm", "flash", "decode_attention", "conv2d")}
        if routes != want:
            raise AssertionError(f"{cfg.name} {dtype}: card routes {routes}")
        emit("parity", config=cfg.name, weight_form="fp16", dtype=dtype,
             max_abs_err=max(errs), tol=[rtol, atol], ok=True)


def encoder_argv(rounds: int) -> list[str]:
    return ["--arch", ENCODER_ARCH, "--schedule", "continuous", "--batch", "8",
            "--prompt-lens", ENCODER_LENS, "--gen", str(SERVE_GEN), "--requests", str(rounds),
            "--seed", "0", "--device", "cuda"]


def serve_encoder(timer) -> dict:
    """Full whisper-small through the serve CLI's entry point, then the stem
    fused against unfused and the pools; returns the launches the kernels
    line reports for conv2d, act_lut, avg_pool and max_pool. Checks: every
    route cuda; per admission (prefill) conv2d 2, anemm 6 per encoder layer
    + 2 (cross K/V) and 8 per decoder layer + the head, flash one per
    encoder layer and two per decoder layer; per decode step anemm 8 per
    decoder layer + the head, flash one (cross) and decode_attention one
    (self) per decoder layer; act_lut 0 (fused)."""
    cfg = configs.get_config(ENCODER_ARCH)
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    out = serve.run(encoder_argv(SERVE_ROUNDS))
    launches = native.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    tokens = out["tokens"]
    n_lanes = len(ENCODER_LENS.split(","))
    if tokens.shape != (n_lanes, SERVE_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"encoder serve tokens: shape {tokens.shape}, range "
                             f"[{tokens.min()}, {tokens.max()}]")
    if {b for _, b in out["routes"]} != {"cuda"}:
        raise AssertionError(f"encoder serve routes {out['routes']}: every route must be cuda")
    recs = out["records"]
    decode_key = recs[-1].key
    by_kind: dict[str, list[float]] = {}
    for r in recs:
        kind = r.key if r.key in NAMED_RECORDS else \
            "decode" if r.key == decode_key else "prefill"
        by_kind.setdefault(kind, []).append(r.wall_s)
    n_prefill, n_decode = len(by_kind["prefill"]), len(by_kind["decode"])
    l_e, l_d = cfg.n_encoder_layers, cfg.n_layers
    want = {k: 0 for k in launches}
    want.update({"conv2d": 2 * n_prefill,
                 "anemm": (6 * l_e + 2 * l_d + 8 * l_d + 1) * n_prefill
                 + (8 * l_d + 1) * n_decode,
                 "flash": (l_e + 2 * l_d) * n_prefill + l_d * n_decode,
                 "decode_attention": l_d * n_decode})
    if launches != want:
        raise AssertionError(f"encoder serve launches {launches}, expected {want}")
    dispatches = {k: {"n": len(w), "wall_s": sum(w), "median_ms": statistics.median(w) * 1e3}
                  for k, w in by_kind.items()}
    emit("encoder_serve", config=cfg.name, dtype=cfg.dtype, n_encoder_layers=l_e,
         n_layers=l_d, frames=list(cfg.frame_shape), lanes=n_lanes, prompt_lens=ENCODER_LENS,
         gen=SERVE_GEN, rounds=SERVE_ROUNDS, tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
         n_dispatches=out["n_dispatches"], dispatches=dispatches,
         cache_hits=out["cache_hits"], cache_misses=out["cache_misses"],
         floor_measured_s=out["floor_measured_s"], dispatch_wall_s=out["dispatch_wall_s"],
         work_s=out["work_s"], routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
         launches=launches, peak_memory_gb=peak_gb)

    # the stem fused and unfused: each request's frames encoded alone (as an
    # admission encodes them), same bits, 2 more act_lut launches each
    engine = out["engine"]
    model, params = engine.model, engine.params
    rng = np.random.default_rng(0)
    for n in (int(x) for x in ENCODER_LENS.split(",")):
        rng.integers(0, cfg.vocab, size=(n,))      # the CLI's prompt draws
    frames = [torch.from_numpy(np.asarray(rng.normal(size=cfg.frame_shape), np.float32))
              .to(device="cuda", dtype=model.dtype)[None] for _ in range(n_lanes)]
    encoded, counts, ms = {}, {}, {}
    for fused in (True, False):
        with dsp.use_dispatcher(model.dispatcher), dsp.fuse_epilogues(fused):
            native.reset_launch_counts()
            encoded[fused] = [encdec.encode(cfg, params["encdec"], f) for f in frames]
            torch.cuda.synchronize()
            counts[fused] = native.launch_counts()
            ms[fused] = timer.eager_ms(lambda: encdec.encode(cfg, params["encdec"], frames[0]),
                                       reps=5)
    same = all(torch.equal(a, b) for a, b in zip(encoded[True], encoded[False]))
    extra = {k: counts[False][k] - counts[True][k] for k in counts[True]}
    if not same:
        raise AssertionError("encoder: fused and unfused stems give different encoder outputs")
    if extra != {k: (2 * n_lanes if k == "act_lut" else 0) for k in extra} or \
            counts[True]["conv2d"] != 2 * n_lanes:
        raise AssertionError(f"encoder: fused launches {counts[True]}, unfused {counts[False]}")
    finite = all(bool(torch.isfinite(e).all()) for e in encoded[True])
    if not finite:
        raise AssertionError("encoder: non-finite encoder output")
    emit("encoder_stem", requests=n_lanes, bit_identical=same,
         launches_fused=counts[True], launches_unfused=counts[False],
         encode_ms_fused=ms[True], encode_ms_unfused=ms[False])

    # the pools, routed once each at the pyramid's shapes
    disp = KernelDispatcher()
    gen = torch.Generator(device="cuda").manual_seed(3)
    pooled = {}
    native.reset_launch_counts()
    with dsp.use_dispatcher(disp):
        for name, (shape, window, stride, pad) in POOL_SHAPES.items():
            x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            pooled[name] = getattr(dsp, name)(x, window=window, stride=stride, padding=pad)
    torch.cuda.synchronize()
    pool_launches = native.launch_counts()
    if set(disp.census()) != {("avg_pool", "cuda"), ("max_pool", "cuda")} or \
            {k: pool_launches[k] for k in POOL_SHAPES} != {"avg_pool": 1, "max_pool": 1}:
        raise AssertionError(f"pools: routes {disp.census()}, launches {pool_launches}")
    emit("pools", routes={f"{k}/{b}": n for (k, b), n in disp.census().items()},
         shapes={k: list(v.shape) for k, v in pooled.items()})

    profile_serve(ENCODER_ARCH, encoder_argv(1))
    return {"conv2d": launches["conv2d"], "act_lut": counts[False]["act_lut"],
            "avg_pool": pool_launches["avg_pool"], "max_pool": pool_launches["max_pool"]}


if __name__ == "__main__":
    sys.exit(main())
