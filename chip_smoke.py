#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card. It imports the
port (`src/repro_torch`) and nothing of JAX, and runs these phases in order,
printing one JSON line for each:

  1. device  — the card, its power limit, the torch and CUDA versions;
  2. build   — every kernel built from `src/repro_torch/csrc/` with nvcc for
               sm_90a (one nvcc per source, all started together), with each
               kernel's registers and spills from ptxas;
  3. kernels — each kernel held against its plain PyTorch version on the
               card, on every registry case and at the main-path shapes of
               full tinyllama-1.1b and whisper-small (the stem's two convs
               with their fused GELU, the GELU table over a stem output, the
               encoder's non-causal attention and a decode step's
               one-query cross-attention, on contiguous tensors and on the
               strided views the flash route passes) and of a pooling
               pyramid, at the registry tolerance; flash non-causal, with a
               window, GQA and at short queries (its split-KV path) at head
               dims 16 to 256 in every dtype, and at the wide heads of the
               archs still to port (d 128: 32/8 heads, d 256: 16/1, a
               causal 512-token prefill and a 4,096-token one under a
               2,048-token window); flash's 1,500-key shapes and a merge of
               four key splits with peaked scores (q drawn at 4x), held
               also to 4 roundings of the largest output; the short-query
               plan timed beside other split lengths and one split, on 1
               and 8 lanes at d 64, 128 and 256; the decode plan the same
               way at 544 and 4,096 slots and on the served arena's shape
               (`decode_plans`); decode on 8 lanes bit-identical to the
               first 8 of 16 and to a rerun at 544 and 4,096 slots over
               several splits (`decode_rows`); decode with a lane that has
               no valid slot, and at whisper-small's decoder shape (12/12
               heads, its 160-slot cache); the verify kernels with equal
               maxima on both sides of a column-slice boundary and with
               NaN in one or two slices; `anemm` (fp32, bf16, fp16),
               `sparse` and `palette` (fp32, bf16) row-invariant: the first
               rows of a 512-row activation bit-identical at 1 to 512 rows,
               at every main-path (K, N) and two ragged ones; `conv2d` (fp32,
               bf16, fp16) at both stem convs: the first images of a
               4-image call bit-identical in calls of 1 to 4 images; the
               three matmuls' launch plans (chunks over a cluster, or one
               block over all chunks) timed side by side at the projections
               on 8 to 512 rows; each stem conv timed fused, without its
               epilogue and as `anemm` on its implicit GEMM's operands; flash
               bit-identical across
               reruns and for 8 lanes against the first 8 of 16; decode and
               the paged decode at d 128 and 256; `anemm`'s fused `epilogue=` against
               its plain version and bit for bit against anemm-then-act_lut;
               `paged_decode_attention` on every registry case, at the wide
               heads and with a window, bit for bit against
               `decode_attention(bk=bs)` on the gathered pages; `act_lut`
               (every table, the stem's shape) and both pools (the
               pyramid's shapes, C = 5, every registry case, each in three
               dtypes; NaN inputs) bit for bit against their plain versions
               (`exact_bits`); the pool plan beside other tiles, fold widths
               and chunks (`pool_plans`); the timer's floor, an empty CUDA
               graph, and a copy of the act_lut and pool inputs' bytes, with
               the L2 flushed by a write, by a read and not at all
               (`timer_floor`); the median
               device time (CUDA-graph replay between CUDA events, L2
               flushed) of the kernel, its plain version and one PyTorch
               library call computing the same function, beside the bound
               (bytes at the memory rate or operations at the peak rate,
               whichever is larger), and the kernel's eager per-call time;
               the float16 decode and paged decode (every registry case,
               and timed at ane-paper's shape: 8 lanes, 8/8 heads, d 128,
               544 slots; decode's 8 of 16 lanes and reruns bit for bit);
               the public wrappers `PaletteLinear` and `SparseLinear`, one
               call each on a gate/up weight packed on the card, one launch
               of their kernel against its plain version (`packed_linear`);
  4. parity  — the smoke model's prefill and decode logits on the card
               (kernels) against the same weights on the CPU (plain versions),
               dense and packed (int4_palette, sparse), fp32 and bf16; the
               same for whisper-small smoke (frames through the conv stem),
               and for every arch of the archs phase at smoke size, fp32 and
               its own dtype (deepseek-v3-671b's MLA and MTP module too);
  5. rows    — full tinyllama-1.1b decode steps on 8 lanes and on the same
               8 lanes twice over (16 rows): the first 8 rows' logits must be
               equal bit for bit (a tree verify window runs 16 rows where
               decode runs 8, and the spec streams must equal the continuous
               ones); the same for full granite-8b, chameleon-34b (8
               layers: QK-norm), dbrx-132b (4 layers: the MoE router and
               combine), recurrentgemma-9b, mamba2-1.3b (the recurrent
               states) and deepseek-v3-671b (4 layers: MLA's latent norms
               and absorbed decode, computed lane by lane);
  6. sampling — jax's threefry chain (`core.prng`) on the card against
               the same code on the CPU: the known key data of PRNGKey(0)
               -> fold_in(3) -> fold_in(17), the (rid, pos) keys, 32-bit
               bits and uniforms of 8 rows of 32000 bit for bit, gumbel
               within rtol = atol = 1e-6, categorical draws and the
               `TokenSampler`'s picks over (8, 32000) fp32 rows equal;
  7. graphs  — every program kind the serves capture into CUDA graphs
               (`core.dispatch.GraphProgram`), at full size: tinyllama-1.1b
               prefill at buckets 8 and 64 and the 8-lane decode step; the
               spec draft and verify at K = 1 and 4, the tree draft and
               verify (K = 4, two branches), the joint catch-up and the
               joint prefill; the categorical spec draft, verify and tree
               draft (the threefry and gumbel ops inside the graphs); the
               slo schedule's fused step, greedy and categorical; the
               chunk program (C = 64, a random lane's staging row);
               whisper-small's prefill and decode. Each is
               called once (eager run, then the capture) and replayed twice
               with new per-call inputs; every replay's outputs, the caches
               it writes and its launch counts must equal an eager call of
               the same function on the same inputs, bit for bit; no graph
               may hold a host-to-device copy (each dumped as DOT);
  8. serve   — full-width, full-depth tinyllama-1.1b (random weights from a
               seed, bf16) served by the serve CLI's entry point through the
               continuous schedule, once per weight form: fp16 (dense, anemm),
               int4_palette (palette) and sparse (sparse), each packed on the
               card after init. Each run's launch counts are zeroed just
               before and read just after; every route must be cuda and each
               of the run's kernels must have launched its expected count.
               Every program is captured on its first dispatch and replayed
               after: captures = misses, no recapture, replays = the program
               dispatches less the captures (this and the capture seconds,
               `compile_s`, out of tok/s, and the peak memory reported for
               every serve phase);
  9. profile — each serve once more (one round), then its second round
               under torch.profiler, every program a replay: device time by
               kernel, the device's busy share, and the trace's instances of
               each of the port's kernels, which must equal the launches the
               host counted in that round (the tracer drops a record now and
               then: such a round is traced again, up to 10 rounds);
  10. prefix — the same model (fp16 form) served twice by the serve CLI's
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
  11. spec   — the same model and requests (fp16 form) through the
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
  12. slo    — the same model and requests (fp16 form) through `--schedule
               slo` (pipelined decode windows, the draw inside each step's
               graph): greedy streams equal to the continuous run's, a
               profiled round, then `--slo-ms 1e-3`, which defers every
               admission into a busy engine, with the same streams; then
               `--sampling categorical` through the continuous, slo and
               spec (self chain, shrink 2-branch tree) schedules, whose
               streams must all be equal; exact launches, captures = misses
               and no recapture in every serve. Then `chunked`: a 512-token
               prompt arriving at step 4 while 7 lanes decode, with and
               without `--prefill-chunk 64`, continuous and slo: one chunk
               graph whichever lane it stages, decode steps between the long
               prompt's chunks, exact launches, the running lanes' gaps
               between tokens from the long prompt's arrival on; chunked
               streams equal to the unchunked ones except where one parts
               at a near tie (replayed alone on both paths: each path's
               margin between the two picks within the two logit rows'
               largest difference; the prompt caches come from other
               kernels on the two paths);
  13. encoder — full whisper-small (12 + 12 layers, d 768, random bf16
               weights from a seed) served by the serve CLI's entry point
               through the continuous schedule: per-request log-mel frames
               (3000, 80) through the two-conv stem (conv2d with the GELU
               fused), the encoder, the cross K/V built at prefill and
               resident in decode. Every route must be cuda and each
               kernel's launches must equal what the run's admissions and
               decode steps imply; then each request's frames encoded with
               the stem fused and unfused (conv2d, then act_lut), which must
               give the same bits with exactly 2 more act_lut launches per
               request; the pools routed once at the pyramid shapes; a
               profiled second round as in phase 9; and the same requests
               through `--schedule slo`, whose streams must equal the
               continuous run's;
  14. encoder_forms — the same whisper-small under int4_palette and sparse
               (packed on the card): the encoder's and decoder's attention,
               the MLPs and the head through the form's kernel, the stem
               dense; exact launches, `pack_s`, tok/s;
  15. encoder_spec — the same through `--schedule spec`, drafters self
               and shrink (one encoder and one decoder layer): streams equal
               to the continuous run's, two dispatches a window, exact
               launches;
  16. archs  — every config this slice adds, served through the serve
               CLI's entry point (continuous, 8 lanes, the serve phase's
               prompts, 32 tokens, one round; random weights from the seed):
               ane-paper (float16), phi4-mini-3.8b, granite-8b and the
               recurrent archs whole, command-r-35b and chameleon-34b at 8
               layers, dbrx-132b and deepseek-v3-671b at 4 (full widths;
               each cut and its reason on the line, as `reduced`;
               deepseek with its MTP module, which no served program
               reads): every route cuda, captures = misses, each kernel's
               launches exactly as the config implies (anemm 7 a layer and
               the head for a dense arch, 4 + 3 per expert bank for dbrx's
               MoE layers; deepseek 797 a decode step, 801 a prefill), tok/s,
               the decode step's median, the digest, the peak memory;
  17. recurrent — recurrentgemma-9b and mamba2-1.3b at 8 layers (full
               width; the cut and its reason on each record, as `reduced`)
               through spec (shrink, chain and two branches), chunked
               prefill and (the hybrid) the prefix pool, each against a
               continuous serve at the same depth; then the long-window
               run: recurrentgemma whole on 2 lanes, prompts of 2,304 and
               3,000, its rings' positions checked at each lane's finish;
  18. mla    — deepseek-v3-671b at 4 layers without its MTP module: a
               continuous serve of 8 prompts of one prefill bucket, whose
               params the port's `CheckpointManager` writes in the
               reference's layout (under build/) and served back through `--ckpt` from
               another seed's init (the same streams); spec with the shrink
               drafter, chain and two branches (the continuous streams,
               exact launches); `--prefill-chunk 64` (the archs phase's
               streams, or parted at near ties); the prefix pool (pooled =
               pool-less); and int4_palette (`wq_b` / `wkv_b` on anemm,
               the rest on palette, launches exact);
  19. train  — the gradients of the three kernels with a VJP row (anemm,
               flash, conv2d) through their CUDA forwards against autograd
               through their plain versions, at each row's first case in
               bf16 and fp32 and its tolerance; full tinyllama-1.1b (22
               layers, random weights from seed 0) trained by the training
               CLI's entry point for 30 steps of 8 x 128 tokens with a
               checkpoint at the end: every route cuda, `anemm` and `flash`
               launched each step (the recompute of the full remat
               included), the loss falling, step 0's loss within 2e-3 of the
               same params' loss through the plain versions on the card;
               one step traced (device time by kernel, busy share, traced
               instances = launches); then the resume check at full width
               and 2 layers: 10 steps straight against 5, a crash just
               after the step-5 checkpoint, the supervisor's restart from it
               and 5 more, the logged losses and every param and moment
               compared (bit for bit expected; any leaf whose gradient is
               not the same twice is named);
  20. distill — `launch/distill.py` through its CLI entry point at full
               tinyllama-1.1b with the reference's defaults but lr 3e-4
               and 128 tokens (at the defaults the teacher learns no
               motif): a 22-layer teacher trained 150 steps and a
               one-layer student (`draft_of`) distilled 300 steps against
               its logits (8 x 128 tokens), checkpoints under build/. Step
               0 of the distillation through the kernels against the plain
               versions on the card (the teacher's logits, each token's KL
               and CE, every student gradient leaf) and the loss's terms
               against torch's own KL and CE at T 1 and 2; both runs whole
               (every step taken once, nothing restarted, the teacher's
               loss falling, every route cuda, every launch the steps
               imply); on held-out prompts cut two tokens into a motif the
               teacher completes the motifs and the distilled student's
               agreement (the reference's rollout and on the motif tails)
               is above the same student's at init; `load_teacher`
               restoring the teacher bit for bit and the student's
               metadata the reference's; then the teacher served through
               `--ckpt` on 8 such prompts, continuous (more than one
               distinct token) and as the target of `--schedule spec
               --draft shrink --draft-ckpt` at branches 1 and 2, with the
               distilled student, with the random-init one (its acceptance
               must be lower) and with the student packed as int4_palette
               (the drafter's matmuls on palette): every spec stream equal
               to the continuous one, exact launches.

Then a `script` line with the whole run's seconds, a `kernels` line with
every kernel's numbers, the card's name and power limit as nvidia-smi
reports them, and last `{"ok": true, "device": ...}`.

    python3 chip_smoke.py --turn LABEL

runs, after the device and build phases, only one turn of a comparison of
two checkouts on one card (`compare_turn`: matmul, stem-conv, decode,
paged-decode, verify, act_lut and pool times and output digests, the
timer's floor, the fp16, sparse and int4 serves with a profiled round each,
two spec serves, the pooled prefix serve and the whisper-small serve with a
profiled round), its records tagged LABEL. Copy this file into the other checkout and run it
from each in turns (parent, change, change, parent).
Any failure raises and the exit code is not 0; no phase is skipped. Without a
CUDA device it exits with code 1 before printing any result; alone in a
directory, without the port beside it, it fails at the import.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port itself: alone in a directory, the script stops here
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import dispatch, hal, prng  # noqa: E402
from repro_torch.core.numerics import _LUT_SPECS  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.core.dispatch import (AsyncExecutionStream, KernelDispatcher,  # noqa: E402
                                       ProgramCache, dtype_name)
from repro_torch.kernels import common, native, registry  # noqa: E402
from repro_torch.kernels.act_lut.ops import lut_activation, table_operands  # noqa: E402
from repro_torch.kernels.act_lut.ref import act_lut_ref  # noqa: E402
from repro_torch.kernels.anemm.anemm import anemm  # noqa: E402
from repro_torch.kernels.anemm.ref import anemm_ref  # noqa: E402
from repro_torch.kernels.conv import pool as pool_module  # noqa: E402  (the module)
from repro_torch.kernels.conv.ref import out_extent  # noqa: E402
from repro_torch.kernels.flash import decode_attention as da  # noqa: E402  (the module)
from repro_torch.kernels.flash import flash_attention as fa  # noqa: E402  (the module)
from repro_torch.kernels.flash.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref, gather_pages, gathered_positions,
    paged_decode_attention, paged_decode_attention_ref)
from repro_torch.kernels.flash.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS  # noqa: E402
from repro_torch.kernels.flash.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.specdec import specdec as sd  # noqa: E402  (the module)
from repro_torch.kernels.palette.ops import PaletteLinear  # noqa: E402
from repro_torch.kernels.palette.ref import palette_matmul_ref  # noqa: E402
from repro_torch.kernels.sparse.ops import SparseLinear  # noqa: E402
from repro_torch.kernels.sparse.ref import sparse_matmul_ref  # noqa: E402
from repro_torch.launch import distill, serve, train  # noqa: E402
from repro_torch.launch.scheduler import (ChunkConfig, ContinuousSchedule,  # noqa: E402
                                          Request, ServeConfig, SLOSchedule, TokenSampler,
                                          build_scheduler, merge_prefill_caches)
from repro_torch.launch.speculative import Drafter, SpeculativeSchedule, draft_of  # noqa: E402
from repro_torch.models import dispatched as dsp  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compression import compress_model_params  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

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
# the encoder_forms phase's weight forms and the encoder_spec phase's drafters
ENCODER_FORMS = ("int4_palette", "sparse")
ENCODER_DRAFTS = ("self", "shrink")

# the archs phase: each config of this slice served through the CLI's entry
# point (the serve phase's 8 lanes and prompts, one round), with the layers
# kept where the whole model does not fit the card beside the serve's graphs
# (None: all of them) and why
ARCH_RUNS = (("ane-paper", None), ("phi4-mini-3.8b", None), ("granite-8b", None),
             ("command-r-35b", 8), ("chameleon-34b", 8), ("dbrx-132b", 4),
             ("recurrentgemma-9b", None), ("mamba2-1.3b", None), ("deepseek-v3-671b", 4))
ARCH_CUTS = {
    "command-r-35b": "40 layers are ~60.6 GB bf16, and every captured program holds "
                     "its own 8.4 GB fp32 copy of the tied 256,000 x 8,192 head",
    "chameleon-34b": "48 layers are ~68.6 GB bf16",
    "dbrx-132b": "~6.5 GB of bf16 weights a layer: 16 expert banks, each read every step",
    "deepseek-v3-671b": "~683 B parameters (1.37 TB bf16); an MoE layer is ~11.5 B (256 "
                        "expert banks of 7,168 x 2,048 x 3, each read every step), a dense "
                        "one ~0.58 B: the 3 dense layers and the first MoE layer, with the "
                        "MTP module (another MoE layer), are 26.7 B (~53.4 GB)",
}
# the rows phase beyond tinyllama: per-row arithmetic the slices add (the
# 128-wide heads, QK-norm, the MoE router and combine, the recurrent states,
# MLA's latent norms and absorbed decode)
ROWS_ARCHS = ("granite-8b", "chameleon-34b", "dbrx-132b", "recurrentgemma-9b", "mamba2-1.3b",
              "deepseek-v3-671b")
# the mla phase: deepseek-v3-671b at the archs phase's depth without the MTP
# module (no served program reads it, so the streams are the archs phase's),
# served through spec (chain and tree), chunked prefill, the prefix pool, an
# int4_palette form and --ckpt. Its spec, int4 and checkpoint serves take
# prompts of one prefill bucket (64): every captured program holds a pool of
# its own, and one bucket keeps the phase's programs and time few
MLA_ARCH = "deepseek-v3-671b"
MLA_LENS = "64,72,80,88,96,104,112,120"
# the recurrent families (the RG-LRU hybrid with sliding-window MQA, the
# SSD): the archs phase serves each whole, the recurrent phase serves each
# at RECURRENT_LAYERS through spec (chain and tree), chunked prefill and
# (the hybrid) the prefix pool, and the long-window run rolls and wraps the
# whole hybrid's 2,048-slot rings
RECURRENT_ARCHS = ("recurrentgemma-9b", "mamba2-1.3b")
# the recurrent phase's depth: the hybrid's two whole periods and its two
# trailing layers (the whole is 12 periods and 2), the SSD's first 8 layers
RECURRENT_LAYERS = {"recurrentgemma-9b": 8, "mamba2-1.3b": 8}
RECURRENT_CUT = ("the spec rollback, the chunk's staged state and the pool's anchors are per "
                 "layer, the same in every layer of a kind; the archs phase and the "
                 "long-window run serve the config whole; whole, the phase took ~180 s of "
                 "the script's 1,200 s")
# recurrentgemma's spec runs take prompts of one prefill bucket (64): every
# captured program keeps a 4.2 GB fp32 copy of the 256,000 x 4,096 head in
# its private pool (target and drafter alike), and the serve phase's five
# buckets would take the card past its 80 GB with the ~15 programs of a spec
# serve (ROADMAP B.7); their continuous streams come from a serve of the
# same prompts
RECURRENT_SPEC_LENS = {"recurrentgemma-9b": "64,72,80,88,96,104,112,120",
                       "mamba2-1.3b": SERVE_LENS}
LONG_ARCH = "recurrentgemma-9b"
LONG_LENS = "2304,3000"
LONG_GEN = 64
# flash cases the registry rows leave off, at every head dim the kernel
# takes: (label, (B, H, KVH, Sq, Skv), masks); Sq <= 16 runs the bf16 /
# fp16 short-query (split-KV) path
FLASH_EXTRA = (("gqa", (2, 4, 2, 128, 128), {}),
               ("non-causal", (2, 4, 2, 128, 128), {"causal": False}),
               ("window=24", (2, 4, 2, 128, 128), {"window": 24}),
               ("one query", (2, 4, 2, 1, 77), {"causal": False}),
               ("one query causal", (2, 4, 1, 1, 77), {}),
               ("16 queries", (2, 4, 2, 16, 1500), {"causal": False}),
               ("16 queries window=7", (1, 4, 4, 16, 300), {"window": 7}))
# the wide heads of the archs still to port: head dim -> (query heads, kv
# heads); granite-style 32/8 at 128, recurrentgemma's 16/1 at 256
WIDE_HEADS = {128: (32, 8), 256: (16, 1)}
# the pooling pyramid of the kernels phase: a 3x3 stride-2 SAME max pool
# (a ResNet stem's) and a 7x7 global average pool (its head's), bf16
POOL_SHAPES = {"max_pool": ((8, 112, 112, 64), (3, 3), (2, 2), "SAME"),
               "avg_pool": ((8, 7, 7, 2048), (7, 7), (7, 7), "VALID")}
# every activation the engine's tables cover (act_lut's exact-bits check)
LUT_NAMES = tuple(_LUT_SPECS)

# the prefix phase: per round one shared system prompt, then unique tails;
# every prompt's bucket is 256 and the L-1 match cap still reaches it
PREFIX_SYSTEM = 256
PREFIX_LENS = (264, 280, 300, 320, 360, 400, 450, 504)
PREFIX_ROUNDS = 2
PREFIX_BLOCK = 16
PREFIX_BLOCKS = 64
PREFIX_NAMED = ("admit_slot", "reset_slot", "prefix_admit", "pool_insert")
# the slo phase: an SLO low enough that every admission into a busy engine
# waits (the gate's own floor term alone exceeds it)
SLO_TIGHT_MS = 1e-3
# the chunked phase: a 512-token prompt arriving at step CHUNK_ARRIVAL while
# 7 lanes (the serve's first 7 prompts, CHUNK_RUNNING_GEN tokens each) decode
CHUNK_SIZE = 64
CHUNK_LONG = 512
CHUNK_ARRIVAL = 4
CHUNK_RUNNING_GEN = 64
# the sampling phase: rows of tinyllama's vocab
SAMPLING_ROWS, SAMPLING_VOCAB = 8, 32000
GUMBEL_TOL = 1e-6

# a peaked flash check (q drawn at 4x, outputs O(1)) is also held to this many
# roundings of its dtype at the largest output, beside the registry tolerance
PEAK_ROUNDINGS = 4
# the short-query plans timed beside the one flash_plan takes: key splits of
# this many keys (and one split, without the combine pass)
SPLIT_LENS = (128, 256, 512)

# the decode plans timed beside the one decode_plan takes: splits of this
# many slots where they make 2 to MAX_SPLITS splits (and one split, without
# the merge), at these cache lengths (the serve phase's and a long one) and
# head dims (query heads / kv heads: tinyllama's at d 64, WIDE_HEADS beyond)
DECODE_SPLIT_SLOTS = (64, 128, 256, 512, 1024, 2048)
DECODE_LENS = (SERVE_MAX_LEN, 4096)
DECODE_HEADS = {64: (32, 4), **WIDE_HEADS}

# the row-invariance check of anemm and sparse: activation rows, and ragged
# (K, N) beside the main-path shapes (sparse's K rounded up to a multiple of
# 16); the launch plans of the streaming loop timed at these rows
INVARIANCE_ROWS = (1, 8, 16, 40, 80, 264, 512)
RAGGED_SHAPES = ((257, 130), (300, 100))
PLAN_ROWS = (8, 40, 80, 512)

# the train phase: tinyllama-1.1b at full width and depth through the
# training CLI, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens; step 0
# through the kernels against the plain versions on the card: the loss
# within TRAIN_LOSS_RTOL, each token's loss within TRAIN_TOKEN_ATOL, each
# gradient leaf within TRAIN_GRAD_RTOL of its largest |value|, each limit
# about 2.5x the gap measured on an H100 (6.4e-5 relative, 0.063 on a
# per-token loss near 10.9, 0.023 at the worst of 12 leaves; the inputs are
# seeded and the kernels deterministic, so the gap repeats); the resume
# check at k = TRAIN_RESUME_K steps and TRAIN_RESUME_LAYERS layers, its
# logged losses within TRAIN_RESUME_TOL
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 30, 8, 128
TRAIN_LOSS_RTOL, TRAIN_TOKEN_ATOL, TRAIN_GRAD_RTOL = 1.6e-4, 0.16, 0.06
TRAIN_RESUME_K, TRAIN_RESUME_LAYERS = 5, 2
TRAIN_RESUME_TOL = 1e-5

# the distill phase: launch/distill.py through its CLI entry point at full
# tinyllama-1.1b (the teacher its 22 layers, the student `draft_of`'s one)
# with the reference's DEFAULTS (150 teacher steps, 300 student steps of 8
# sequences, kl_weight 0.75, T 1) but for DISTILL_FLAGS: lr 3e-4 and 128
# tokens. At the defaults' lr 3e-3 and 64 tokens, and at lr 1e-3 or 3e-4
# with 64, the teacher learns no motif in 150 steps (none of the motif
# tails below; loss 5.2-5.7, the unigram's); at lr 3e-4 with 128 tokens,
# or lr 1e-3 over 300 steps, it completes every tail (loss 3.2-3.5). Step
# 0 of the distillation through the kernels against the plain versions on
# the card: the teacher's logits within DISTILL_LOGIT_RTOL of their largest
# |value|, each token's KL and CE within DISTILL_KL_ATOL and
# DISTILL_CE_ATOL, each student gradient leaf within DISTILL_GRAD_RTOL of
# its largest |value|, and `distill_terms` against torch's own KL and CE
# within DISTILL_FORMULA_RTOL. Each limit is about 2.5x the gap measured on
# an H100 with this recipe (3.6e-3 of the largest logit, 0.018 on a
# per-token KL near 7.6, 0.025 on a per-token CE near 10.9, 0.011 at the
# worst of 12 leaves; the inputs are seeded and the kernels deterministic,
# so the gaps repeat); the formula's gaps were 0, 0 and 6.7e-8, and a KL
# written without T^2, with the student's logits not divided by T, or
# reversed moves one of them to 0.37-0.77. On DISTILL_PROMPTS held-out
# prompts of DISTILL_PROMPT_LEN tokens cut two tokens into a motif
# (`motif_prompts`), the teacher's rollout must complete at least
# DISTILL_TAIL_HITS of the motif tails, with its most frequent token at
# most DISTILL_TOP_SHARE of the stream (measured 1.0 and 0.5: a tail is 6
# of 12 steps), and the distilled student's agreement (the reference's
# `rollout_agreement`, and on the tails) at least DISTILL_AGREE_MARGIN above
# the same student's at its init (measured 1.0 against 0.0 for both)
DISTILL_ARCH = "tinyllama-1.1b"
DISTILL_FLAGS = {"lr": 3e-4, "seq": 128}
DISTILL_LOGIT_RTOL, DISTILL_KL_ATOL = 9e-3, 0.045
DISTILL_CE_ATOL, DISTILL_GRAD_RTOL = 0.065, 0.027
DISTILL_FORMULA_RTOL = 1e-4
DISTILL_TAIL_HITS, DISTILL_TOP_SHARE = 0.75, 0.625
DISTILL_AGREE_MARGIN = 0.5
DISTILL_PROMPTS, DISTILL_PROMPT_LEN = 8, 64

TIMING_REPS = 20
# traced serve rounds the profile phase may take to get one whose trace
# holds every kernel record (CUPTI drops a few at random)
TRACE_ATTEMPTS = 10
L2_FLUSH_BYTES = 256 << 20               # > the H100's 50 MB L2


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; `t_s`: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T0, 3)}), flush=True)


def ptxas_report(log: str) -> list[dict]:
    """Each kernel of a `-Xptxas=-v` build log: its name (demangled with the
    toolkit's cu++filt where it is found), registers and spill bytes."""
    entries = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entries.append({"kernel": m.group(1)})
        elif entries:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                entries[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                entries[-1]["registers"] = int(m.group(1))
    filt = Path(native.nvcc_path()).with_name("cu++filt")
    if entries and filt.exists():
        names = subprocess.run([str(filt)], input="\n".join(e["kernel"] for e in entries),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(entries):
            for e, name in zip(entries, names):
                name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|\(int\)", "", name)
                e["kernel"] = name[:name.rfind(">(") + 1] if ">(" in name else name.split("(")[0]
    return entries


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


def matmul_shapes(cfg) -> dict[str, tuple[int, int]]:
    """The (K, N) of tinyllama's projections on the serve path."""
    d, h, kv, dh, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    return {"q_o": (d, h * dh), "k_v": (d, kv * dh), "gate_up": (d, f), "down": (f, d)}


def main_path_inputs(cfg, rng) -> list[tuple[str, str, dict]]:
    """(kernel, shape label, inputs) at the shapes full tinyllama-1.1b gives
    each kernel on the serve path."""
    dev, bf16 = "cuda", torch.bfloat16
    d, h, kv, dh, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.padded_vocab)

    def normal(shape, dtype, std=1.0):
        return (torch.from_numpy(rng.normal(size=shape) * std)
                .to(device=dev, dtype=dtype))

    cases = []
    projections = matmul_shapes(cfg)
    # the packed forms, packed on the card as the serve path packs them
    packed = {}
    for k, n in list(projections.values()) + [(d, v)]:
        w = normal((k, n), torch.float32, k ** -0.5)
        packed[k, n] = {name: form.pack(w) for name, form in PACKED.items()}
    shapes = [(label, m, k, n, bf16) for m in (8, 40, 512)
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
    cases.append(("decode_attention", f"B={B} S={S} H={h} KV={kv} d={dh} bf16",
                  decode_inputs(rng, B, S, h, kv, dh, serve_lens())))
    # whisper-small's decoder self-attention: MHA (12/12 heads), the encoder
    # serve's cache (prompts to 128 + 32 tokens), lanes halfway through
    w = configs.get_config(ENCODER_ARCH)
    s_w = max(int(x) for x in ENCODER_LENS.split(",")) + SERVE_GEN
    cases.append(("decode_attention",
                  f"whisper B={B} S={s_w} H={w.n_heads} KV={w.n_heads} d={w.d_head} bf16",
                  decode_inputs(rng, B, s_w, w.n_heads, w.n_heads, w.d_head,
                                serve_lens(ENCODER_LENS))))
    # whisper-small: the stem's two convs with the GELU fused at the output
    # port (conv2 first: the headline), the GELU table over the stem's
    # output, the pools of the pyramid
    t, d_w = w.frame_shape[0], w.d_model
    for label, i in stem_conv_inputs(rng):
        dims = ",".join(map(str, i["x"].shape))
        cases.append(("conv2d", f"stem {label} ({dims})->{d_w} s{i['stride'][1]} gelu bf16", i))
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


def stem_conv_inputs(rng, images: int = 1) -> list[tuple[str, dict]]:
    """whisper-small's two stem convs as the encoder runs them, in bf16, with
    the GELU fused: (label, conv2d inputs) for conv2 (d 768 -> 768, stride 2)
    and conv1 (80 mels -> 768), over `images` frame arrays."""
    w = configs.get_config(ENCODER_ARCH)
    t, d_w, kw = w.frame_shape[0], w.d_model, w.stem_width

    def normal(shape, std=1.0):
        return torch.from_numpy(rng.normal(size=shape) * std).to("cuda", torch.bfloat16)

    return [(label, {"x": normal((images, 1, t, cin)),
                     "w": normal((1, kw, cin, d_w), (kw * cin) ** -0.5),
                     "bias": normal((d_w,), 0.1), "stride": (1, stride), "padding": "SAME",
                     "epilogue": "gelu"})
            for label, cin, stride in (("conv2", d_w, w.stem_stride), ("conv1", w.n_mels, 1))]


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
        if i.get("window") is None:
            return lambda: F.scaled_dot_product_attention(
                i["q"], i["k"], i["v"], is_causal=i.get("causal", True), enable_gqa=True)
        sq, skv = i["q"].shape[2], i["k"].shape[2]
        qpos = torch.arange(sq, device="cuda")[:, None]
        kpos = torch.arange(skv, device="cuda")[None]
        allow = (qpos - kpos) < i["window"]
        if i.get("causal", True):
            allow &= kpos <= qpos
        return lambda: F.scaled_dot_product_attention(i["q"], i["k"], i["v"], attn_mask=allow,
                                                      enable_gqa=True)
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
DECODE_NAMES = ("q", "k_cache", "v_cache", "positions", "current")

# the wrapper call a kernel's time is taken of, where the registry row adds
# work around it (the verify rows pack their three outputs into one array)
KERNEL_CALLS = {
    "decode_attention": lambda i: decode_attention(*(i[k] for k in DECODE_NAMES)),
    "paged_decode_attention": lambda i: paged_decode_attention(*(i[k] for k in PAGED_NAMES)),
    "specdec": lambda i: sd.verify_accept_kernel(i["scores"], i["draft"])[0],
    "specdec_tree": lambda i: sd.verify_accept_tree_kernel(i["scores"], i["draft"])[0],
}


def decode_on_gathered_pages(i: dict, window=None) -> torch.Tensor:
    """`decode_attention(bk=bs)` on the gathered pages of a paged bundle:
    what `paged_decode_attention` must equal bit for bit (the reference's
    contract)."""
    tables = i["block_tables"]
    return decode_attention(i["q"], gather_pages(i["k_arena"], tables),
                            gather_pages(i["v_arena"], tables),
                            gathered_positions(i["pos_arena"], tables), i["current"],
                            window=window, bk=i["k_arena"].shape[1])


def flash_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the causal and window masks allow."""
    qi = np.arange(sq)
    lo = np.maximum(0, qi - window + 1) if window else np.zeros_like(qi)
    hi = np.minimum(skv, qi + 1) if causal else np.full_like(qi, skv)
    return int(np.maximum(0, hi - lo).sum())


def masked_flash(spec):
    """The flash row with the masks its inputs name (`causal`, default
    True, and `window`, default None): the encoder's and the
    cross-attention's non-causal calls, the sliding window. The work counts
    the pairs the masks allow."""
    def masks(i):
        return {"causal": i.get("causal", True), "window": i.get("window")}

    def work(i):
        b, h, sq, d = i["q"].shape
        n_bytes = 2 * i["q"].numel() * i["q"].element_size() + sum(
            i[k].numel() * i[k].element_size() for k in ("k", "v"))
        pairs = flash_pairs(sq, i["k"].shape[2], **masks(i))
        return 4.0 * b * h * d * pairs, float(n_bytes)

    return dataclasses.replace(
        spec, work=work,
        run_kernel=lambda i: flash_attention(i["q"], i["k"], i["v"], **masks(i)),
        run_oracle=lambda i: flash_attention_ref(i["q"], i["k"], i["v"], **masks(i)))


def check_case(spec, label, inputs, failures: list, timer=None, peaked=False) -> dict:
    """One kernel call against its plain version on the same inputs; with a
    timer, also the times of the kernel, its plain version and the library
    call, and the bound from this run's inputs; `peaked`, also within
    PEAK_ROUNDINGS roundings of the largest |ref|. Emits the record; a
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
    if peaked:
        r = ref.float()
        limit = PEAK_ROUNDINGS * torch.finfo(dtype).eps / 2 * float(
            r[torch.isfinite(r)].abs().max())
        rec.update({"peak_limit": limit, "ok": ok and err <= limit})
        ok = rec["ok"]
    if timer is not None:
        ops, nbytes = spec.work(inputs)
        t_ops = ops / target.peak_for(dtype_name(dtype))
        t_bytes = nbytes / target.hbm_bandwidth
        library = library_call(spec.name, inputs)
        run = KERNEL_CALLS.get(spec.name, spec.run_kernel)
        rec.update({
            "ms": timer.device_ms(lambda: run(inputs)),
            "eager_ms": timer.eager_ms(lambda: run(inputs)),
            "plain_ms": timer.device_ms(lambda: spec.run_oracle(inputs)),
            "library_ms": None if library is None else timer.device_ms(library),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes})
    emit("kernel", **rec)
    if not ok:
        failures.append(f"{spec.name} {label}: max_abs_err {err} tol {tol}"
                        + (f" peak limit {rec['peak_limit']}" if peaked else ""))
    return rec


def check_paged_bits(i: dict, label: str, dtype, failures: list) -> None:
    """paged_decode_attention on the bundle `i` bit for bit against
    decode_attention(bk=bs) on the gathered pages, without and with a
    window."""
    for window in (None, 5):
        same = torch.equal(paged_decode_attention(*(i[k] for k in PAGED_NAMES), window=window),
                           decode_on_gathered_pages(i, window))
        emit("paged_bits", case=label, dtype=dtype_name(dtype), window=window,
             bit_identical=same)
        if not same:
            failures.append(f"paged_decode_attention {label} {dtype_name(dtype)} "
                            f"window={window}: differs from decode_attention(bk=bs) on the "
                            "gathered pages")


def wide_head_inputs(rng) -> list[tuple[str, str, dict]]:
    """(kernel, shape label, inputs) at the head dims of the archs still to
    port: flash over a 512-token causal prefill (and at d 256 a 4,096-token
    prefill under recurrentgemma's 2,048-token window), decode on 8 lanes
    of the serve phase's cache lengths, the paged decode on 8 lanes of 16
    pages of 16 slots."""
    dev, bf16 = "cuda", torch.bfloat16
    fl, dec, pg = (registry.get(n) for n in ("flash", "decode_attention",
                                             "paged_decode_attention"))
    B, S = 8, SERVE_MAX_LEN
    lens = torch.tensor([int(x) for x in SERVE_LENS.split(",")], dtype=torch.int32,
                        device=dev) + SERVE_GEN // 2
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    cases = []
    for d, (h, kvh) in WIDE_HEADS.items():
        shapes = [(512, None)] + ([(4096, 2048)] if d == 256 else [])
        for L, window in shapes:
            i = fl.make_inputs(registry.ShapeCase("wide", (1, h, kvh, L, L, d)), bf16, rng, dev)
            label = f"causal L={L}" + (f" window={window}" if window else "")
            cases.append(("flash", f"{label} H={h} KV={kvh} d={d} bf16",
                          {**i, "window": window}))
        i = dec.make_inputs(registry.ShapeCase("wide", (B, h, kvh, S, d, S)), bf16, rng, dev)
        i["positions"] = torch.where(pos < lens[:, None], pos, -1).contiguous()
        i["current"] = (lens - 1).contiguous()
        cases.append(("decode_attention", f"B={B} S={S} H={h} KV={kvh} d={d} bf16", i))
        i = pg.make_inputs(registry.ShapeCase("wide", (B, h, kvh, 160, 16, 16, d, 256)), bf16,
                           rng, dev)
        cases.append(("paged_decode_attention",
                      f"B={B} H={h} KV={kvh} d={d} bs=16 nb=16 bf16", i))
    return cases


def check_flash_bits(rng, failures: list) -> None:
    """flash's bits do not depend on the run: the same call twice gives the
    same bits (the tile path at a 512-token prefill, the split path at one
    query against 1,500 keys), and one query per lane against 1,500 keys on
    8 lanes equals the first 8 of the same call on 16 lanes."""
    w = configs.get_config(ENCODER_ARCH)
    h, d, n = w.n_heads, w.d_head, w.encoder_len

    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape)).to(device="cuda", dtype=torch.bfloat16)

    q1, k1, v1 = normal((16, h, 1, d)), normal((16, h, n, d)), normal((16, h, n, d))
    qt, kt, vt = (normal((1, 32, 512, 64)) for _ in range(3))
    checks = {
        "tile rerun": (flash_attention(qt, kt, vt), flash_attention(qt, kt, vt)),
        "split rerun": (flash_attention(q1, k1, v1, causal=False),
                        flash_attention(q1, k1, v1, causal=False)),
        "split 8 of 16 lanes": (flash_attention(q1[:8], k1[:8], v1[:8], causal=False),
                                flash_attention(q1, k1, v1, causal=False)[:8]),
    }
    for label, (a, b) in checks.items():
        same = torch.equal(a, b)
        emit("flash_bits", check=label, bit_identical=same)
        if not same:
            failures.append(f"flash {label}: not bit-identical "
                            f"(max diff {float((a.float() - b.float()).abs().max())})")


def time_flash_plans(rng, timer) -> None:
    """The short-query plan beside the plans it did not take: one query per
    lane against whisper-small's 1,500 keys (its 12 heads), on 1 and 8
    lanes, at d 64, 128 and 256, with key splits of SPLIT_LENS keys and with
    one split (no combine pass). Timed only, through the wrapper with
    `flash_plan` swapped for the plan under test."""
    w = configs.get_config(ENCODER_ARCH)
    h, n = w.n_heads, w.encoder_len
    one = -(-n // fa.SPLIT_STAGE) * fa.SPLIT_STAGE
    chosen = fa.flash_plan
    try:
        for d in (64, 128, 256):
            for b in (1, 8):
                q, k, v = (torch.from_numpy(rng.normal(size=(b, h, s, d))).to(
                    device="cuda", dtype=torch.bfloat16) for s in (1, n, n))
                ms = {}
                for split_len in SPLIT_LENS + (one,):
                    plan = fa.FlashPlan("short", -(-n // split_len), split_len)
                    fa.flash_plan = lambda *_, plan=plan: plan
                    ms[split_len if split_len != one else "one split"] = timer.device_ms(
                        lambda: flash_attention(q, k, v, causal=False))
                emit("flash_plans", lanes=b, heads=h, sq=1, skv=n, d=d,
                     plan=chosen(1, n)._asdict(), ms_by_split_len=ms)
    finally:
        fa.flash_plan = chosen


def serve_lens(prompt_lens: str = SERVE_LENS) -> list[int]:
    """Each lane's written length halfway through a serve's generation."""
    return [int(x) + SERVE_GEN // 2 for x in prompt_lens.split(",")]


def decode_inputs(rng, b: int, s: int, h: int, kvh: int, d: int, lens,
                  dtype=torch.bfloat16) -> dict:
    """decode_attention's operands on the card (bf16 unless `dtype`): lane i
    holds positions 0..lens[i]-1 in its first slots (the rest empty, -1) and
    decodes at lens[i] - 1."""
    def normal(shape):
        return torch.from_numpy(rng.normal(size=shape)).to(device="cuda", dtype=dtype)

    lens = torch.as_tensor(np.asarray(lens), dtype=torch.int32, device="cuda")
    pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(b, s)
    return {"q": normal((b, h, d)), "k_cache": normal((b, s, kvh, d)),
            "v_cache": normal((b, s, kvh, d)),
            "positions": torch.where(pos < lens[:, None], pos, -1).contiguous(),
            "current": (lens - 1).contiguous()}


def split_lengths(s: int, bk: int) -> list:
    """The split lengths of DECODE_SPLIT_SLOTS (multiples of bk) that cut s
    slots into 2 to MAX_SPLITS splits, then None: one split."""
    return [n for n in DECODE_SPLIT_SLOTS
            if n % bk == 0 and 2 <= -(-s // n) <= da.MAX_SPLITS] + [None]


def time_decode_plans(rng, timer) -> None:
    """The decode plan beside the plans it did not take: at the serve phase's
    cache length and at 4,096 slots, tinyllama's heads at d 64 and the wide
    heads at d 128 and 256, on 1 and 8 lanes of random lengths, bk 64, and
    the paged form on the served arena's shape (8 lanes, 16 pages of 16):
    the split lengths of `split_lengths` and one split (no merge). Timed
    only, through the wrapper with `decode_plan` swapped for the plan under
    test."""
    bk, chosen = da.DEFAULT_CHUNK, da.decode_plan
    try:
        for d, (h, kvh) in DECODE_HEADS.items():
            for s in DECODE_LENS:
                chunks = -(-s // bk)
                for b in (1, 8):
                    i = decode_inputs(rng, b, s, h, kvh, d, rng.integers(1, s + 1, size=b))
                    ms = {}
                    for slots in split_lengths(s, bk):
                        per = chunks if slots is None else slots // bk
                        plan = da.DecodePlan(-(-chunks // per), per)
                        da.decode_plan = lambda *_, plan=plan: plan
                        ms[slots or "one split"] = timer.device_ms(
                            lambda: decode_attention(*(i[k] for k in DECODE_NAMES)))
                    emit("decode_plans", lanes=b, heads=h, kv_heads=kvh, s=s, d=d, bk=bk,
                         plan=chosen(s, bk)._asdict(), ms_by_split_slots=ms)
        # the paged form at the served arena's shape: 16 pages of 16 slots
        h, kvh = DECODE_HEADS[64]
        i = registry.get("paged_decode_attention").make_inputs(
            registry.ShapeCase("arena", (8, h, kvh, 160, 16, 16, 64, 256)), torch.bfloat16,
            rng, "cuda")
        ms = {}
        for slots in split_lengths(256, 16):
            per = 16 if slots is None else slots // 16
            plan = da.DecodePlan(-(-16 // per), per)
            da.decode_plan = lambda *_, plan=plan: plan
            ms[slots or "one split"] = timer.device_ms(lambda: KERNEL_CALLS[
                "paged_decode_attention"](i))
        emit("decode_plans", kernel="paged_decode_attention", lanes=8, heads=h, kv_heads=kvh,
             s=256, d=64, bk=16, plan=chosen(256, 16)._asdict(), ms_by_split_slots=ms)
    finally:
        da.decode_plan = chosen


def check_decode_rows(rng, failures: list) -> None:
    """The row contract under splits: decode at the serve phase's cache
    length and at 4,096 slots (9 and 64 splits at bk 64), 16 lanes of random
    lengths; 8 lanes must equal the first 8 of the 16 bit for bit, and the
    same call twice the same bits, in bf16 at tinyllama's heads, in fp32 at
    whisper's (12/12, d 64) and in fp16 at ane-paper's (8/8, d 128)."""
    for s in DECODE_LENS:
        for dtype, (h, kvh), d in ((torch.bfloat16, (32, 4), 64),
                                   (torch.float32, (12, 12), 64),
                                   (torch.float16, (8, 8), 128)):
            i = decode_inputs(rng, 16, s, h, kvh, d, rng.integers(1, s + 1, size=16), dtype)
            full = decode_attention(*(i[k] for k in DECODE_NAMES))
            eight = decode_attention(*(i[k][:8] for k in DECODE_NAMES))
            checks = {"8 of 16 lanes": (eight, full[:8]),
                      "rerun": (decode_attention(*(i[k] for k in DECODE_NAMES)), full)}
            for label, (a, b) in checks.items():
                same = torch.equal(a, b)
                emit("decode_rows", check=label, s=s, heads=h, kv_heads=kvh, d=d,
                     dtype=dtype_name(dtype), plan=da.decode_plan(s, da.DEFAULT_CHUNK)._asdict(),
                     bit_identical=same)
                if not same:
                    failures.append(f"decode_attention S={s} {dtype_name(dtype)} {label}: "
                                    "not bit-identical")


def check_row_invariance(cfg, failures: list) -> None:
    """`anemm`, `sparse` and `palette` in every dtype each takes: the first
    rows of one 512-row activation must come out bit-identical whatever the
    call's row count (INVARIANCE_ROWS), at every main-path (K, N), the head
    and two ragged shapes. A row's bits may not depend on the rows beside
    it: 8-row decode against a 16- to 80-row verify window, a prefix hit's
    short prefill against a cold one. `conv2d` in every dtype at whisper's
    two stem convs (GELU fused): the first images of a 4-image call must
    come out bit-identical in calls of 1 to 4 images."""
    rng = np.random.default_rng(5)
    shapes = [*matmul_shapes(cfg).items(), ("head", (cfg.d_model, cfg.padded_vocab))]
    shapes += [("ragged", kn) for kn in RAGGED_SHAPES]
    top = max(INVARIANCE_ROWS)
    for name in ("anemm", "sparse", "palette"):
        spec = registry.get(name)
        for label, (k, n) in shapes:
            if name == "sparse":
                k = -(-k // 16) * 16
            if name == "palette":
                k += k % 2
            w = torch.from_numpy(rng.normal(size=(k, n)) * k ** -0.5).to("cuda", torch.float32)
            packed = PACKED[name].pack(w) if name in PACKED else None
            for dtype in spec.dtypes:
                weights = packed if packed is not None else {"b": w.to(dtype)}
                a = torch.from_numpy(rng.normal(size=(top, k))).to("cuda", dtype)
                full = spec.run_kernel({"a": a, **weights})
                bits = torch.int32 if dtype == torch.float32 else torch.int16
                diffs, same = {}, True
                for m in INVARIANCE_ROWS:
                    out, want = spec.run_kernel({"a": a[:m], **weights}), full[:m]
                    same = same and torch.equal(out.view(bits), want.view(bits))
                    diffs[m] = float((out.float() - want.float()).abs().max())
                emit("row_invariance", kernel=name, dtype=dtype_name(dtype),
                     shape=f"{label} {k}->{n}", rows=list(INVARIANCE_ROWS),
                     max_abs_diff=max(diffs.values()), by_rows=diffs, bit_identical=same)
                if not same:
                    failures.append(f"{name} {label} {k}->{n} {dtype_name(dtype)}: rows of a "
                                    f"{top}-row call differ at fewer rows ({diffs})")
    conv = registry.get("conv2d")
    images = 4
    for label, stem in stem_conv_inputs(rng, images):
        for dtype in conv.dtypes:
            i = {k: v.to(dtype) if isinstance(v, torch.Tensor) else v for k, v in stem.items()}
            full = conv.run_kernel(i)
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            diffs, same = {}, True
            for b in range(1, images + 1):
                out, want = conv.run_kernel({**i, "x": i["x"][:b]}), full[:b]
                same = same and torch.equal(out.view(bits), want.view(bits))
                diffs[b] = float((out.float() - want.float()).abs().max())
            emit("row_invariance", kernel="conv2d", dtype=dtype_name(dtype),
                 shape=f"stem {label} B={images}", rows=list(diffs),
                 max_abs_diff=max(diffs.values()), by_rows=diffs, bit_identical=same)
            if not same:
                failures.append(f"conv2d stem {label} {dtype_name(dtype)}: the first images "
                                f"of a {images}-image call differ in smaller calls ({diffs})")


def time_matmul_plans(cfg, rng, timer) -> None:
    """The streaming loop's launch plans side by side: at every main-path
    projection and each M of PLAN_ROWS, bf16, `anemm`, `sparse` and
    `palette` with a tile's chunks spread over a cluster and with one block
    walking them all (the same bits). Timed only, through the wrappers with
    `common.launch_plan` swapped for the plan under test."""
    chosen = common.launch_plan
    bf16 = torch.bfloat16
    try:
        for label, (k, n) in matmul_shapes(cfg).items():
            w = torch.from_numpy(rng.normal(size=(k, n)) * k ** -0.5).to("cuda", torch.float32)
            weights = {"anemm": {"b": w.to(bf16)},
                       **{name: form.pack(w) for name, form in PACKED.items()}}
            chunks = common.chunk_plan(k, n, bf16)
            for m in PLAN_ROWS:
                a = torch.from_numpy(rng.normal(size=(m, k))).to("cuda", bf16)
                taken = chosen(m, n, chunks)
                for name, payload in weights.items():
                    run, i = registry.get(name).run_kernel, {"a": a, **payload}
                    ms = {}
                    for split in sorted({1, chunks.chunks}):
                        plan = common.LaunchPlan(taken.bm, split)
                        common.launch_plan = lambda *_, plan=plan: plan
                        ms[f"split {split}"] = timer.device_ms(lambda: run(i))
                    common.launch_plan = chosen
                    emit("matmul_plans", kernel=name, shape=f"{label} M={m} {k}->{n} bf16",
                         chunks=chunks._asdict(), plan=taken._asdict(), ms_by_split=ms)
    finally:
        common.launch_plan = chosen


def time_stem_convs(rng, timer) -> None:
    """Where a stem conv's time goes: the fused call (GELU at the output
    port), the conv without an epilogue, and `anemm` on the implicit GEMM's
    own (B*OH*OW, KW*Cin) x (KW*Cin, Cout) operands, with and without the
    fused GELU: the gather's cost is conv minus GEMM, the epilogue's fused
    minus unfused. Timed only."""
    conv = registry.get("conv2d")
    for label, i in stem_conv_inputs(rng):
        x, w = i["x"], i["w"]
        k, n = w.shape[0] * w.shape[1] * w.shape[2], w.shape[3]
        rows = torch.from_numpy(rng.normal(size=(x.shape[2] // i["stride"][1], k))).to(
            "cuda", x.dtype)
        gemm_w = w.reshape(k, n)
        emit("stem_conv_split", conv=label, m=rows.shape[0], k=k, n=n,
             ms={"conv gelu": timer.device_ms(lambda: conv.run_kernel(i)),
                 "conv": timer.device_ms(lambda: conv.run_kernel({**i, "epilogue": None})),
                 "anemm gelu": timer.device_ms(lambda: anemm(rows, gemm_w, epilogue="gelu")),
                 "anemm": timer.device_ms(lambda: anemm(rows, gemm_w))})


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """torch.equal, with NaN exactly where `want` has NaN."""
    nan = torch.isnan(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(got[~nan], want[~nan]))


def check_exact_bits(rng, failures: list) -> None:
    """act_lut and both pools bit for bit (torch.equal) against their plain
    versions: act_lut at the stem's output shape in every dtype and through
    every table; the pools at the pyramid's shapes in every dtype and with
    C = 5 (the scalar path); every registry case of the three in every
    dtype; both pools with NaN inputs (NaN exactly where the plain version
    has it)."""
    def record(name: str, case: str, dtype, got, want) -> None:
        ok = same_bits(got, want)
        emit("exact_bits", kernel=name, case=case, dtype=dtype_name(dtype), bit_identical=ok)
        if not ok:
            failures.append(f"{name} {case} {dtype_name(dtype)}: differs from its plain version")

    w = configs.get_config(ENCODER_ARCH)
    stem = (w.frame_shape[0], w.d_model)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        x = torch.from_numpy(rng.normal(size=stem) * 2.0).to("cuda", dtype)
        for name in LUT_NAMES:
            table = table_operands(name, "cuda")
            record("act_lut", f"{name} {stem}", dtype, lut_activation(name)(x),
                   act_lut_ref(x, table))
        for name, (shape, window, stride, pad) in POOL_SHAPES.items():
            spec = registry.get(name)
            for c in (shape[3], 5):
                i = {"x": torch.from_numpy(rng.normal(size=shape[:3] + (c,))).to("cuda", dtype),
                     "window": window, "stride": stride, "padding": pad}
                record(name, f"{shape[:3] + (c,)} {window} s{stride[0]} {pad}", dtype,
                       spec.run_kernel(i), spec.run_oracle(i))
    for name in ("act_lut", "avg_pool", "max_pool"):
        spec = registry.get(name)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for case in spec.cases:
                i = spec.make_inputs(case, dtype, rng, "cuda")
                record(name, f"registry {case.name}", dtype, spec.run_kernel(i),
                       spec.run_oracle(i))
    for name, (shape, window, stride, pad) in POOL_SHAPES.items():
        x = rng.normal(size=shape)
        x[rng.random(size=shape) < 0.01] = np.nan
        i = {"x": torch.from_numpy(x).to("cuda", torch.bfloat16), "window": window,
             "stride": stride, "padding": pad}
        want = registry.get(name).run_oracle(i)
        if not bool(torch.isnan(want).any()):
            failures.append(f"{name} NaN check: no NaN reached the plain version's output")
        record(name, f"NaN inputs {shape}", torch.bfloat16, registry.get(name).run_kernel(i), want)


def capture(fn) -> torch.cuda.CUDAGraph:
    """fn captured into a CUDA graph after three warm-up calls on a side
    stream (as Timer.device_ms captures it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # an empty graph warns
        with torch.cuda.graph(graph):
            fn()
    return graph


def time_floor(timer, rng, turn=None) -> None:
    """The kernels' timer floor: an empty CUDA graph timed by the Timer
    every kernel is timed by (`floor_ms`), and `out.copy_(x)` over the
    act_lut and pool inputs' bytes at their main-path shapes (`copy_ms`).
    Then the empty graph, the act_lut input's copy and act_lut itself with
    the L2 flushed by a write before each call (the Timer's `flush.zero_()`,
    which leaves ~50 MB of dirty lines), by a read (clean lines), and not
    flushed (`by_flush`): whether the floor is those dirty lines written
    back inside the timed window."""
    w = configs.get_config(ENCODER_ARCH)
    bf16 = torch.bfloat16
    inputs = {"act_lut": torch.from_numpy(rng.normal(size=(w.frame_shape[0], w.d_model))).to(
        "cuda", bf16)}
    inputs.update({name: torch.from_numpy(rng.normal(size=shape)).to("cuda", bf16)
                   for name, (shape, *_) in POOL_SHAPES.items()})
    outs = {k: torch.empty_like(x) for k, x in inputs.items()}

    def nothing():
        return None

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        floor = timer.device_ms(nothing)
    copy_ms = {k: timer.device_ms(lambda k=k: outs[k].copy_(inputs[k])) for k in inputs}
    graphs = {"empty": capture(nothing),
              "copy act_lut": capture(lambda: outs["act_lut"].copy_(inputs["act_lut"])),
              "act_lut": capture(lambda: lut_activation("gelu")(inputs["act_lut"]))}
    flushes = {"write": timer.flush.zero_,
               "read": lambda: torch.sum(timer.flush, dtype=torch.int64),
               "none": nothing}
    by_flush = {}
    for mode, flush in flushes.items():
        by_flush[mode] = {}
        for label, graph in graphs.items():
            times = []
            for _ in range(TIMING_REPS):
                flush()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            by_flush[mode][label] = statistics.median(times)
    emit("timer_floor", **({} if turn is None else {"turn": turn}), floor_ms=floor,
         copy_ms=copy_ms, copy_bytes={k: 2 * x.numel() * x.element_size()
                                      for k, x in inputs.items()},
         by_flush=by_flush)


def time_pool_plans(rng, timer) -> None:
    """The pool kernel's plans side by side at the pyramid's shapes (bf16):
    the plan `pool_plan` picks beside other output tiles (max) and other
    fold widths and chunks (avg), through the wrapper with `pool_plan`
    swapped for the plan under test; every plan must give the chosen plan's
    bits. Timed only, in two passes (in order, then reversed), so that a
    slow first timing shows as one."""
    chosen = pool_module.pool_plan

    def plan_with(base, shape, window, stride, pad, tile_h, tile_w, fold, chunk):
        (wh, ww), (sh, sw) = window, stride
        oh, ow = (out_extent(n, k, st, pad) for n, k, st in zip(shape[1:3], window, stride))
        return base._replace(fold=fold, chunk=chunk, tile_h=tile_h, tile_w=tile_w,
                             row_tiles=-(-oh // tile_h), col_tiles=-(-ow // tile_w),
                             n_chunks=-(-shape[3] // chunk), patch_h=(tile_h - 1) * sh + wh,
                             patch_w=(tile_w - 1) * sw + ww)

    try:
        for name, (shape, window, stride, pad) in POOL_SHAPES.items():
            spec = registry.get(name)
            i = {"x": torch.from_numpy(rng.normal(size=shape)).to("cuda", torch.bfloat16),
                 "window": window, "stride": stride, "padding": pad}
            base = chosen(shape, window, stride, pad, 2, True)
            want = spec.run_kernel(i)
            shapes = ([(th, tw, 8, 64) for th, tw in ((4, 4), (2, 8), (4, 8), (8, 8))]
                      if name == "max_pool" else
                      [(1, 1, fold, chunk) for fold in (2, 8) for chunk in (64, 16, 128)])
            ms = {f"tile {th}x{tw} fold {fold} chunk {ch}": [] for th, tw, fold, ch in shapes}
            for order in (shapes, shapes[::-1]):
                for tile_h, tile_w, fold, chunk in order:
                    plan = plan_with(base, shape, window, stride, pad, tile_h, tile_w, fold,
                                     chunk)
                    pool_module.pool_plan = lambda *_, plan=plan: plan
                    if not torch.equal(spec.run_kernel(i), want):
                        raise AssertionError(f"{name} plan {plan}: bits differ from {base}")
                    ms[f"tile {tile_h}x{tile_w} fold {fold} chunk {chunk}"].append(
                        timer.device_ms(lambda: spec.run_kernel(i)))
                    pool_module.pool_plan = chosen
            emit("pool_plans", kernel=name, shape=list(shape), chosen=base._asdict(), ms=ms)
    finally:
        pool_module.pool_plan = chosen


def check_kernels(cfg, timer) -> dict:
    """Every registry case and every main-path shape: kernel vs plain on the
    card. Returns the headline record of each kernel but the paged decode,
    whose headline the prefix phase measures on the served arena."""
    rng = np.random.default_rng(0)
    failures = []

    def check(spec, label, inputs, timed: bool, peaked=False):
        return check_case(spec, label, inputs, failures, timer if timed else None, peaked)

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
    # flash beyond the registry's causal cases, at every head dim in every
    # dtype: non-causal (the encoder's), the sliding window, GQA, and the
    # short queries of the split-KV path (a decode step's cross-attention)
    fl, dec = registry.get("flash"), registry.get("decode_attention")
    mf = masked_flash(fl)
    for dtype in fl.dtypes:
        for d in FLASH_HEAD_DIMS:
            for label, dims, masks in FLASH_EXTRA:
                i = {**fl.make_inputs(registry.ShapeCase(label, dims + (d,)), dtype, rng,
                                      "cuda"), **masks}
                check(mf, f"{label} {dims} d={d} {dtype_name(dtype)}", i, False)
    # several non-empty key splits merged (4 queries against 1,000 keys: three
    # splits of 256 and a short one) under peaked scores, q drawn at 4x, so
    # the outputs are O(1) and a mis-weighted split shows
    for dtype in (torch.bfloat16, torch.float16):
        for d in FLASH_HEAD_DIMS:
            dims = (2, 4, 2, 4, 1000)
            i = fl.make_inputs(registry.ShapeCase("splits", dims + (d,)), dtype, rng, "cuda")
            i["q"] *= 4
            check(mf, f"peaked splits {dims} d={d} {dtype_name(dtype)}",
                  {**i, "causal": False}, False, peaked=True)
    # the sliding window of decode, which the registry cases leave off
    for dtype in dec.dtypes:
        i = dec.make_inputs(dec.cases[0], dtype, rng, "cuda")
        win = dataclasses.replace(
            dec, run_kernel=lambda i: decode_attention(*(i[k] for k in DECODE_NAMES), window=24),
            run_oracle=lambda i: decode_attention_ref(*(i[k] for k in DECODE_NAMES), window=24))
        check(win, f"window=24 {dtype_name(dtype)}", i, False)
    # decode and the paged decode at the wide heads (d 128: 32/8 heads, d
    # 256: 16/1), with and without a window; the paged form bit for bit
    # against decode_attention(bk=bs) on the gathered pages
    pg = registry.get("paged_decode_attention")
    for d, (h, kvh) in WIDE_HEADS.items():
        for dtype in dec.dtypes:
            i = dec.make_inputs(registry.ShapeCase("wide", (3, h, kvh, 200, d, 150)), dtype,
                                rng, "cuda")
            check(dec, f"wide H={h} KV={kvh} d={d} {dtype_name(dtype)}", i, False)
            i = pg.make_inputs(registry.ShapeCase("wide", (3, h, kvh, 40, 16, 12, d, 150)),
                               dtype, rng, "cuda")
            check(pg, f"wide H={h} KV={kvh} d={d} {dtype_name(dtype)}", i, False)
            check_paged_bits(i, f"wide d={d}", dtype, failures)

    # a lane with no valid slot (nothing written, current -1) beside written
    # ones at the serve phase's cache length, over 9 splits: the plain
    # version's uniform average over the lane's slots
    lens = serve_lens()
    lens[3] = 0
    h, kvh = DECODE_HEADS[64]
    check(dec, f"all-masked lane B=8 S={SERVE_MAX_LEN} H={h} KV={kvh} d=64 bf16",
          decode_inputs(rng, 8, SERVE_MAX_LEN, h, kvh, 64, lens), False)

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
            check_paged_bits(i, case.name, dtype, failures)

    # verify/accept on rows with planted equal maxima and rows of all -inf,
    # at the spec phase's shapes
    for name in ("specdec", "specdec_tree"):
        spec = registry.get(name)
        dims = (8, SPEC_DEPTH + 1, cfg.vocab) if name == "specdec" else \
            (8, 2, SPEC_DEPTH + 1, cfg.vocab)
        for kind in ("ties", "-inf", "slice ties", "nan"):
            i = spec.make_inputs(registry.ShapeCase("stress", dims), torch.float32, rng, "cuda")
            s = i["scores"]
            if kind in ("ties", "slice ties"):
                # equal maxima at random columns, or on both sides of the
                # first pass's slice boundaries (the first index must win)
                edge = sd.slice_plan(cfg.vocab).slice_cols
                cols = (torch.randint(0, cfg.vocab, s.shape[:-1] + (3,), device="cuda")
                        if kind == "ties" else torch.tensor(
                            [edge - 1, edge, 2 * edge + 3], device="cuda").expand(
                                *s.shape[:-1], 3).contiguous())
                top = s.amax(-1, keepdim=True) + 1.0
                s.scatter_(-1, cols, top.expand(*s.shape[:-1], 3).contiguous())
            elif kind == "nan":                   # NaN in one slice, or in two
                s[::2, ..., 5000] = float("nan")
                s[::3, ..., 20000] = float("nan")
            else:
                s[1::2] = float("-inf")           # every other lane
            check(spec, f"{kind} rows " + "x".join(map(str, dims)), i, False)

    headline = {}
    for name, label, inputs in main_path_inputs(cfg, rng):
        rec = check(registry.get(name), "main " + label, inputs, True)
        headline.setdefault(name, rec)
        if label.startswith("gate_up M=8"):
            headline[name] = rec                  # decode-time projection
    # ane-paper's decode in float16 (8 lanes, 8/8 heads, d 128, the serve
    # phase's 544-slot cache and lengths), and the paged form on the same
    # lanes in 16-slot pages: timed beside their plain versions and SDPA
    ane = configs.get_config("ane-paper")
    h_a, kv_a, d_a, nb = ane.n_heads, ane.n_kv_heads, ane.d_head, SERVE_MAX_LEN // 16
    i = decode_inputs(rng, 8, SERVE_MAX_LEN, h_a, kv_a, d_a, serve_lens(), torch.float16)
    check(dec, f"main ane-paper B=8 S={SERVE_MAX_LEN} H={h_a} KV={kv_a} d={d_a} fp16", i, True)
    i = pg.make_inputs(registry.ShapeCase("ane", (8, h_a, kv_a, 8 * nb, 16, nb, d_a,
                                                  SERVE_MAX_LEN)), torch.float16, rng, "cuda")
    check(pg, f"main ane-paper B=8 pages={nb}x16 H={h_a} KV={kv_a} d={d_a} fp16", i, True)
    check_paged_bits(i, "ane-paper fp16", torch.float16, failures)
    check_exact_bits(rng, failures)
    time_pool_plans(rng, timer)
    time_floor(timer, rng)
    # whisper-small's encoder attention (non-causal, L = 1500) and a decode
    # step's cross-attention (8 lanes, one query against 1500 keys), each on
    # contiguous (B, H, S, d) tensors and on the strided (B, S, H, d) ->
    # (B, H, S, d) views the flash route passes, q drawn at 4x (peaked
    # scores, outputs O(1)); then the wide heads: timed, not headlines
    w = configs.get_config(ENCODER_ARCH)
    h_w, d_h, enc_len = w.n_heads, w.d_head, w.encoder_len
    for b, sq in ((1, enc_len), (8, 1)):
        for views in (False, True):
            i = {}
            for k in ("q", "k", "v"):
                s_k = sq if k == "q" else enc_len
                x = torch.from_numpy(rng.normal(size=(b, s_k, h_w, d_h) if views else
                                                (b, h_w, s_k, d_h)))
                x = (4 * x if k == "q" else x).to(device="cuda", dtype=torch.bfloat16)
                i[k] = x.transpose(1, 2) if views else x
            check(mf, f"main non-causal B={b} Sq={sq} Skv={enc_len} H={h_w} d={d_h} bf16"
                      + (" route views" if views else ""), {**i, "causal": False}, True,
                  peaked=True)
    time_flash_plans(rng, timer)
    time_decode_plans(rng, timer)
    check_decode_rows(rng, failures)
    for name, label, inputs in wide_head_inputs(rng):
        check(mf if name == "flash" else registry.get(name), "main " + label, inputs, True)
    check_flash_bits(rng, failures)
    check_row_invariance(cfg, failures)
    time_matmul_plans(cfg, rng, timer)
    time_stem_convs(rng, timer)
    # the fp32 head's bf16 -> fp32 widening (the reference's on every call,
    # layers.py:158-161; the port's once a head, `layers.fp32_head`): the
    # copy's own device time
    unembed = torch.empty((cfg.d_model, cfg.padded_vocab), dtype=torch.bfloat16,
                          device="cuda").normal_()
    emit("head_widen", shape=list(unembed.shape),
         ms=timer.device_ms(lambda: unembed.to(torch.float32)),
         bytes=unembed.numel() * (2 + 4))
    check_packed_linears(cfg, rng, failures)
    if failures:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(failures))
    return headline


def check_packed_linears(cfg, rng, failures: list) -> None:
    """The public wrappers `PaletteLinear` and `SparseLinear` (pack once,
    call): a gate/up weight of full tinyllama-1.1b packed on the card, one
    call on 8 bf16 rows each; the call must launch the wrapper's kernel
    exactly once (the route cuda) and agree with the kernel's plain version
    at the registry's tolerance. Their byte counts go beside."""
    k, n = matmul_shapes(cfg)["gate_up"]
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.02).cuda()
    a = torch.from_numpy(rng.normal(size=(8, k))).to("cuda", torch.bfloat16)
    for kernel, cls, plain in (
            ("palette", PaletteLinear, lambda lin: palette_matmul_ref(a, lin.packed, lin.lut)),
            ("sparse", SparseLinear, lambda lin: sparse_matmul_ref(a, lin.values,
                                                                  lin.selector))):
        lin = cls.pack(w)
        native.reset_launch_counts()
        out = lin(a)
        torch.cuda.synchronize()
        launched = native.launch_counts()[kernel]
        err, ok = _compare(out, plain(lin), registry.get(kernel).tol(torch.bfloat16))
        ok = ok and launched == 1
        emit("packed_linear", wrapper=cls.__name__, kernel=kernel, route="cuda",
             shape=[8, k, n], dtype="bfloat16", launches=launched, max_abs_err=err,
             tol=list(registry.get(kernel).tol(torch.bfloat16)), hbm_bytes=lin.hbm_bytes(),
             dense_bytes=lin.dense_bytes(), ok=ok)
        if not ok:
            failures.append(f"{cls.__name__}: {launched} launches, max abs err {err}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def decode_turn_inputs(cfg, rng) -> list[tuple[str, str, dict]]:
    """(kernel, shape label, inputs) of the decode and verify kernels for a
    `--turn`: decode at the serve phase's cache (tinyllama's heads, the wide
    heads, whisper's MHA), the paged decode on 8 lanes of 16 pages of 16 (the
    served arena's shape), the chain and tree verify windows."""
    w = configs.get_config(ENCODER_ARCH)
    cases = [("decode_attention", f"B=8 S={SERVE_MAX_LEN} H={h} KV={kvh} d={d}",
              decode_inputs(rng, 8, SERVE_MAX_LEN, h, kvh, d, serve_lens()))
             for d, (h, kvh) in DECODE_HEADS.items()]
    cases.append(("decode_attention", f"whisper B=8 S=160 H={w.n_heads} d={w.d_head}",
                  decode_inputs(rng, 8, 160, w.n_heads, w.n_heads, w.d_head,
                                serve_lens(ENCODER_LENS))))
    h, kvh = DECODE_HEADS[64]
    cases.append(("paged_decode_attention", f"B=8 H={h} KV={kvh} d=64 bs=16 nb=16",
                  registry.get("paged_decode_attention").make_inputs(
                      registry.ShapeCase("arena", (8, h, kvh, 160, 16, 16, 64, 256)),
                      torch.bfloat16, rng, "cuda")))
    for name, dims in (("specdec", (8, SPEC_DEPTH + 1, cfg.vocab)),
                       ("specdec_tree", (8, 2, SPEC_DEPTH + 1, cfg.vocab))):
        cases.append((name, "x".join(map(str, dims)), registry.get(name).make_inputs(
            registry.ShapeCase("main", dims), torch.float32, rng, "cuda")))
    return cases


def compare_turn(label: str, cfg) -> None:
    """One turn of a comparison of two checkouts of the port on one card:
    copy this file into the other checkout and run it with `--turn` from
    each in turns (parent, change, change, parent). Device times (CUDA-graph
    replay, L2 flushed) and output digests of the matmul kernels at
    tinyllama's projections on 8, 40, 80 and 512 rows, the fp32 head on 1
    and 8, whisper-small's two stem convs, the decode and verify kernels
    (`decode_turn_inputs`), act_lut at the stem's output and the pools at
    the pyramid's shapes (inputs from a fixed seed, so equal digests mean
    equal bits), the timer's floor, then the fp16, sparse and int4_palette
    serves with one profiled round each, the spec serves (self; shrink with
    two branches), the pooled prefix serve and the whisper-small serve with
    a profiled round. It uses only what every checkout of the port has."""
    rng = np.random.default_rng(11)
    timer = Timer()
    bf16 = torch.bfloat16

    def normal(shape, dtype, std=1.0):
        return torch.from_numpy(rng.normal(size=shape) * std).to("cuda", dtype)

    def record(name, shape, run):
        out = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()[:16]
        emit("turn_kernel", turn=label, kernel=name, shape=shape,
             ms=timer.device_ms(run), digest=digest)

    shapes = [(f"{lb} M={m}", m, k, n, bf16) for m in (8, 40, 80, 512)
              for lb, (k, n) in matmul_shapes(cfg).items()]
    shapes += [(f"head M={m}", m, cfg.d_model, cfg.padded_vocab, torch.float32) for m in (1, 8)]
    for shape, m, k, n, dtype in shapes:
        w = normal((k, n), torch.float32, k ** -0.5)
        a, b = normal((m, k), dtype), w.to(dtype)
        record("anemm", shape, lambda: anemm(a, b))
        for name, form in PACKED.items():
            i = {"a": a, **form.pack(w)}
            record(name, shape, lambda: registry.get(name).run_kernel(i))
    for conv, i in stem_conv_inputs(rng):
        record("conv2d", f"stem {conv}", lambda: registry.get("conv2d").run_kernel(i))
    for name, shape, i in decode_turn_inputs(cfg, rng):
        record(name, shape, lambda: KERNEL_CALLS[name](i))
    w = configs.get_config(ENCODER_ARCH)
    x = normal((w.frame_shape[0], w.d_model), bf16, 2.0)
    record("act_lut", f"gelu {tuple(x.shape)} bf16", lambda: lut_activation("gelu")(x))
    for name, (shape, window, stride, pad) in POOL_SHAPES.items():
        i = {"x": normal(shape, bf16), "window": window, "stride": stride, "padding": pad}
        record(name, f"{shape} {window[0]}x{window[1]} s{stride[0]} {pad} bf16",
               lambda: registry.get(name).run_kernel(i))
    time_floor(timer, rng, turn=label)
    for form in ("fp16", "sparse", "int4_palette"):
        emit("turn_serve", turn=label, weight_form=form)
        serve_main_path(form)
        profile_serve(form, serve_argv(cfg, 1, form))
    spec = serve_argv(cfg, SERVE_ROUNDS, "fp16", "spec") + ["--draft-depth", str(SPEC_DEPTH)]
    turn_serve(label, "spec self", spec + ["--draft", "self"])
    turn_serve(label, "spec shrink x2", spec + ["--draft", "shrink", "--draft-branches", "2"])
    turn_serve(label, "prefix pooled", prefix_argv(cfg, True), prompts=prefix_rounds(cfg))
    turn_serve(label, "encoder", encoder_argv(SERVE_ROUNDS))
    profile_serve(ENCODER_ARCH, encoder_argv(1))


def serve_steps_turn(label: str, cfg) -> None:
    """A short turn of a comparison of two checkouts (`--turn LABEL
    --serves-only`): the continuous serve of full tinyllama-1.1b in fp16
    and of mamba2-1.3b through the serve CLI (`turn_serve`: the decode
    step's median wall among them), for a change to the model's serving
    forward."""
    turn_serve(label, "fp16", serve_argv(cfg, SERVE_ROUNDS, "fp16"))
    turn_serve(label, "mamba2-1.3b",
               serve_argv(configs.get_config("mamba2-1.3b"), SERVE_ROUNDS, "fp16"))


def turn_serve(label: str, name: str, argv: list[str], prompts=None) -> None:
    """One serve of a `--turn` through the serve CLI's entry point: its
    tokens' digest, tok/s, compile seconds and graphs (where the checkout
    has them), dispatches and the median wall of each dispatch kind, and
    peak memory."""
    torch.cuda.reset_peak_memory_stats()
    out = serve.run(argv, prompts=prompts)
    engine, recs = out["engine"], out["records"]
    decode_key = recs[-1].key if out["schedule"] != "spec" else None
    kinds: dict[str, list[float]] = {}
    for r in recs:
        kind = ("draft" if r.key in getattr(engine, "_draft_keys", ()) else
                "verify" if r.key in getattr(engine, "_verify_keys", ()) else
                "decode" if r.key == decode_key else
                r.key if not re.fullmatch(r"[0-9a-f]{64}", r.key) else "program")
        kinds.setdefault(kind, []).append(r.wall_s)
    emit("turn_serve", turn=label, serve=name,
         tokens_sha256=hashlib.sha256(np.ascontiguousarray(out["tokens"]).tobytes())
         .hexdigest(), tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
         compile_s=out.get("compile_s"), captures=out.get("captures"),
         replays=out.get("replays"), cache_hits=out["cache_hits"],
         cache_misses=out["cache_misses"], n_dispatches=out["n_dispatches"],
         median_ms={k: statistics.median(w) * 1e3 for k, w in kinds.items()},
         prefix_cache=out.get("prefix_cache"),
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description="the port on one CUDA card (no arguments: "
                                     "every phase)")
    parser.add_argument("--turn", metavar="LABEL",
                        help="run only one turn of a comparison of two checkouts "
                             "(compare_turn), its records tagged LABEL")
    parser.add_argument("--serves-only", action="store_true",
                        help="with --turn: only the serve steps of full tinyllama-1.1b "
                             "(fp16) and mamba2-1.3b (serve_steps_turn)")
    args = parser.parse_args(argv)
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
    emit("build", seconds=built["seconds"], built=built["built"],
         ptxas={n: ptxas_report(txt) for n, txt in built["log"].items()})

    cfg = configs.get_config("tinyllama-1.1b")
    if args.turn is not None:
        (serve_steps_turn if args.serves_only else compare_turn)(args.turn, cfg)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
        return 0
    timer = Timer()
    headline = check_kernels(cfg, timer)
    check_parity()
    check_parity_encdec()
    check_parity_archs()
    check_rows(cfg)
    for name in ROWS_ARCHS:
        check_rows(*arch_config(name))
    check_sampling()
    check_graphs(cfg)
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
        run, _ = serve_spec(cfg, draft, branches, tokens["fp16"])
        if (draft, branches) == ("self", 1):
            launches["specdec"] = run["specdec"]
        if branches > 1:
            launches["specdec_tree"] = run["specdec_tree"]
    serve_slo(cfg, tokens["fp16"])
    serve_chunked(cfg)
    encoder_launches, encoder_tokens = serve_encoder(timer)
    launches.update(encoder_launches)
    serve_encoder_slo(encoder_tokens)
    serve_encoder_forms()
    serve_encoder_spec(encoder_tokens)
    arch_tokens = {name: serve_arch(name) for name, _ in ARCH_RUNS}
    for name in RECURRENT_ARCHS:
        serve_recurrent(name)
    serve_long_window()
    serve_mla(arch_tokens[MLA_ARCH])
    run_train_phase()
    run_distill_phase()
    emit("script", seconds=time.perf_counter() - T0)

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


def parity_case(cfg, form: str, kernel: str) -> None:
    """One smoke model, same weights, on the card (kernels) and on the CPU
    (plain versions), packed once on the CPU where `form` says so: prefill
    and three teacher-forced decode steps must agree at 4x the tolerance of
    `kernel`, the row that streams the weights; the card routes every
    matmul through `kernel` (and attention as `expected_routes` says). A
    sliding-window config prefills 8 tokens past its window, so the decode
    steps run the kernel over a ring that prefill rolled and decode wraps."""
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    params_cpu = cpu.init(torch.Generator().manual_seed(0))
    if form != "fp16":
        params_cpu = compress_model_params(params_cpu, form)
    params_gpu = tree_map(lambda t: t.to("cuda"), params_cpu)
    rtol, atol = (4 * x for x in registry.get(kernel).tol(gpu.dtype))
    prompt = cfg.attn_window + 8 if cfg.attn_window else 24
    tokens = torch.randint(0, cfg.vocab, (2, prompt), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    c_cpu, lg_cpu = cpu.prefill(params_cpu, {"tokens": tokens})
    c_gpu, lg_gpu = gpu.prefill(params_gpu, {"tokens": tokens.cuda()})
    errs = [float((lg_gpu.cpu() - lg_cpu).abs().max())]
    torch.testing.assert_close(lg_gpu.cpu(), lg_cpu, rtol=rtol, atol=atol)
    c_cpu = merge_prefill_caches(cpu.init_cache(2, prompt + 8), c_cpu)
    c_gpu = merge_prefill_caches(gpu.init_cache(2, prompt + 8), c_gpu)
    tok = lg_cpu[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
    for i in range(3):
        pos = torch.full((2,), prompt + i, dtype=torch.int32)
        c_cpu, d_cpu = cpu.decode_step(params_cpu, c_cpu, tok, pos)
        c_gpu, d_gpu = gpu.decode_step(params_gpu, c_gpu, tok.cuda(), pos.cuda())
        if not bool(torch.isfinite(d_gpu).all()):
            raise AssertionError(f"{cfg.name} {form} {cfg.dtype}: non-finite decode logits")
        errs.append(float((d_gpu.cpu() - d_cpu).abs().max()))
        torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=rtol, atol=atol)
        tok = d_cpu[:, -1, :cfg.vocab].argmax(-1).to(torch.int32)[:, None]
    routes = {k for k, _ in gpu.dispatcher.census()}
    if routes != expected_routes(cfg, kernel):
        raise AssertionError(f"{cfg.name} {form} {cfg.dtype}: card routes {routes}")
    emit("parity", config=cfg.name, weight_form=form, dtype=cfg.dtype, prompt=prompt,
         max_abs_err=max(errs), tol=[rtol, atol], ok=True)


def check_parity() -> None:
    """tinyllama-1.1b smoke, dense and in both packed forms, fp32 and
    bf16 (`parity_case`)."""
    for form, kernel in FORM_KERNEL.items():
        for dtype in ("float32", "bfloat16"):
            parity_case(dataclasses.replace(configs.get_smoke("tinyllama-1.1b"), dtype=dtype),
                        form, kernel)


def check_parity_archs() -> None:
    """Every arch of the archs phase, at smoke size (`parity_case`): in fp32
    and in its own dtype (bf16; float16 for ane-paper)."""
    for name, _ in ARCH_RUNS:
        cfg = configs.get_smoke(name)
        for dtype in ("float32", configs.get_config(name).dtype):
            parity_case(dataclasses.replace(cfg, dtype=dtype), "fp16", "anemm")


def graph_counts(tag: str, out: dict, named: tuple[str, ...]) -> dict:
    """On the card every program of a serve is captured on its first
    dispatch and replayed after: captures = misses, no recapture (no
    resident storage moves inside a serve), replays = the program dispatches
    (the records not named as lane writes) less the captures. Returns the
    graph fields of the serve's record; empty for a checkout of the port
    without graphs (a `--turn` in an older one)."""
    if "captures" not in out:
        return {}
    n_programs = sum(r.key not in named for r in out["records"])
    want = {"captures": out["cache_misses"], "recaptures": 0,
            "replays": n_programs - out["cache_misses"]}
    got = {k: out[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag} graphs {got}, expected {want}")
    return {"compile_s": out["compile_s"], **got,
            "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}


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
    graphs = graph_counts(f"{form} serve", out, NAMED_RECORDS)

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
         launches=launches, **graphs,
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


def prefix_serves(cfg) -> tuple[list, dict]:
    """Full tinyllama-1.1b (or `cfg`; fp16 form) through the serve CLI's
    entry point on the prefix phase's requests, with the paged pool and
    without: tokens in the vocab, routes cuda, launches exact, the pooled
    streams equal the pool-less ones, the pool's hits, misses and dispatches
    as the requests share their system prompt, the pool audited. A
    recurrent config's state rides the pool's anchors. Returns the rounds of
    prompts and the pooled run."""
    rounds = prefix_rounds(cfg)
    runs = {}
    for pooled in (False, True):
        tag = "pooled" if pooled else "pool-less"
        release_memory()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        out = serve.run(prefix_argv(cfg, pooled), prompts=rounds, cfg=cfg)
        launches = native.launch_counts()
        graphs = graph_counts(f"prefix {'pooled' if pooled else 'pool-less'}", out,
                              PREFIX_NAMED)
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
        flash, decode = attention_layers(cfg)
        want = {k: 0 for k in launches}
        want.update({"anemm": anemm_launches(cfg, counts["prefill"], counts["decode"]),
                     "flash": flash * counts["prefill"],
                     "decode_attention": decode * counts["decode"]})
        if launches != want:
            raise AssertionError(f"prefix {tag} launches {launches}, expected {want}")
        walls = {k: [r.wall_s for r, kind in zip(recs, kinds) if kind == k]
                 for k in counts if counts[k]}
        emit("prefix_serve", config=cfg.name, dtype=cfg.dtype, pooled=pooled,
             anchored_leaves=len(out["engine"].pool._anchor_paths) if pooled else None,
             lanes=len(PREFIX_LENS), system_prompt=PREFIX_SYSTEM, prompt_lens=PREFIX_LENS,
             gen=SERVE_GEN, rounds=PREFIX_ROUNDS, block_size=PREFIX_BLOCK,
             blocks=PREFIX_BLOCKS, tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
             n_dispatches=out["n_dispatches"], dispatch_counts=counts,
             median_ms={k: statistics.median(w) * 1e3 for k, w in walls.items()},
             wall_s_by_kind={k: sum(w) for k, w in walls.items()},
             prefix_cache=out.get("prefix_cache"), cache_hits=out["cache_hits"],
             cache_misses=out["cache_misses"], floor_measured_s=out["floor_measured_s"],
             routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
             launches=launches, **graphs,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
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
    return rounds, pooled


def serve_prefix(cfg, timer) -> tuple[dict, int]:
    """The prefix phase's serves (`prefix_serves`), then
    `paged_decode_attention` on every layer's slice of the pool's served
    arena. Returns the paged kernel's headline record and its launches in
    that check."""
    rounds, pooled = prefix_serves(cfg)
    pool = pooled["pool"]

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


def serve_argv(cfg, rounds: int, form: str, schedule: str = "continuous",
               lens: str = SERVE_LENS) -> list[str]:
    return ["--arch", cfg.name, "--schedule", schedule, "--batch", "8",
            "--prompt-lens", lens, "--gen", str(SERVE_GEN),
            "--requests", str(rounds), "--seed", "0", "--device", "cuda",
            "--weight-form", form]


def check_rows(cfg, reduced: dict | None = None) -> None:
    """Decode steps of a full-width model on 8 lanes, and on the same 8
    lanes twice over: the first 8 rows' logits must agree bit for bit, or a
    16-row tree verify window could pick other tokens than 8-row decode.
    Run for full tinyllama-1.1b and for the archs whose arithmetic adds
    something per row: granite-8b's 4,096-wide rows, chameleon-34b's
    QK-norm at 8,192 and dbrx-132b's router and combine at 6,144 (the norms
    of rows wider than 2,048 reduce as a pairwise tree; `reduced`: the depth
    cut of a config that does not fit whole)."""
    release_memory()
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
    emit("rows", config=cfg.name, n_layers=cfg.n_layers, reduced=reduced,
         steps=tokens.shape[1], rows=[8, 16], max_abs_err=err, ok=err == 0.0)
    if err != 0.0:
        raise AssertionError(f"{cfg.name}: decode logits at 16 rows differ from 8 rows by {err}")
    del model, params


def release_memory() -> None:
    """Drop what earlier phases left for the collector (engines, their
    graphs and private pools) and return the allocator's cached blocks, so
    a large model starts from an empty card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the graphs phase: every captured program kind, replay against eager
# ---------------------------------------------------------------------------


def _tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def _clone_tree(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _random_cache(caches, gen) -> None:
    """Fill a decode cache in place: random K/V, every slot valid at its own
    index (a lane at position p attends slots 0..p)."""
    for leaf in _tree_leaves(caches):
        if leaf.dtype == torch.int32:
            leaf.copy_(torch.arange(leaf.shape[-1], dtype=torch.int32,
                                    device=leaf.device).expand(leaf.shape))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=leaf.device).to(leaf))


def check_graph_replays(label: str, prog, make_args, mutable: tuple[int, ...],
                        replays: int = 2) -> dict:
    """Call `prog` (a `GraphProgram`) once (eager run and capture), then
    `replays` times with new per-call inputs (`make_args(i)`): each replay's
    outputs, the resident arguments it writes (`mutable`) and its launches
    must equal, bit for bit and to the unit, an eager call of the same
    function on the same inputs (the written arguments cloned first)."""
    if not isinstance(prog, dispatch.GraphProgram):
        raise AssertionError(f"graphs {label}: {type(prog).__name__} is no GraphProgram")
    stats = prog.stats
    before = (stats.captures, stats.replays)
    prog(*make_args(0))
    if stats.captures != before[0] + 1:
        raise AssertionError(f"graphs {label}: the first call did not capture")
    for i in range(1, replays + 1):
        args = make_args(i)
        eager_args = tuple(_clone_tree(a) if j in mutable else a for j, a in enumerate(args))
        native.reset_launch_counts()
        want = prog.fn(*eager_args)
        torch.cuda.synchronize()
        want_launches = native.launch_counts()
        native.reset_launch_counts()
        got = prog(*args)
        torch.cuda.synchronize()
        got_launches = native.launch_counts()
        pairs = list(zip(_tree_leaves(got), _tree_leaves(want)))
        pairs += [pair for j in mutable
                  for pair in zip(_tree_leaves(args[j]), _tree_leaves(eager_args[j]))]
        same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                   for a, b in pairs)
        if not same or got_launches != want_launches:
            raise AssertionError(f"graphs {label} replay {i}: bit_identical={same}, "
                                 f"launches {got_launches} against eager {want_launches}")
    if (stats.captures, stats.replays) != (before[0] + 1, before[1] + replays):
        raise AssertionError(f"graphs {label}: captures {stats.captures}, replays "
                             f"{stats.replays} (before {before})")
    rec = {"program": label, "replays": replays, "bit_identical": True,
           "launches_per_call": {k: n for k, n in got_launches.items() if n}}
    emit("graphs", **rec)
    return rec


class DotCapture:
    """`core.dispatch._capture` with the graph's node list kept: each graph
    is dumped as DOT, so the graphs phase can show that no host-to-device
    copy landed in a graph (it would replay from a host buffer that is long
    gone). PyTorch refuses to capture a copy from pageable memory; a copy
    from pinned memory would be captured, and its node reads "HtoD"."""

    def __init__(self, directory: Path) -> None:
        self.directory = directory
        self.memcpy: list[str] = []
        self.graphs = 0

    def __call__(self, fn, args, device):
        graph = torch.cuda.CUDAGraph(keep_graph=True)     # kept for the dump
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            graph.capture_begin()
            out = fn(*args)
            graph.capture_end()
        current.wait_stream(side)
        path = self.directory / f"graph{self.graphs}.dot"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # the dump announces itself
            graph.debug_dump(str(path))
        self.memcpy += re.findall(r"MEMCPY[^\"]*", path.read_text())
        path.unlink()
        self.graphs += 1
        return graph, out


def check_graphs(cfg) -> None:
    """Every program kind the serves capture, at full width and depth, held
    replay against eager (`check_graph_replays`): tinyllama-1.1b prefill at
    buckets 8 and 64 and the 8-lane decode step; the spec draft and verify
    at K = 1 and 4 (shrink drafter), the tree draft and verify at K = 4 with
    two branches, the joint catch-up step and the joint prefill; then
    whisper-small's prefill (frames through the stem and the encoder) and
    decode step; then, whole, recurrentgemma-9b's and mamba2-1.3b's prefill
    and decode step, their spec verify at K = 4 (per-step copies of the
    recurrent state, each lane's kept at its accept point), mamba2's tree
    verify and its chunk program (`run_recurrent_graph_checks`). Every
    graph is dumped (`DotCapture`): none may hold a copy from host memory."""
    dump_dir = ROOT / "build" / "graphs"
    dump_dir.mkdir(parents=True, exist_ok=True)
    dot = DotCapture(dump_dir)
    real_capture, dispatch._capture = dispatch._capture, dot
    try:
        run_graph_checks(cfg)
        for name in RECURRENT_ARCHS:
            release_memory()
            run_recurrent_graph_checks(configs.get_config(name))
    finally:
        dispatch._capture = real_capture
    host = [m for m in dot.memcpy if "Host" in m or "HtoD" in m]
    emit("graphs_copies", graphs=dot.graphs, memcpy_nodes=len(dot.memcpy),
         memcpy_kinds=sorted({m[:160] for m in dot.memcpy})[:8], host_to_device=len(host))
    if host or not dot.graphs:
        raise AssertionError(f"graphs: {len(host)} host copies in {dot.graphs} graphs: "
                             f"{host[:2]}")


def run_graph_checks(cfg) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    vocab = cfg.vocab

    def tokens(shape):
        return torch.randint(0, vocab, shape, generator=gen, device="cuda", dtype=torch.int32)

    def positions(lo, hi):
        return torch.randint(lo, hi, (8,), generator=gen, device="cuda", dtype=torch.int32)

    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = ProgramCache()
    for bucket in (8, 64):
        batch = {"tokens": tokens((1, bucket))}
        prog, _ = cache.compile(model.prefill, params, batch, per_call=(1,))
        check_graph_replays(f"tinyllama prefill bucket {bucket}", prog,
                            lambda i, b=bucket: (params, {"tokens": tokens((1, b))}), ())
    caches = model.init_cache(8, SERVE_MAX_LEN)
    _random_cache(caches, gen)
    tok, pos = tokens((8, 1)), positions(32, SERVE_MAX_LEN - 8)
    prog, _ = cache.compile(model.decode_step, params, caches, tok, pos, per_call=(2, 3))
    check_graph_replays("tinyllama decode", prog,
                        lambda i: (params, caches, tokens((8, 1)),
                                   positions(32, SERVE_MAX_LEN - 8)), (1,))

    sched = SpeculativeSchedule(model, params, cfg, n_slots=8, max_len=SERVE_MAX_LEN,
                                stream=AsyncExecutionStream(cache, device="cuda"),
                                draft="shrink", draft_branches=2, draft_depth=SPEC_DEPTH)
    sched._ensure_caches()
    sched.draft_caches = sched.drafter.model.init_cache(8, SERVE_MAX_LEN)
    _random_cache(sched.caches, gen)
    _random_cache(sched.draft_caches, gen)
    dparams = sched.drafter.params

    def p0():
        return positions(32, SERVE_MAX_LEN - 2 * SPEC_DEPTH)

    def rids():
        return torch.randint(0, 2 ** 31 - 1, (8,), generator=gen, device="cuda",
                             dtype=torch.int32)

    rid = rids()
    for k in (1, SPEC_DEPTH):
        prog, _ = sched._draft_program(tok, pos, rid, k)
        check_graph_replays(f"spec draft K={k}", prog,
                            lambda i: (dparams, sched.draft_caches, tokens((8, 1)), p0(),
                                       rids()), (1,))
        prog, _ = sched._verify_program(tok, pos, tokens((8, k)), rid, k)
        check_graph_replays(f"spec verify K={k}", prog,
                            lambda i, k=k: (params, sched.caches, tokens((8, 1)), p0(),
                                            tokens((8, k)), rids()), (1,))
    k, nbr = SPEC_DEPTH, 2
    prog, _ = sched._draft_tree_program(tok, pos, rid, k)
    check_graph_replays(f"spec tree draft K={k} x{nbr}", prog,
                        lambda i: (dparams, sched.draft_caches, tokens((8, 1)), p0(), rids()),
                        (1,))

    def tiled():
        return tree_map(lambda leaf: leaf.repeat_interleave(nbr, dim=1), sched.draft_caches)

    prog, _ = sched._verify_tree_program(tiled(), tok, pos, tokens((8, nbr, k)), rid, k)
    check_graph_replays(f"spec tree verify K={k} x{nbr}", prog,
                        lambda i: (params, sched.caches, sched.draft_caches, tiled(),
                                   tokens((8, 1)), p0(), tokens((8, nbr, k)), rids()), (1, 2))
    prog, _ = sched._joint_program(tok, pos)
    check_graph_replays("spec joint catch-up", prog,
                        lambda i: (params, dparams, sched.caches, sched.draft_caches,
                                   tokens((8, 1)), p0()), (2, 3))
    batch = {"tokens": tokens((1, 64))}
    prog, _ = cache.compile(sched._joint_prefill_fn, params, dparams, batch, per_call=(2,))
    check_graph_replays("spec joint prefill bucket 64", prog,
                        lambda i: (params, dparams, {"tokens": tokens((1, 64))}), ())
    sched.stream.close()

    # seeded categorical windows: the threefry and gumbel ops inside graphs
    csched = SpeculativeSchedule(model, params, cfg, n_slots=8, max_len=SERVE_MAX_LEN,
                                 stream=AsyncExecutionStream(cache, device="cuda"),
                                 sampling="categorical", drafter=sched.drafter,
                                 draft_branches=2, draft_depth=SPEC_DEPTH)
    csched.caches, csched.draft_caches = sched.caches, sched.draft_caches
    prog, _ = csched._draft_program(tok, pos, rid, k)
    check_graph_replays(f"spec categorical draft K={k}", prog,
                        lambda i: (dparams, csched.draft_caches, tokens((8, 1)), p0(), rids()),
                        (1,))
    prog, _ = csched._verify_program(tok, pos, tokens((8, k)), rid, k)
    check_graph_replays(f"spec categorical verify K={k}", prog,
                        lambda i: (params, csched.caches, tokens((8, 1)), p0(),
                                   tokens((8, k)), rids()), (1,))
    prog, _ = csched._draft_tree_program(tok, pos, rid, k)
    check_graph_replays(f"spec categorical tree draft K={k} x{nbr}", prog,
                        lambda i: (dparams, csched.draft_caches, tokens((8, 1)), p0(), rids()),
                        (1,))
    csched.stream.close()

    # the SLO schedule's fused step (decode and the draw), both samplings
    for sampling in ("greedy", "categorical"):
        slo = SLOSchedule(model, params, cfg, n_slots=8, max_len=SERVE_MAX_LEN,
                          sampling=sampling, stream=AsyncExecutionStream(cache, device="cuda"))
        slo.caches = sched.caches
        forced, mask = tokens((8,)), torch.rand(8, generator=gen, device="cuda") < 0.5
        prog, _ = slo._fused_step_program(slo.caches, tok, pos, forced, mask, rid)
        check_graph_replays(
            f"slo step {sampling}", prog,
            lambda i: (params, slo.caches, tokens((8, 1)), positions(32, SERVE_MAX_LEN - 8),
                       tokens((8,)), torch.rand(8, generator=gen, device="cuda") < 0.5,
                       rids()), (1,))
        slo.stream.close()

    # the chunk program: one graph whichever lane's staging row it writes
    chunked = ContinuousSchedule(model, params, cfg, n_slots=8, max_len=SERVE_MAX_LEN,
                                 prefill_chunk=CHUNK_SIZE,
                                 stream=dispatch.ExecutionStream(cache, device="cuda"))
    chunked._ensure_caches()
    _random_cache(chunked.staging, gen)

    def lane():
        return torch.randint(0, 8, (1,), generator=gen, device="cuda", dtype=torch.long)

    def chunk_start():
        return torch.randint(0, 6, (1,), generator=gen, device="cuda",
                             dtype=torch.int32) * CHUNK_SIZE

    prog, _ = chunked._chunk_program(tokens((1, CHUNK_SIZE)), chunk_start(), lane())
    check_graph_replays(f"chunk C={CHUNK_SIZE}", prog,
                        lambda i: (params, chunked.staging, tokens((1, CHUNK_SIZE)),
                                   chunk_start(), lane()), (1,))
    del sched, csched, slo, chunked, model, params, caches

    wcfg = configs.get_config(ENCODER_ARCH)
    wmodel = build_model(wcfg, KernelDispatcher(), device="cuda")
    wparams = wmodel.init(torch.Generator(device="cuda").manual_seed(0))

    def wbatch(n):
        return {"tokens": torch.randint(0, wcfg.vocab, (1, n), generator=gen, device="cuda",
                                        dtype=torch.int32),
                "frames": torch.randn((1,) + wcfg.frame_shape, generator=gen,
                                      device="cuda").to(wmodel.dtype)}

    prog, _ = cache.compile(wmodel.prefill, wparams, wbatch(16), per_call=(1,))
    check_graph_replays("whisper prefill bucket 16", prog,
                        lambda i: (wparams, wbatch(16)), ())
    wcaches = wmodel.init_cache(8, 160)
    _random_cache(wcaches, gen)
    wtok = torch.randint(0, wcfg.vocab, (8, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    wpos = torch.full((8,), 100, dtype=torch.int32, device="cuda")
    prog, _ = cache.compile(wmodel.decode_step, wparams, wcaches, wtok, wpos,
                            per_call=(2, 3))
    check_graph_replays(
        "whisper decode", prog,
        lambda i: (wparams, wcaches,
                   torch.randint(0, wcfg.vocab, (8, 1), generator=gen, device="cuda",
                                 dtype=torch.int32),
                   torch.randint(16, 150, (8,), generator=gen, device="cuda",
                                 dtype=torch.int32)), (1,))
    st = cache.stats
    emit("graphs_summary", captures=st.captures, replays=st.replays,
         recaptures=st.recaptures, compile_s=st.compile_seconds,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if st.recaptures:
        raise AssertionError(f"graphs: {st.recaptures} recaptures")


def run_recurrent_graph_checks(cfg) -> None:
    """A recurrent config whole (`check_graph_replays`): prefill at bucket
    64, the 8-lane decode step (the RG-LRU's h and the SSM's state written
    in place), the spec verify at K = 4 with the shrink drafter (the K
    per-step copies of every recurrent leaf live inside the graph), for
    mamba2 the tree verify at K = 4 with two branches and the chunk program
    (C = 64). Random caches and positions; every replay equals an eager
    call bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    tag = cfg.name.split("-")[0]

    def tokens(shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def positions(lo, hi):
        return torch.randint(lo, hi, (8,), generator=gen, device="cuda", dtype=torch.int32)

    def rids():
        return torch.randint(0, 2 ** 31 - 1, (8,), generator=gen, device="cuda",
                             dtype=torch.int32)

    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = ProgramCache()
    prog, _ = cache.compile(model.prefill, params, {"tokens": tokens((1, 64))}, per_call=(1,))
    check_graph_replays(f"{tag} prefill bucket 64", prog,
                        lambda i: (params, {"tokens": tokens((1, 64))}), ())
    caches = model.init_cache(8, SERVE_MAX_LEN)
    _random_cache(caches, gen)
    tok, pos = tokens((8, 1)), positions(32, SERVE_MAX_LEN - 8)
    prog, _ = cache.compile(model.decode_step, params, caches, tok, pos, per_call=(2, 3))
    check_graph_replays(f"{tag} decode", prog,
                        lambda i: (params, caches, tokens((8, 1)),
                                   positions(32, SERVE_MAX_LEN - 8)), (1,))
    del prog, caches
    release_memory()

    k, nbr = SPEC_DEPTH, 2
    sched = SpeculativeSchedule(model, params, cfg, n_slots=8, max_len=SERVE_MAX_LEN,
                                stream=AsyncExecutionStream(cache, device="cuda"),
                                draft="shrink", draft_branches=nbr, draft_depth=k)
    sched._ensure_caches()
    sched.draft_caches = sched.drafter.model.init_cache(8, SERVE_MAX_LEN)
    _random_cache(sched.caches, gen)
    _random_cache(sched.draft_caches, gen)

    def p0():
        return positions(32, SERVE_MAX_LEN - 2 * k)

    prog, _ = sched._verify_program(tok, pos, tokens((8, k)), rids(), k)
    check_graph_replays(f"{tag} spec verify K={k}", prog,
                        lambda i: (params, sched.caches, tokens((8, 1)), p0(),
                                   tokens((8, k)), rids()), (1,))
    if cfg.family == "ssm":
        def tiled():
            return tree_map(lambda leaf: leaf.repeat_interleave(nbr, dim=1),
                            sched.draft_caches)

        prog, _ = sched._verify_tree_program(tiled(), tok, pos, tokens((8, nbr, k)), rids(), k)
        check_graph_replays(f"{tag} spec tree verify K={k} x{nbr}", prog,
                            lambda i: (params, sched.caches, sched.draft_caches, tiled(),
                                       tokens((8, 1)), p0(), tokens((8, nbr, k)), rids()),
                            (1, 2))
        chunked = ContinuousSchedule(model, params, cfg, n_slots=8, max_len=SERVE_MAX_LEN,
                                     prefill_chunk=CHUNK_SIZE,
                                     stream=dispatch.ExecutionStream(cache, device="cuda"))
        chunked._ensure_caches()
        _random_cache(chunked.staging, gen)

        def lane():
            return torch.randint(0, 8, (1,), generator=gen, device="cuda", dtype=torch.long)

        def chunk_start():
            return torch.randint(0, 6, (1,), generator=gen, device="cuda",
                                 dtype=torch.int32) * CHUNK_SIZE

        prog, _ = chunked._chunk_program(tokens((1, CHUNK_SIZE)), chunk_start(), lane())
        check_graph_replays(f"{tag} chunk C={CHUNK_SIZE}", prog,
                            lambda i: (params, chunked.staging, tokens((1, CHUNK_SIZE)),
                                       chunk_start(), lane()), (1,))
    sched.stream.close()
    st = cache.stats
    emit("graphs_recurrent", config=cfg.name, captures=st.captures, replays=st.replays,
         recaptures=st.recaptures, compile_s=st.compile_seconds,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    if st.recaptures:
        raise AssertionError(f"graphs {cfg.name}: {st.recaptures} recaptures")


def serve_spec(cfg, draft: str, branches: int, want_tokens: np.ndarray,
               sampling: str = "greedy", lens: str = SERVE_LENS,
               rounds: int = SERVE_ROUNDS, extra: tuple[str, ...] = (),
               prompts: list[list[np.ndarray]] | None = None,
               draft_form: str = "fp16", label: str = "") -> tuple[dict, dict]:
    """Full tinyllama-1.1b (or `cfg`, in its own dtype; fp16 form) through
    the speculative schedule with `draft` and `branches` on the serve
    phase's prompts (or `lens`, or the given rounds of `prompts`), `rounds`
    rounds, `extra` added to the CLI's argv (`--ckpt`, `--draft-ckpt`);
    returns (the launch counts of this run alone, the run's output), after
    checking the tokens against the continuous run's, the routes, the
    acceptance, the dispatches per window and every kernel's launches:
    anemm once per matmul of every forward of the target, the drafter's
    form's kernel (`draft_form`: a packed `--draft-ckpt`) once per matmul
    of every drafter forward (`matmuls_per_forward`), flash once per
    flash-prefilled layer of either model per admission prefill,
    decode_attention once per attention layer of every decode forward of
    either model (`attention_layers`), specdec once per chain window and
    specdec_tree once per tree window. A random-init shrink drafter (no
    `--draft-ckpt`) must be rejected somewhere."""
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    if draft == "early_exit":
        out = serve_early_exit(cfg, branches)
    else:
        out = serve.run(serve_argv(cfg, rounds, "fp16", "spec", lens=lens) + [
            "--draft", draft, "--draft-branches", str(branches),
            "--draft-depth", str(SPEC_DEPTH), "--sampling", sampling, *extra], cfg=cfg,
            prompts=prompts)
    if prompts is not None:
        lens, rounds = ",".join(str(len(p)) for p in prompts[0]), len(prompts)
    launches = native.launch_counts()
    engine = out["engine"]
    tag = f"spec {draft} x{branches}" + ("" if sampling == "greedy" else f" {sampling}") \
        + (f" {label}" if label else "")
    graphs = graph_counts(tag, out, ("spec_admit_slot", "spec_reset_slot"))
    if not np.array_equal(out["tokens"], want_tokens):
        bad = int((out["tokens"] != want_tokens).any(axis=1).sum())
        raise AssertionError(f"{tag}: {bad} of {len(want_tokens)} streams differ from the "
                             "continuous run's")
    backends = {b for _, b in out["routes"]}
    if backends != {"cuda"}:
        raise AssertionError(f"{tag} routes {out['routes']}: every route must be cuda")
    if draft == "self" and out["acceptance_rate"] != 1.0:
        raise AssertionError(f"{tag}: acceptance {out['acceptance_rate']}, want 1.0")
    if draft == "shrink" and "--draft-ckpt" not in extra \
            and not out["accepted"] < out["proposed"]:
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
    dcfg = engine.drafter.cfg
    l_d = dcfg.n_layers
    (flash_t, attn_t), (flash_d, attn_d) = attention_layers(cfg), attention_layers(dcfg)
    t_fwd = n_prefill + out["catchup_steps"] + out["verify_steps"]
    d_fwd = n_prefill + out["catchup_steps"] + out["draft_steps"]
    want = {k: 0 for k in launches}
    want.update({"anemm": anemm_launches(cfg, n_prefill, t_fwd - n_prefill),
                 "flash": (flash_t + flash_d) * n_prefill,
                 "decode_attention": attn_t * (t_fwd - n_prefill) + attn_d * (d_fwd - n_prefill),
                 "specdec": kinds.get("chain", 0), "specdec_tree": kinds.get("tree", 0)})
    want[FORM_KERNEL[draft_form]] += anemm_launches(dcfg, n_prefill, d_fwd - n_prefill)
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    walls = {"draft": [r.wall_s for r in recs if r.key in engine._draft_keys],
             "verify": [r.wall_s for r in recs if r.key in engine._verify_keys]}
    emit("spec", config=cfg.name, dtype=cfg.dtype, weight_form="fp16", drafter=draft,
         sampling=sampling, run=label or None, draft_form=draft_form,
         drafter_trained=engine.drafter.trained,
         drafter_layers=l_d, draft_branches=branches, draft_depth=SPEC_DEPTH,
         lanes=len(want_tokens), prompt_lens=lens, gen=SERVE_GEN, rounds=rounds,
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
         launches=launches, **graphs,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return launches, out


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
    st = cache.stats
    return {"tokens": np.stack([r.tokens for r in results]), "engine": engine,
            "routes": model.dispatcher.census(), "records": list(stream.records),
            "wall_s": wall, "compile_s": st.compile_seconds,
            "tok_per_s": SERVE_GEN * n_requests / max(wall - st.compile_seconds, 1e-9),
            "cache_hits": st.hits, "cache_misses": st.misses, "captures": st.captures,
            "recaptures": st.recaptures, "replays": st.replays,
            **engine.stats(n_requests)}


# ---------------------------------------------------------------------------
# the sampling, slo and chunked phases
# ---------------------------------------------------------------------------


def check_sampling() -> None:
    """jax's threefry chain (`core.prng`) on the card against the same code
    on the CPU: the known key data of PRNGKey(0) -> fold_in(3) ->
    fold_in(17); the (rid, pos) keys, 32-bit bits and uniforms of 8 rows of
    32000 bit for bit; gumbel within 1e-6; the categorical draws over (8,
    32000) fp32 rows equal, and the `TokenSampler`'s on the card equal to
    its own on the CPU. Gumbel is held within rtol = atol = 1e-6 (its
    largest values, ~16, have an ulp of ~1e-6)."""
    known = prng.fold_in(prng.fold_in(prng.seed_key(0, "cuda"), 3), 17).cpu().tolist()
    if known != [667729679, 229813208]:
        raise AssertionError(f"sampling: PRNGKey(0) -> fold_in(3) -> fold_in(17) = {known}")
    rids = torch.arange(SAMPLING_ROWS) * 7 + 1
    positions = torch.arange(SAMPLING_ROWS) * 131 + 5
    root = prng.seed_key(0)
    keys = prng.request_keys(root, rids, positions)
    keys_gpu = prng.request_keys(root.cuda(), rids.cuda(), positions.cuda())
    n = SAMPLING_VOCAB
    bits_eq = torch.equal(prng.random_bits32(keys_gpu, n).cpu(), prng.random_bits32(keys, n))
    unif_eq = torch.equal(prng.uniform(keys_gpu, n).cpu(), prng.uniform(keys, n))
    g_gpu, g_cpu = prng.gumbel(keys_gpu, n).cpu(), prng.gumbel(keys, n)
    gumbel_err = float((g_gpu - g_cpu).abs().max())
    gumbel_ok = bool(torch.allclose(g_gpu, g_cpu, rtol=GUMBEL_TOL, atol=GUMBEL_TOL))
    rows = torch.randn((SAMPLING_ROWS, n), generator=torch.Generator().manual_seed(6)) * 2
    draws_cpu = prng.categorical(keys, rows)
    draws_gpu = prng.categorical(keys_gpu, rows.cuda()).cpu()
    picks_gpu = TokenSampler("categorical", n, seed=0, device="cuda").pick(
        rows.cuda(), rids.tolist(), positions.tolist())
    picks_cpu = TokenSampler("categorical", n, seed=0).pick(rows, rids.tolist(),
                                                            positions.tolist())
    ok = (torch.equal(keys_gpu.cpu(), keys) and bits_eq and unif_eq
          and gumbel_ok and torch.equal(draws_gpu, draws_cpu)
          and np.array_equal(picks_gpu, picks_cpu) and np.array_equal(picks_cpu, draws_cpu))
    emit("sampling", known_answer=known, rows=SAMPLING_ROWS, vocab=n,
         keys_bit_identical=torch.equal(keys_gpu.cpu(), keys), bits_bit_identical=bits_eq,
         uniforms_bit_identical=unif_eq, gumbel_max_abs_err=gumbel_err,
         gumbel_tol={"rtol": GUMBEL_TOL, "atol": GUMBEL_TOL},
         draws_equal=torch.equal(draws_gpu, draws_cpu),
         sampler_equal=bool(np.array_equal(picks_gpu, picks_cpu)), ok=ok)
    if not ok:
        raise AssertionError("sampling: the card's threefry draws differ from the CPU's")


def step_counts(out: dict, decode_keys) -> tuple[int, int, int]:
    """(prefill, chunk, decode) program dispatches of a serve's records."""
    engine = out["engine"]
    chunk_keys = getattr(engine, "_chunk_keys", set())
    n_chunk = sum(r.key in chunk_keys for r in out["records"])
    n_decode = sum(r.key in decode_keys for r in out["records"])
    n_prefill = sum(r.key not in NAMED_RECORDS and r.key not in chunk_keys
                    and r.key not in decode_keys for r in out["records"])
    return n_prefill, n_chunk, n_decode


def check_serve_launches(tag: str, cfg, launches: dict, n_prefill: int, n_chunk: int,
                         n_decode: int) -> None:
    """A decoder's serve: anemm once per matmul of every forward
    (`matmuls_per_forward`; a chunk is a forward), flash once per
    flash-prefilled layer of every prefill, decode_attention once per
    attention layer of every decode step (`attention_layers`; a chunk
    attends in plain PyTorch); nothing else."""
    flash, decode = attention_layers(cfg)
    want = {k: 0 for k in launches}
    want.update({"anemm": anemm_launches(cfg, n_prefill, n_chunk + n_decode),
                 "flash": flash * n_prefill, "decode_attention": decode * n_decode})
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")


def digest(tokens: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(tokens).tobytes()).hexdigest()


def serve_schedule(cfg, tag: str, argv: list[str], want_tokens: np.ndarray | None,
                   prompts: list[list[np.ndarray]] | None = None) -> dict:
    """One serve of full tinyllama-1.1b (fp16 form) through the CLI's entry
    point (on the given rounds of `prompts`, if any), checked: tokens equal
    `want_tokens` (when given), every route cuda, captures = misses with no
    recapture, exact launches; the decode steps are the slo schedule's
    fused programs or the continuous decode program. Returns the run's
    output."""
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    out = serve.run(argv, prompts=prompts)
    launches = native.launch_counts()
    engine = out["engine"]
    graphs = graph_counts(tag, out, NAMED_RECORDS)
    if want_tokens is not None and not np.array_equal(out["tokens"], want_tokens):
        bad = int((out["tokens"] != want_tokens).any(axis=1).sum())
        raise AssertionError(f"{tag}: {bad} of {len(want_tokens)} streams differ")
    if {b for _, b in out["routes"]} != {"cuda"}:
        raise AssertionError(f"{tag} routes {out['routes']}: every route must be cuda")
    decode_keys = getattr(engine, "_decode_keys", None) or \
        {k for _, k in engine._decode_memo.values()}
    n_prefill, n_chunk, n_decode = step_counts(out, decode_keys)
    check_serve_launches(tag, cfg, launches, n_prefill, n_chunk, n_decode)
    steps = [r for r in out["records"] if r.key in decode_keys]
    walls = [r.wall_s for r in steps]
    # a pipelined step's record wall includes its wait behind the steps
    # ahead of it: the gap between completions is the step's own time
    done = sorted(r.complete_ts for r in steps)
    gaps = [b - a for a, b in zip(done, done[1:])]
    emit("slo_serve", run=tag, config=cfg.name, dtype=cfg.dtype, schedule=out["schedule"],
         sampling=out["sampling"], lanes=len(out["tokens"]),
         prompt_lens=SERVE_LENS if prompts is None else ",".join(str(len(p))
                                                                 for p in prompts[0]),
         gen=SERVE_GEN, tokens_sha256=digest(out["tokens"]), tok_per_s=out["tok_per_s"],
         wall_s=out["wall_s"], decode_steps=n_decode, prefills=n_prefill,
         decode_median_ms=statistics.median(walls) * 1e3 if walls else None,
         decode_gap_median_ms=statistics.median(gaps) * 1e3 if gaps else None,
         mean_inflight_depth=out.get("mean_inflight_depth"),
         deferred_admissions=out.get("deferred_admissions"),
         predicted_token_latency_s=out.get("predicted_token_latency_s"),
         acceptance_rate=out.get("acceptance_rate"), n_dispatches=out["n_dispatches"],
         cache_hits=out["cache_hits"], cache_misses=out["cache_misses"],
         launches=launches, **graphs, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def serve_slo(cfg, greedy_tokens: np.ndarray) -> None:
    """Full tinyllama-1.1b (fp16 form), the serve phase's 8 lanes and
    prompts, through the slo schedule: greedy streams equal to the
    continuous run's; a profiled round; an SLO tight enough to defer every
    admission into a busy engine, with the same streams; then seeded
    categorical streams equal under the continuous, slo and spec schedules
    (the self drafter's chain windows and the shrink drafter's 2-branch
    tree windows), and a profiled categorical slo round (the draw's device
    time beside the greedy round's)."""
    slo_argv = serve_argv(cfg, SERVE_ROUNDS, "fp16", "slo")
    serve_schedule(cfg, "slo greedy", slo_argv, greedy_tokens)
    profile_serve("slo", serve_argv(cfg, 1, "fp16", "slo"))
    tight = serve_schedule(cfg, "slo greedy deferred",
                           slo_argv + ["--slo-ms", str(SLO_TIGHT_MS)], greedy_tokens)
    if tight["deferred_admissions"] <= 0:
        raise AssertionError(f"slo --slo-ms {SLO_TIGHT_MS}: no admission was deferred")
    cat = ["--sampling", "categorical"]
    want = serve_schedule(cfg, "continuous categorical",
                          serve_argv(cfg, SERVE_ROUNDS, "fp16") + cat, None)["tokens"]
    if np.array_equal(want, greedy_tokens):
        raise AssertionError("categorical streams equal the greedy ones: nothing was drawn")
    serve_schedule(cfg, "slo categorical", slo_argv + cat, want)
    profile_serve("slo categorical", serve_argv(cfg, 1, "fp16", "slo") + cat)
    for draft, branches in (("self", 1), ("shrink", 2)):
        serve_spec(cfg, draft, branches, want, sampling="categorical")


def chunked_requests(cfg, rid0: int = 0) -> list[Request]:
    """7 running lanes (the serve's first 7 prompts) and one 512-token
    prompt arriving at step CHUNK_ARRIVAL, drawn from seed 0."""
    rng = np.random.default_rng(0)
    lens = [int(x) for x in SERVE_LENS.split(",")][:7] + [CHUNK_LONG]
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    return [Request(rid0 + i, p, CHUNK_RUNNING_GEN if i < 7 else SERVE_GEN,
                    arrival=CHUNK_ARRIVAL if i == 7 else 0) for i, p in enumerate(prompts)]


def decode_keys_of(engine) -> set:
    """The program keys of an engine's decode steps (the slo schedule's
    fused steps, or the decode program)."""
    return getattr(engine, "_decode_keys", None) or \
        {k for _, k in engine._decode_memo.values()}


def arrival_gaps_ms(engine, records, first_admission_seq: int) -> list[float]:
    """The running lanes' gaps between tokens from the long prompt's arrival
    on: the gaps between consecutive decode steps' completions, starting
    with the last step before the long prompt's first admission dispatch
    (every step emits one token a running lane)."""
    keys = decode_keys_of(engine)
    steps = [r for r in records if r.key in keys]
    before = [r for r in steps if r.seq < first_admission_seq]
    done = sorted(r.complete_ts for r in steps if r.seq >= first_admission_seq)
    done = ([max(r.complete_ts for r in before)] if before else []) + done
    return [(b - a) * 1e3 for a, b in zip(done, done[1:])]


def replay_rows(cfg, model, params, req: Request, chunk, n_tokens: int) -> tuple:
    """Request `req` alone through the continuous schedule (chunked or not)
    on 8 lanes (the served shapes: PyTorch's reductions, the norms', may
    sum a row in another order at another row count) for `n_tokens`
    tokens, recording the fp32 logit row of every pick: (tokens, rows)."""
    engine = build_scheduler(ServeConfig(
        schedule="continuous", max_len=CHUNK_LONG + SERVE_GEN, n_slots=8,
        chunk=ChunkConfig(prefill_chunk=chunk) if chunk else None), model, params, cfg)
    rows, pick = [], engine.sampler.pick

    def recording(r, rids, positions):
        rows.append(r[..., :cfg.vocab].float().cpu())
        return pick(r, rids, positions)

    engine.sampler.pick = recording
    res = engine.run([Request(req.rid, req.prompt, n_tokens)])
    return res[0].tokens, torch.cat([r.reshape(-1, cfg.vocab) for r in rows])


def explain_divergence(cfg, model, params, req: Request, a: np.ndarray, b: np.ndarray) -> dict:
    """Two greedy streams of one request, unchunked (`a`) and chunked
    (`b`), that part at token j: the prompt's cache came from other kernels
    on the two paths (flash and decode, or the chunk's plain attention), so
    their logits differ by rounding. Replays the request alone on both
    paths, which must reproduce both streams through token j, and reads the
    two logit rows that picked token j: the flip is a near tie when each
    path's margin between the two picks is within the largest difference
    between the two rows."""
    j = int(np.argmax(a != b))
    ta, ra = replay_rows(cfg, model, params, req, None, j + 1)
    tb, rb = replay_rows(cfg, model, params, req, CHUNK_SIZE, j + 1)
    ra, rb = ra[j], rb[j]
    x, y = int(a[j]), int(b[j])
    diff = float((ra - rb).abs().max())
    margin_a, margin_b = float(ra[x] - ra[y]), float(rb[y] - rb[x])
    top2 = [float(r.topk(2).values[0] - r.topk(2).values[1]) for r in (ra, rb)]
    replayed = bool(np.array_equal(ta, a[:j + 1]) and np.array_equal(tb, b[:j + 1]))
    return {"rid": req.rid, "prompt_len": int(req.prompt.size), "token": j,
            "unchunked_pick": x, "chunked_pick": y, "replayed": replayed,
            "margin_unchunked": margin_a, "margin_chunked": margin_b,
            "top2_margin": top2, "max_abs_logit_diff": diff,
            "near_tie": replayed and 0 <= margin_a <= diff and 0 <= margin_b <= diff}


def serve_chunked(cfg) -> None:
    """Full tinyllama-1.1b (fp16 form): a 512-token prompt arrives at step
    4 while 7 lanes decode, served with and without `--prefill-chunk 64`
    under the continuous and the slo schedules (each engine serves the
    requests twice; the second round is the one measured, every program a
    replay). The chunk program must be one graph (one capture, no
    recapture) whichever lane it stages; decode dispatches must run between
    the long prompt's chunks, whose spans tile [0, 448); launches exact;
    the slo streams equal the continuous ones. Chunked and unchunked
    streams must be equal, except where a stream parts at a near tie
    (`explain_divergence`): the prompt caches come from other kernels on the
    two paths. Reports the running lanes' gaps between tokens from the long
    prompt's arrival on (p99, largest, median), chunked and not."""
    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    max_len = CHUNK_LONG + SERVE_GEN
    target = CHUNK_SIZE * ((CHUNK_LONG - 1) // CHUNK_SIZE)
    tokens: dict = {}
    for schedule in ("continuous", "slo"):
        for chunk in (None, CHUNK_SIZE):
            tag = f"{schedule} chunk={chunk}"
            cache = ProgramCache()
            stream = (AsyncExecutionStream if schedule == "slo" else dispatch.ExecutionStream)(
                cache, device="cuda")
            engine = build_scheduler(ServeConfig(
                schedule=schedule, max_len=max_len, n_slots=8, stream=stream,
                chunk=ChunkConfig(prefill_chunk=chunk) if chunk else None), model, params, cfg)
            engine.run(chunked_requests(cfg))
            seen = len(stream.records)
            native.reset_launch_counts()
            t0 = time.perf_counter()
            res = engine.run(chunked_requests(cfg, rid0=8))
            wall = time.perf_counter() - t0
            launches = native.launch_counts()
            recs = stream.records[seen:]
            if isinstance(stream, AsyncExecutionStream):
                stream.close()
            tokens[schedule, chunk] = [r.tokens for r in res]
            st = cache.stats
            if (st.captures, st.recaptures) != (st.misses, 0):
                raise AssertionError(f"chunked {tag}: {st.captures} captures, "
                                     f"{st.recaptures} recaptures, {st.misses} misses")
            if {b for _, b in model.dispatcher.census()} != {"cuda"}:
                raise AssertionError(f"chunked {tag}: routes {model.dispatcher.census()}")
            keys = decode_keys_of(engine)
            n_prefill, n_chunk, n_decode = step_counts({"engine": engine, "records": recs},
                                                       keys)
            check_serve_launches(f"chunked {tag}", cfg, launches, n_prefill, n_chunk, n_decode)
            between, graphs_of_chunk = 0, None
            if chunk:
                # the long prompt chunks last: its chunks are the last records
                # with a span, and they must tile [0, target)
                long = [r for r in recs if r.span is not None][-(target // CHUNK_SIZE):]
                spans = [r.span for r in long]
                first_admission = long[0].seq
                between = sum(long[0].seq < r.seq < long[-1].seq for r in recs
                              if r.key in keys)
                graphs_of_chunk = len(next(iter(engine._chunk_memo.values()))[0]._graphs)
                if len(engine._chunk_keys) != 1 or graphs_of_chunk != 1 or between == 0 \
                        or spans != [(c, c + CHUNK_SIZE) for c in range(0, target, CHUNK_SIZE)]:
                    raise AssertionError(
                        f"chunked {tag}: {len(engine._chunk_keys)} chunk programs, "
                        f"{graphs_of_chunk} graphs, {between} decode steps between the long "
                        f"prompt's chunks, its spans {spans}")
            else:
                # the long prompt's prefill: the last record of a prefill program
                first_admission = [r.seq for r in recs if r.key not in keys
                                   and r.key not in NAMED_RECORDS][-1]
            gaps = arrival_gaps_ms(engine, recs, first_admission)
            emit("chunked", run=tag, config=cfg.name, dtype=cfg.dtype, schedule=schedule,
                 prefill_chunk=chunk, long_prompt=CHUNK_LONG, arrival=CHUNK_ARRIVAL,
                 running_lanes=7, wall_s=wall, decode_steps=n_decode, chunks=n_chunk,
                 prefills=n_prefill, decode_between_chunks=between,
                 chunk_graphs=graphs_of_chunk, captures=st.captures, misses=st.misses,
                 recaptures=st.recaptures, gaps_after_arrival=len(gaps),
                 p99_token_gap_ms=float(np.percentile(gaps, 99)),
                 max_token_gap_ms=max(gaps), median_token_gap_ms=statistics.median(gaps),
                 tokens_sha256=digest(np.stack(tokens[schedule, chunk][:7])),
                 launches=launches)
    for a, b in zip(tokens["continuous", None] + tokens["continuous", CHUNK_SIZE],
                    tokens["slo", None] + tokens["slo", CHUNK_SIZE]):
        if not np.array_equal(a, b):
            raise AssertionError("chunked phase: slo and continuous streams differ")
    parted = []
    for req, a, b in zip(chunked_requests(cfg), tokens["continuous", None],
                         tokens["continuous", CHUNK_SIZE]):
        if np.array_equal(a, b):
            continue
        why = explain_divergence(cfg, model, params, req, a, b)
        parted.append(why)
        if not why["near_tie"]:
            raise AssertionError(f"chunked phase: request {req.rid} parts from the unchunked "
                                 f"stream at token {why['token']}, not at a near tie: {why}")
    emit("chunked_streams", requests=len(tokens["continuous", None]),
         equal=len(tokens["continuous", None]) - len(parted), parted_at_near_ties=parted)
    del model, params


def serve_encoder_slo(want_tokens: np.ndarray) -> None:
    """Full whisper-small through the slo schedule (the encoder phase's
    requests): greedy streams equal to the continuous run's, every route
    cuda, captures = misses with no recapture."""
    out = serve.run(encoder_argv(SERVE_ROUNDS, "slo"))
    graphs = graph_counts("encoder slo", out, NAMED_RECORDS)
    if not np.array_equal(out["tokens"], want_tokens):
        raise AssertionError("encoder slo: streams differ from the continuous run's")
    if {b for _, b in out["routes"]} != {"cuda"}:
        raise AssertionError(f"encoder slo routes {out['routes']}")
    emit("encoder_slo", config=ENCODER_ARCH, tokens_sha256=digest(out["tokens"]),
         tok_per_s=out["tok_per_s"], mean_inflight_depth=out["mean_inflight_depth"],
         n_dispatches=out["n_dispatches"], **graphs)


# device-trace kernel names -> the port's kernels (one traced instance a
# launch; flash's combine pass and specdec's accept pass are second kernels
# of one launch and are not counted); the matmul loops by their producer
TRACE_KERNELS = (("matmul_", None), ("flash_tile", "flash"), ("flash_split", "flash"),
                 ("flash_simt", "flash"), ("decode_split", None),
                 ("slice_argmax", "specdec+specdec_tree"), ("act_lut_kernel", "act_lut"),
                 ("pool_kernel", "avg_pool+max_pool"))
MATMUL_PRODUCERS = (("Sparse", "sparse"), ("Palette", "palette"), ("Conv", "conv2d"))


def trace_kernel(name: str) -> str | None:
    """The port's kernel (or pair of kernels sharing a body) that a traced
    device kernel's demangled name belongs to; None for any other kernel."""
    for key, kernel in TRACE_KERNELS:
        if key not in name:
            continue
        if key == "matmul_":
            return next((k for tag, k in MATMUL_PRODUCERS if tag in name), "anemm")
        if key == "decode_split":
            return "paged_decode_attention" if "PagedRows" in name else "decode_attention"
        return kernel
    return None


def host_launches_by_trace_kernel(launches: dict) -> dict:
    out: dict[str, int] = {}
    for name, n in launches.items():
        key = next((k for k in ("specdec+specdec_tree", "avg_pool+max_pool")
                    if name in k.split("+")), name)
        out[key] = out.get(key, 0) + n
    return out


def round_requests(argv: list[str], rid0: int) -> list[Request]:
    """The requests of one round of the serve CLI's `argv`, drawn as
    `serve.run` draws them (prompts from the seed, then an encoder-decoder's
    frames)."""
    opts = dict(zip(argv[::2], argv[1::2]))
    cfg = configs.get_config(opts["--arch"])
    lens = [int(x) for x in opts["--prompt-lens"].split(",")]
    rng = np.random.default_rng(int(opts["--seed"]))
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    frames = [None] * len(lens)
    if cfg.family == "encdec":
        frames = [np.asarray(rng.normal(size=cfg.frame_shape), np.float32) for _ in lens]
    return [Request(rid=rid0 + i, prompt=p, max_new_tokens=int(opts["--gen"]),
                    frames=frames[i]) for i, p in enumerate(prompts)]


def traced_round(engine, reqs: list[Request]) -> tuple:
    """One round of `reqs` through `engine` under the profiler, tracing the
    device only. Returns (results, wall, host-counted launches, device
    events as (start, end, name))."""
    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the tracer misses the first kernels after it starts: let a few
        # throwaway kernels take that, before the round
        warm = torch.zeros(1, device="cuda")
        for _ in range(16):
            warm.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        results = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = native.launch_counts()
    return results, wall, launches, device_events(prof)


def device_events(prof) -> list[tuple[float, float, str]]:
    """A finished trace's device events as (start µs, end µs, name), read
    from the tracer's own records: `prof.events()` would first build a
    Python event tree of the whole trace (tens of seconds at a serve round's
    ~180,000 events on a busy host, paid again on each retraced round)."""
    result = prof.profiler.kineto_results
    t0 = result.trace_start_ns()
    return [((e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.name())
            for e in result.events() if e.device_type() == torch.autograd.DeviceType.CUDA]


def profile_serve(label: str, argv: list[str]) -> None:
    """A serve run (the CLI's `argv`, one round: every program captured),
    then its second round, the same requests, under the profiler tracing the
    device only: on the card every program dispatch of that round is a
    replay. Reports device time by kernel and the device's busy share
    between the first and the last kernel of the round (its complement is
    the time the card sat idle waiting for the host), and checks that the
    trace holds exactly one instance of each of the port's kernels per
    launch the host counted in the round (so the replays ran the kernels
    and the counts are the device's). The tracer (CUPTI) loses a few kernel
    records now and then, eager or replayed: a trace with fewer instances
    than launches is taken again, on one more round of the same requests,
    up to TRACE_ATTEMPTS rounds; a trace with more fails at once. Tracing
    slows the host a little, so the profiled round's wall is reported
    beside it."""
    out = serve.run(argv)
    engine = out["engine"]
    # the first round's requests again, rids included: a categorical draw
    # is keyed by its request's rid
    reqs = round_requests(argv, rid0=min(r.rid for r in out["results"]))
    before = (out.get("captures"), engine.cache.stats.misses)
    lost = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        results, wall, launches, events = traced_round(engine, reqs)
        tokens = np.stack([r.tokens for r in results])
        if not np.array_equal(tokens, out["tokens"]):
            raise AssertionError(f"profile {label}: a traced round's tokens differ from the "
                                 "first round's")
        traced: dict[str, int] = {}
        for _, _, name in events:
            kernel = trace_kernel(name)
            if kernel is not None:
                traced[kernel] = traced.get(kernel, 0) + 1
        host = {k: n for k, n in host_launches_by_trace_kernel(launches).items() if n}
        if traced == host:
            break
        if any(n > host.get(k, 0) for k, n in traced.items()):
            raise AssertionError(f"profile {label}: device-trace kernel instances {traced} "
                                 f"exceed the host-counted launches {host}")
        lost.append({k: n - traced.get(k, 0) for k, n in host.items() if traced.get(k, 0) != n})
    else:
        raise AssertionError(f"profile {label}: no traced round of {TRACE_ATTEMPTS} held "
                             f"every launch; records lost per round {lost}")
    stats = engine.cache.stats
    if before[0] is not None and (stats.captures, stats.misses) != before:
        raise AssertionError(f"profile {label}: the traced rounds captured "
                             f"{stats.captures - before[0]} programs; every one should replay")
    if isinstance(engine.stream, AsyncExecutionStream):
        engine.stream.close()
    ours = [s for s, _, n in events if trace_kernel(n) is not None]
    n_tokens = sum(r.tokens.size for r in results)
    emit("profile", run=label, round=2, trace_attempts=attempt, records_lost=lost,
         profiled_wall_s=wall, profiled_tok_per_s=n_tokens / wall,
         **device_time(events, min(ours) if ours else 0.0),
         trace_kernel_instances=traced, host_launches=host)


def device_time(events: list, first: float) -> dict:
    """Of a trace's device events (start, end, name) from `first` on: their
    count, the device's busy time (the union of the kernels' spans) and
    busy share of the window up to the last one's end, and the 12 kernel
    names that took the most device time."""
    spans, by_name = [], {}
    for start, end, name in events:
        if start < first:
            continue
        spans.append((start, end))
        short = name.removeprefix("void ").replace("(anonymous namespace)::", "") \
            .split("(")[0].split("<")[0]
        by_name[short] = by_name.get(short, 0.0) + (end - start)
    busy = window = 0.0
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
    return {"device_events": len(spans), "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / window if spans else None,
            "window_ms": window / 1e3 if spans else None,
            "device_ms_by_kernel": {k: v / 1e3 for k, v in top}}


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


def encoder_argv(rounds: int, schedule: str = "continuous") -> list[str]:
    return ["--arch", ENCODER_ARCH, "--schedule", schedule, "--batch", "8",
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
    graphs = graph_counts("encoder serve", out, NAMED_RECORDS)

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
    want.update(encdec_launches(cfg, "anemm", n_prefill, n_decode))
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
         launches=launches, **graphs, peak_memory_gb=peak_gb)

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
            "avg_pool": pool_launches["avg_pool"], "max_pool": pool_launches["max_pool"]}, \
        tokens


# ---------------------------------------------------------------------------
# the encoder_forms and encoder_spec phases: whisper-small packed and
# speculative
# ---------------------------------------------------------------------------


def encdec_launches(cfg, matmul: str, n_prefill: int, n_decode: int) -> dict:
    """An encoder-decoder's launches: per prefill the stem's 2 conv2d, 6
    matmuls an encoder layer, 2 (cross K/V) + 8 a decoder layer and the
    head, one flash an encoder layer and two a decoder layer; per decode
    step 8 matmuls a decoder layer and the head, one flash (cross) and one
    decode_attention (self) a decoder layer. `matmul`: the kernel of every
    matmul (`anemm`, or a packed form's)."""
    l_e, l_d = cfg.n_encoder_layers, cfg.n_layers
    return {"conv2d": 2 * n_prefill,
            matmul: (6 * l_e + 10 * l_d + 1) * n_prefill + (8 * l_d + 1) * n_decode,
            "flash": (l_e + 2 * l_d) * n_prefill + l_d * n_decode,
            "decode_attention": l_d * n_decode}


def serve_encoder_forms() -> None:
    """Full whisper-small under each packed form (packed on the card after
    init) through the serve CLI's entry point: the encoder's attention, the
    decoder's self- and cross-attention, the MLPs and the head stream
    through the form's kernel (17 packed leaves), the conv stem stays dense;
    every route cuda, no anemm, each kernel's launches as the run's
    admissions and decode steps imply; captures = misses."""
    cfg = configs.get_config(ENCODER_ARCH)
    for form in ENCODER_FORMS:
        kernel = FORM_KERNEL[form]
        release_memory()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        out = serve.run(encoder_argv(1) + ["--weight-form", form])
        launches = native.launch_counts()
        graphs = graph_counts(f"encoder {form} serve", out, NAMED_RECORDS)
        tokens = out["tokens"]
        if tokens.shape != (len(ENCODER_LENS.split(",")), SERVE_GEN) or \
                tokens.min() < 0 or tokens.max() >= cfg.vocab:
            raise AssertionError(f"encoder {form} tokens: shape {tokens.shape}")
        routes = set(out["routes"])
        if routes != {(k, "cuda") for k in (kernel, "flash", "decode_attention", "conv2d")}:
            raise AssertionError(f"encoder {form} routes {out['routes']}")
        if out["weight_form_census"] != {form: 17}:
            raise AssertionError(f"encoder {form} packed leaves {out['weight_form_census']}")
        recs = out["records"]
        decode_key = recs[-1].key
        n_decode = sum(r.key == decode_key for r in recs)
        n_prefill = sum(r.key not in NAMED_RECORDS and r.key != decode_key for r in recs)
        want = {k: 0 for k in launches}
        want.update(encdec_launches(cfg, kernel, n_prefill, n_decode))
        if launches != want:
            raise AssertionError(f"encoder {form} launches {launches}, expected {want}")
        steps = [r.wall_s for r in recs if r.key == decode_key]
        emit("encoder_forms", config=cfg.name, dtype=cfg.dtype, weight_form=form,
             lanes=len(tokens), prompt_lens=ENCODER_LENS, gen=SERVE_GEN, rounds=1,
             tokens_sha256=digest(tokens), tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
             pack_s=out["pack_s"], weight_form_census=out["weight_form_census"],
             prefills=n_prefill, decode_steps=n_decode,
             decode_median_ms=statistics.median(steps) * 1e3,
             routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
             launches=launches, **graphs,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del out


def serve_encoder_spec(want_tokens: np.ndarray) -> None:
    """Full whisper-small through `--schedule spec` with each drafter of
    ENCODER_DRAFTS (`shrink`: one encoder and one decoder layer of the
    target's widths, its own stem and encoder on each request's frames):
    the streams equal the continuous run's, every route cuda, the self
    drafter accepts everything, every window makes one verify and (if it
    drafted) one draft dispatch, and each kernel's launches are the two
    models' admissions and decode forwards plus one specdec a window."""
    cfg = configs.get_config(ENCODER_ARCH)
    for draft in ENCODER_DRAFTS:
        tag = f"encoder spec {draft}"
        release_memory()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launch_counts()
        out = serve.run(encoder_argv(1, "spec") + ["--draft", draft,
                                                   "--draft-depth", str(SPEC_DEPTH)])
        launches = native.launch_counts()
        graphs = graph_counts(tag, out, ("spec_admit_slot", "spec_reset_slot"))
        if not np.array_equal(out["tokens"], want_tokens):
            bad = int((out["tokens"] != want_tokens).any(axis=1).sum())
            raise AssertionError(f"{tag}: {bad} of {len(want_tokens)} streams differ from the "
                                 "continuous run's")
        if {b for _, b in out["routes"]} != {"cuda"}:
            raise AssertionError(f"{tag} routes {out['routes']}: every route must be cuda")
        if draft == "self" and out["acceptance_rate"] != 1.0:
            raise AssertionError(f"{tag}: acceptance {out['acceptance_rate']}, want 1.0")
        n_windows = out["n_windows"]
        if out["verify_dispatches"] != n_windows or \
                out["draft_dispatches"] != n_windows - out["bonus_windows"]:
            raise AssertionError(f"{tag}: {n_windows} windows, {out['draft_dispatches']} "
                                 f"draft and {out['verify_dispatches']} verify dispatches")
        dcfg = out["engine"].drafter.cfg
        n_prefill = sum(r.key == "spec_admit_slot" for r in out["records"])
        t_dec = out["catchup_steps"] + out["verify_steps"]
        d_dec = out["catchup_steps"] + out["draft_steps"]
        want = {k: 0 for k in launches}
        for part in (encdec_launches(cfg, "anemm", n_prefill, t_dec),
                     encdec_launches(dcfg, "anemm", n_prefill, d_dec)):
            for k, n in part.items():
                want[k] += n
        want["specdec"] = out["windows_by_kind"].get("chain", 0)
        if launches != want:
            raise AssertionError(f"{tag} launches {launches}, expected {want}")
        emit("encoder_spec", config=cfg.name, dtype=cfg.dtype, drafter=draft,
             drafter_layers=[dcfg.n_encoder_layers, dcfg.n_layers], draft_depth=SPEC_DEPTH,
             lanes=len(want_tokens), prompt_lens=ENCODER_LENS, gen=SERVE_GEN, rounds=1,
             tokens_match_continuous=True, tokens_sha256=digest(out["tokens"]),
             tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
             acceptance_rate=out["acceptance_rate"], proposed=out["proposed"],
             accepted=out["accepted"], n_windows=n_windows,
             bonus_windows=out["bonus_windows"], draft_dispatches=out["draft_dispatches"],
             verify_dispatches=out["verify_dispatches"], prefills=n_prefill,
             catchup_steps=out["catchup_steps"], draft_steps=out["draft_steps"],
             verify_steps=out["verify_steps"], n_dispatches=out["n_dispatches"],
             routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
             launches=launches, **graphs,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del out


# ---------------------------------------------------------------------------
# the archs phase: every config of this slice served on the card
# ---------------------------------------------------------------------------


def arch_config(name: str) -> tuple:
    """(config, reduced): the published config, or its depth cut from
    ARCH_RUNS with the cut and its reason (None when whole)."""
    full = configs.get_config(name)
    layers = dict(ARCH_RUNS)[name]
    if layers is None:
        return full, None
    return dataclasses.replace(full, n_layers=layers), \
        {"n_layers": layers, "of": full.n_layers, "why": ARCH_CUTS[name]}


def matmuls_per_forward(cfg, prefill: bool = False) -> int:
    """The routed matmuls of one decoder forward: a layer's mixer (4
    attention projections; for MLA 4 at decode and in a chunk, `wq_a`,
    `wq_b`, `wkv_a`, `wo`, and 5 at prefill, where `wkv_b` expands the
    latent; 5 for an RG-LRU block: `linear_x`, `linear_y`, `w_r`, `w_i`,
    `out`; 6 for an SSM block, which has no MLP: `w_z`, `w_x`, `w_b`, `w_c`,
    `w_dt`, `out_proj`), then 3 for a dense MLP or 3 per expert bank (and 3
    for a shared MLP) for an MoE layer, and the head. The MoE router and
    MLA's absorbed products are not: they run outside any kernel, as in the
    reference."""
    def layer(i):
        kind = cfg.block_kind(i)
        if kind == "ssm":
            return 6
        mix = 5 if kind == "rglru" or (cfg.use_mla and prefill) else 4
        if not cfg.layer_is_moe(i):
            return mix + 3
        return mix + 3 * cfg.n_experts + 3 * bool(cfg.n_shared_experts)
    return sum(layer(i) for i in range(cfg.n_layers)) + 1


def anemm_launches(cfg, n_prefill: int, n_other: int) -> int:
    """`anemm` launches of `n_prefill` prefill forwards and `n_other`
    decode steps and chunks (`matmuls_per_forward`)."""
    return matmuls_per_forward(cfg, True) * n_prefill + matmuls_per_forward(cfg) * n_other


def attention_layers(cfg) -> tuple[int, int]:
    """(layers that prefill through flash, layers that decode through
    decode_attention): every attention layer decodes through the kernel; a
    sliding-window layer prefills through the blocked plain attention, as
    the reference bypasses flash for it; an MLA layer reaches neither (its
    prefill is the plain blocked attention, its decode the absorbed form)."""
    if cfg.use_mla:
        return 0, 0
    n = sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))
    return (0 if cfg.attn_window else n), n


def expected_routes(cfg, kernel: str = "anemm") -> set:
    """The kernels a decoder's forwards route through: the matmul `kernel`
    always, flash and decode_attention where `attention_layers` says."""
    flash, decode = attention_layers(cfg)
    return {kernel} | ({"flash"} if flash else set()) | ({"decode_attention"} if decode else set())


def serve_arch(name: str, lens: str = SERVE_LENS, record: str = "arch_serve",
               cut: tuple | None = None, keep_params: bool = False):
    """One config of ARCH_RUNS (random weights from the seed, its own dtype)
    through the serve CLI's entry point: the continuous schedule, 8 lanes,
    the serve phase's prompts (or `lens`), 32 tokens, one round. Checks:
    tokens in the vocab, every route cuda and the config's routes
    (`expected_routes`), captures = misses, and each kernel's launches:
    `anemm` `matmuls_per_forward` times per prefill and decode step, flash
    once a flash-prefilled layer a prefill, decode_attention once an
    attention layer a step, nothing else (`check_serve_launches`). Emits
    tok/s, the decode step's median, the digest and the peak memory; returns
    the tokens. No profiled round: a traced round of these models holds
    hundreds of thousands of device events, the tracer dropped records in
    every attempt for some of them, and the traced rounds took most of the
    script's time. `cut`: another (config, reduced) of the arch to serve;
    `keep_params`: return (tokens, the served params)."""
    cfg, reduced = cut or arch_config(name)
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    out = serve.run(serve_argv(cfg, 1, "fp16", lens=lens), cfg=cfg)
    launches = native.launch_counts()
    graphs = graph_counts(f"{name} serve", out, NAMED_RECORDS)
    tokens = out["tokens"]
    n_lanes = len(lens.split(","))
    if tokens.shape != (n_lanes, SERVE_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"{name} serve tokens: shape {tokens.shape}, range "
                             f"[{tokens.min()}, {tokens.max()}]")
    if set(out["routes"]) != {(k, "cuda") for k in expected_routes(cfg)}:
        raise AssertionError(f"{name} serve routes {out['routes']}: every route must be cuda, "
                             f"the kernels {sorted(expected_routes(cfg))}")
    recs = out["records"]
    decode_key = recs[-1].key
    n_decode = sum(r.key == decode_key for r in recs)
    n_prefill = sum(r.key not in NAMED_RECORDS and r.key != decode_key for r in recs)
    check_serve_launches(f"{name} serve", cfg, launches, n_prefill, 0, n_decode)
    steps = [r.wall_s for r in recs if r.key == decode_key]
    emit(record, config=name, dtype=cfg.dtype, n_layers=cfg.n_layers, reduced=reduced,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.d_head],
         vocab=cfg.vocab, experts=[cfg.n_experts, cfg.experts_per_token],
         family=cfg.family, block_pattern=list(cfg.block_pattern),
         attn_window=cfg.attn_window, attention_layers=list(attention_layers(cfg)),
         lanes=n_lanes, prompt_lens=lens, gen=SERVE_GEN, rounds=1,
         tokens_sha256=digest(tokens), tok_per_s=out["tok_per_s"], wall_s=out["wall_s"],
         prefills=n_prefill, decode_steps=n_decode,
         decode_median_ms=statistics.median(steps) * 1e3,
         matmuls_per_forward=matmuls_per_forward(cfg),
         matmuls_per_prefill=matmuls_per_forward(cfg, True), n_dispatches=out["n_dispatches"],
         cache_hits=out["cache_hits"], cache_misses=out["cache_misses"],
         routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
         launches=launches, **graphs,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    params = out["engine"].params if keep_params else None
    del out
    return (tokens, params) if keep_params else tokens


# ---------------------------------------------------------------------------
# the recurrent phase and the long-window run
# ---------------------------------------------------------------------------


def serve_recurrent(name: str) -> None:
    """A recurrent config at RECURRENT_LAYERS (full width): continuous
    serves of its spec prompts (RECURRENT_SPEC_LENS) and of the serve
    phase's; spec with the shrink drafter at depth 4, chain and two
    branches (`serve_spec`: the continuous streams, launches exact; the
    untrained drafter rejects, so the recurrent rollback runs), chunked
    prefill (`serve_recurrent_chunked`) and, for the hybrid, the prefix pool
    (`prefix_serves`: pooled streams = pool-less, the recurrent state
    through the anchors)."""
    full = configs.get_config(name)
    cfg = dataclasses.replace(full, n_layers=RECURRENT_LAYERS[name])
    cut = (cfg, {"n_layers": cfg.n_layers, "of": full.n_layers, "why": RECURRENT_CUT})
    lens = RECURRENT_SPEC_LENS[name]
    want = serve_arch(name, lens, record="recurrent_continuous", cut=cut)
    for branches in (1, 2):
        serve_spec(cfg, "shrink", branches, want, lens=lens, rounds=1)
    serve_recurrent_chunked(cfg, want if lens == SERVE_LENS else serve_arch(
        name, SERVE_LENS, record="recurrent_continuous", cut=cut))
    if cfg.family == "hybrid":
        prefix_serves(cfg)


def serve_recurrent_chunked(cfg, want_tokens: np.ndarray,
                            record: str = "recurrent_chunked") -> None:
    """`cfg` through the serve CLI with `--prefill-chunk 64` on the
    serve phase's prompts, one round: the chunk program carries the
    recurrent state (and the ring) in its staging row. Routes cuda, one
    chunk program, launches exact (`check_serve_launches`); the streams equal
    the continuous ones (`want_tokens`) except where a stream parts at a near
    tie (`explain_divergence`: the prompt's state comes from the prefill
    scan on one path and the chunk scan on the other)."""
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    out = serve.run(serve_argv(cfg, 1, "fp16") + ["--prefill-chunk", str(CHUNK_SIZE)],
                    cfg=cfg)
    launches = native.launch_counts()
    graphs = graph_counts(f"{cfg.name} chunked", out, NAMED_RECORDS)
    engine = out["engine"]
    if {b for _, b in out["routes"]} != {"cuda"} or len(engine._chunk_keys) != 1:
        raise AssertionError(f"{cfg.name} chunked: routes {out['routes']}, "
                             f"{len(engine._chunk_keys)} chunk programs")
    keys = decode_keys_of(engine)
    n_prefill, n_chunk, n_decode = step_counts(out, keys)
    check_serve_launches(f"{cfg.name} chunked", cfg, launches, n_prefill, n_chunk, n_decode)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for n in (int(x) for x in SERVE_LENS.split(","))]
    tokens, parted = out["tokens"], []
    for rid, (prompt, a, b) in enumerate(zip(prompts, want_tokens, tokens)):
        if np.array_equal(a, b):
            continue
        why = explain_divergence(cfg, engine.model, engine.params,
                                 Request(rid, prompt, SERVE_GEN), a, b)
        parted.append(why)
        if not why["near_tie"]:
            raise AssertionError(f"{cfg.name} chunked: request {rid} parts from the "
                                 f"unchunked stream at token {why['token']}, not at a near "
                                 f"tie: {why}")
    steps = [r.wall_s for r in out["records"] if r.key in keys]
    emit(record, config=cfg.name, dtype=cfg.dtype, prefill_chunk=CHUNK_SIZE,
         lanes=len(prompts), prompt_lens=SERVE_LENS, gen=SERVE_GEN,
         tok_per_s=out["tok_per_s"], wall_s=out["wall_s"], chunks=n_chunk,
         prefills=n_prefill, decode_steps=n_decode,
         decode_median_ms=statistics.median(steps) * 1e3,
         streams_equal=len(prompts) - len(parted), parted_at_near_ties=parted,
         tokens_sha256=digest(tokens), launches=launches, **graphs,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del out, engine


class RingWatch(ContinuousSchedule):
    """The continuous schedule, reading each lane's ring positions at the
    step its request finishes (later idle steps write position 0 there)."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self.rings: dict[int, tuple[int, list[torch.Tensor]]] = {}

    def _finish(self, slot, results, step) -> None:
        lane = self.slots.index(slot)
        rings = [leaf[:, lane].cpu() for path, leaf in leaves_with_path(self.caches)
                 if path.endswith("/pos")]
        self.rings[slot.req.rid] = (slot.next_pos - 1, rings)
        super()._finish(slot, results, step)


def serve_long_window() -> None:
    """recurrentgemma-9b whole on 2 lanes, prompts of 2,304 and 3,000 tokens
    drawn from seed 0, 64 tokens each (max_len 3,064, rings of 2,048 slots):
    one prefill bucket of 2,304, so the prefill keeps its last 2,048
    positions rolled to slot p % 2,048, and the second lane's 696 catch-up
    steps and every lane's generation wrap the rings. At each lane's finish
    every ring leaf (12 layers) must hold exactly the last 2,048 positions
    it consumed, position q at slot q % 2,048; routes cuda (no flash: the
    windowed layers prefill in plain PyTorch), launches exact, tokens in the
    vocab. Emits the decode step's median."""
    cfg = configs.get_config(LONG_ARCH)
    lens = [int(x) for x in LONG_LENS.split(",")]
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    cache = ProgramCache()
    stream = dispatch.ExecutionStream(cache, device="cuda")
    engine = RingWatch(model, params, cfg, n_slots=len(lens), max_len=max(lens) + LONG_GEN,
                       buckets=(min(lens),), stream=stream)
    native.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.run([Request(i, p, LONG_GEN) for i, p in enumerate(prompts)])
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    tokens = np.stack([r.tokens for r in res])
    if tokens.shape != (len(lens), LONG_GEN) or tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"long window tokens: shape {tokens.shape}")
    if set(model.dispatcher.census()) != {(k, "cuda") for k in expected_routes(cfg)}:
        raise AssertionError(f"long window routes {model.dispatcher.census()}")
    keys = decode_keys_of(engine)
    n_prefill, _, n_decode = step_counts({"engine": engine, "records": stream.records}, keys)
    check_serve_launches("long window", cfg, launches, n_prefill, 0, n_decode)
    window, checked = cfg.attn_window, []
    for rid, (last, rings) in sorted(engine.rings.items()):
        want = torch.arange(last - window + 1, last + 1, dtype=torch.int32)
        want = want[(want % window).argsort()]              # position q at slot q % window
        bad = [i for i, ring in enumerate(rings) if not bool((ring == want).all())]
        checked.append({"rid": rid, "prompt_len": lens[rid], "last_position": last,
                        "ring_leaves": len(rings), "layers": sum(r.shape[0] for r in rings),
                        "exact": not bad})
        if bad or not rings:
            raise AssertionError(f"long window rid {rid}: ring leaves {bad} of {len(rings)} do "
                                 f"not hold positions {last - window + 1}..{last} at slot "
                                 f"p % {window}")
    steps = [r.wall_s for r in stream.records if r.key in keys]
    st = cache.stats
    emit("long_window", config=cfg.name, dtype=cfg.dtype, lanes=len(lens), prompt_lens=lens,
         gen=LONG_GEN, max_len=max(lens) + LONG_GEN, window=window, bucket=min(lens),
         prefills=n_prefill, decode_steps=n_decode, rings=checked,
         decode_median_ms=statistics.median(steps) * 1e3, wall_s=wall,
         compile_s=st.compile_seconds, captures=st.captures, recaptures=st.recaptures,
         tok_per_s=LONG_GEN * len(lens) / max(wall - st.compile_seconds, 1e-9),
         tokens_sha256=digest(tokens), launches=launches,
         routes={f"{k}/{b}": n for (k, b), n in model.dispatcher.census().items()},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    if (st.captures, st.recaptures) != (st.misses, 0):
        raise AssertionError(f"long window: {st.captures} captures, {st.recaptures} "
                             f"recaptures, {st.misses} misses")
    del engine, model, params


# ---------------------------------------------------------------------------
# the mla phase
# ---------------------------------------------------------------------------


def mla_config() -> tuple:
    """(deepseek-v3-671b at the archs phase's depth without its MTP module,
    reduced)."""
    cfg, reduced = arch_config(MLA_ARCH)
    return dataclasses.replace(cfg, mtp_depth=0), dict(
        reduced, mtp_depth={"kept": 0, "of": cfg.mtp_depth,
                            "why": "no served program reads the MTP module (the reference "
                                   "reads it only in its training loss), so the streams are "
                                   "those with it; its 11.6 B parameters (~23 GB) would sit "
                                   "beside the spec serves' 11 captured programs"})


def checkpoint_bytes(step_dir: Path) -> int:
    return sum(f.stat().st_size for f in step_dir.iterdir())


def serve_mla_ckpt(cfg, reduced: dict, ckpt: Path, want_tokens: np.ndarray,
                   written: dict) -> None:
    """The checkpoint `ckpt` of the mla phase's served params (written in
    the reference's layout, `written`: its bytes and seconds) served through
    `--ckpt` from another seed's init (the same prompts, MLA_LENS drawn from
    seed 0): the restored weights must give the direct serve's streams."""
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    lens = [int(x) for x in MLA_LENS.split(",")]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32) for n in lens]
    argv = ["--arch", cfg.name, "--batch", "8", "--gen", str(SERVE_GEN), "--seed", "1",
            "--device", "cuda", "--ckpt", str(ckpt)]
    t0 = time.perf_counter()
    out = serve.run(argv, prompts=[prompts], cfg=cfg)
    serve_s = time.perf_counter() - t0
    same = np.array_equal(out["tokens"], want_tokens)
    emit("mla_ckpt", config=cfg.name, reduced=reduced, **written,
         serve_with_restore_s=serve_s, step=out["ckpt_step"],
         tokens_sha256=digest(out["tokens"]), want_sha256=digest(want_tokens),
         streams_equal=same, routes={f"{k}/{b}": n for (k, b), n in out["routes"].items()},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not same or out["ckpt_step"] != 7:
        raise AssertionError(f"--ckpt: step {out['ckpt_step']}, streams equal {same}")
    del out


def serve_mla_packed(cfg, form: str = "int4_palette") -> None:
    """The mla phase's config packed on the card (`--weight-form`), MLA_LENS,
    one round: tokens in the vocab, routes cuda; `wq_b` (and, at prefill,
    `wkv_b`) stay dense and run `anemm`, every other matmul the form's
    kernel, launched exactly as the forwards imply."""
    kernel = FORM_KERNEL[form]
    release_memory()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launch_counts()
    out = serve.run(serve_argv(cfg, 1, form, lens=MLA_LENS), cfg=cfg)
    launches = native.launch_counts()
    graphs = graph_counts(f"mla {form}", out, NAMED_RECORDS)
    tokens = out["tokens"]
    if tokens.min() < 0 or tokens.max() >= cfg.vocab:
        raise AssertionError(f"mla {form} tokens out of the vocab")
    if set(out["routes"]) != {("anemm", "cuda"), (kernel, "cuda")}:
        raise AssertionError(f"mla {form} routes {out['routes']}")
    recs = out["records"]
    decode_key = recs[-1].key
    n_decode = sum(r.key == decode_key for r in recs)
    n_prefill = sum(r.key not in NAMED_RECORDS and r.key != decode_key for r in recs)
    dense = cfg.n_layers * (n_prefill + n_decode) + cfg.n_layers * n_prefill
    want = {k: 0 for k in launches}
    want.update({"anemm": dense, kernel: anemm_launches(cfg, n_prefill, n_decode) - dense})
    if launches != want:
        raise AssertionError(f"mla {form} launches {launches}, expected {want}")
    steps = [r.wall_s for r in recs if r.key == decode_key]
    emit("mla_packed", config=cfg.name, weight_form=form, n_layers=cfg.n_layers,
         prompt_lens=MLA_LENS, gen=SERVE_GEN, pack_s=out["pack_s"],
         packed_leaves=out["weight_form_census"], tok_per_s=out["tok_per_s"],
         wall_s=out["wall_s"], prefills=n_prefill, decode_steps=n_decode,
         decode_median_ms=statistics.median(steps) * 1e3, tokens_sha256=digest(tokens),
         launches=launches, **graphs, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del out


def serve_mla(arch_tokens: np.ndarray) -> None:
    """deepseek-v3-671b at 4 of 61 layers without the MTP module
    (`mla_config`): a continuous serve of MLA_LENS (one prefill bucket)
    whose params are then written in the reference's layout and served back
    through `--ckpt` (`serve_mla_ckpt`); spec with the shrink drafter (one
    dense MLA layer), chain and two branches, on the same prompts
    (`serve_spec`: the continuous streams, exact launches, the drafter
    rejects, so the latent cache rolls back); `--prefill-chunk 64` on the
    serve phase's prompts against the archs phase's streams (`arch_tokens`,
    served with the MTP module) except at near ties; the prefix pool
    (`prefix_serves`: pooled = pool-less, `c_kv` / `k_rope` paged); and an
    int4_palette serve (`serve_mla_packed`)."""
    cfg, reduced = mla_config()
    want, params = serve_arch(MLA_ARCH, MLA_LENS, record="mla_continuous", cut=(cfg, reduced),
                              keep_params=True)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="mla_ckpt_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        CheckpointManager(str(ckpt)).save(7, params)
        written = {"write_s": time.perf_counter() - t0,
                   "bytes": checkpoint_bytes(ckpt / f"step_{7:09d}")}
        del params
        serve_mla_ckpt(cfg, reduced, ckpt, want, written)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for branches in (1, 2):
        serve_spec(cfg, "shrink", branches, want, lens=MLA_LENS, rounds=1)
    serve_recurrent_chunked(cfg, arch_tokens, record="mla_chunked")
    prefix_serves(cfg)
    serve_mla_packed(cfg)


# ---------------------------------------------------------------------------
# the train phase: gradients through the kernels, the training CLI at full
# width, the loss against the plain versions, a resume from a checkpoint
# ---------------------------------------------------------------------------


class PlainDispatcher(KernelDispatcher):
    """Routes every call on the card to the kernel's plain PyTorch version:
    the model's loss through plain versions on the same device and params."""

    def resolve(self, name: str, x: torch.Tensor) -> dispatch.KernelRoute:
        route = super().resolve(name, x)
        return dataclasses.replace(route, backend="torch", reason="plain on the card")


def check_vjps() -> None:
    """A check of the backward formulas: each registry row with a VJP
    (anemm, flash, conv2d), at its first case, in bf16 and fp32, the
    gradients of its autograd wrapper on the card against autograd through
    the plain math, at the row's tolerance; the wrapper must launch its
    kernel in the forward. The backward reads only the saved inputs (anemm
    and conv2d differentiate the plain math, flash recomputes through
    `chunked_attention`), never the kernel's output, so this cannot see a
    wrong forward: the CUDA forwards on the train path at its shapes are
    held by `step_zero_against_plain`."""
    failures = []
    for spec in registry.all_specs():
        if spec.make_vjp is None:
            continue
        case = next(c for c in spec.cases if not c.edge)
        for dtype in (torch.bfloat16, torch.float32):
            inputs = spec.make_inputs(case, dtype, np.random.default_rng(7), "cuda")
            kernel_fn, plain_fn, args = spec.make_vjp(inputs)
            native.reset_launch_counts()
            got = torch.autograd.grad(kernel_fn(*args), args)
            launched = native.launch_counts()[spec.name]
            want = torch.autograd.grad(plain_fn(*args), args)
            errs = [_compare(g, w, spec.tol(dtype)) for g, w in zip(got, want)]
            ok = launched >= 1 and all(good for _, good in errs)
            emit("train_vjp", kernel=spec.name, case=case.name, dtype=dtype_name(dtype),
                 tol=list(spec.tol(dtype)), max_abs_err=[e for e, _ in errs],
                 kernel_launches=launched, ok=ok)
            if not ok:
                failures.append(f"{spec.name}/{dtype_name(dtype)}")
    if failures:
        raise AssertionError(f"VJP rows off their plain versions: {failures}")


def train_argv(steps: int, ckpt: Path, *extra: str) -> list[str]:
    return ["--arch", TRAIN_ARCH, "--steps", str(steps), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--ckpt-dir", str(ckpt), "--log-every", "1",
            "--device", "cuda", *extra]


def step_zero_against_plain(cfg) -> dict:
    """The training CLI's step 0 (its params, seed 0, and its first batch)
    at full width on the card, once through the kernels and once through
    their plain versions: the loss, each token's loss (`Model.token_losses`)
    and every param leaf's gradient. Fails where the per-token losses differ
    by more than TRAIN_TOKEN_ATOL, or a leaf's gradient by more than
    TRAIN_GRAD_RTOL of that leaf's largest |value| (plain); the routes must
    be all cuda, then all torch."""
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)).batch(0).items()}
    runs = []
    for disp in (KernelDispatcher(), PlainDispatcher()):
        model = build_model(cfg, disp, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        named = leaves_with_path(params)
        for _, t in named:
            t.requires_grad_(True)        # the training path (the head widened per call)
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
        with torch.no_grad():
            per_tok = model.token_losses(params, batch)
        backend = "torch" if isinstance(disp, PlainDispatcher) else "cuda"
        if {r.backend for r in disp.routes} != {backend}:
            raise AssertionError(f"step-0 loss routes {disp.census()}")
        runs.append((float(loss.detach()), per_tok,
                     {p: g for (p, _), g in zip(named, grads) if g is not None}))
        del model, params, loss, grads, named
        release_memory()
    (k_loss, k_tok, k_grads), (p_loss, p_tok, p_grads) = runs
    if k_grads.keys() != p_grads.keys():
        raise AssertionError("the kernels' and the plain versions' gradients reach other leaves")
    rel = {p: float((k_grads[p].float() - g.float()).abs().max()
                    / g.float().abs().max().clamp_min(1e-30)) for p, g in p_grads.items()}
    worst = max(rel, key=rel.get)
    rec = {"loss_step0_kernels": k_loss, "loss_step0_plain": p_loss,
           "loss_step0_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
           "token_loss_max_abs_diff": float((k_tok - p_tok).abs().max()),
           "token_loss_mean": float(p_tok.mean()), "token_loss_atol": TRAIN_TOKEN_ATOL,
           "grad_leaves": len(rel), "grad_worst_leaf": worst, "grad_worst_rel": rel[worst],
           "grad_median_rel": statistics.median(rel.values()),
           "grad_rtol": TRAIN_GRAD_RTOL}
    del runs, k_grads, p_grads
    release_memory()
    return rec


def train_full_width(cfg, root: Path) -> dict:
    """tinyllama-1.1b at full width and depth through the training CLI:
    TRAIN_STEPS steps, a checkpoint at the end; the loss must fall, every
    route must be cuda with `anemm` and `flash` on them, and step 0's loss
    must equal the plain versions' within TRAIN_LOSS_RTOL and its per-token
    losses and gradients theirs (`step_zero_against_plain`); the run must
    take every step once, with no restart."""
    release_memory()
    step0 = step_zero_against_plain(cfg)
    native.reset_launch_counts()
    out = train.run(train_argv(TRAIN_STEPS, root / "full"), cfg=cfg)
    launches = native.launch_counts()
    hist = out["loss_history"]
    steps_ms = [s * 1e3 for s in out["step_s"]]
    step_dir = root / "full" / f"step_{TRAIN_STEPS:09d}"
    routes = {f"{k}/{b}": n for (k, b), n in out["routes"].items()}
    rec = {"config": cfg.name, "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "loss_first": hist[0], "loss_last": hist[-1], "loss_history": hist,
           **step0, "step0_equals_cli": step0["loss_step0_kernels"] == hist[0],
           "loss_rtol": TRAIN_LOSS_RTOL, "routes": routes,
           "final_step": out["final_step"], "restarts": out["restarts"],
           "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items() if n},
           "step_ms_median": statistics.median(steps_ms[1:]), "step_ms_first": steps_ms[0],
           "peak_memory_gb": out["peak_memory_gb"], "save_s": out["save_s"][-1],
           "checkpoint_bytes": checkpoint_bytes(step_dir)}
    emit("train", **rec)
    if out["restarts"] or out["final_step"] != TRAIN_STEPS or len(hist) != TRAIN_STEPS \
            or len(steps_ms) != TRAIN_STEPS:
        raise AssertionError(f"the run restarted or lost steps: final step {out['final_step']}, "
                             f"{len(hist)} losses, {len(steps_ms)} steps, restarts "
                             f"{out['restarts']}")
    if set(out["routes"]) != {("anemm", "cuda"), ("flash", "cuda")}:
        raise AssertionError(f"train routes {out['routes']}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"the loss did not fall: {hist}")
    plain_loss = step0["loss_step0_plain"]
    if abs(hist[0] - plain_loss) > TRAIN_LOSS_RTOL * abs(plain_loss):
        raise AssertionError(f"step 0 loss {hist[0]} against {plain_loss} through the plain "
                             "versions")
    if step0["token_loss_max_abs_diff"] > TRAIN_TOKEN_ATOL:
        raise AssertionError(f"step 0 per-token losses off the plain versions' by "
                             f"{step0['token_loss_max_abs_diff']}")
    if step0["grad_worst_rel"] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"step 0 gradient of {step0['grad_worst_leaf']} off the plain "
                             f"versions' by {step0['grad_worst_rel']} of its largest value")
    return rec


def profile_train_step(cfg) -> None:
    """One train step of the full-width run's shape under the profiler
    (tracing the device; the step before it untraced): device time by
    kernel, the busy share, and the traced instances of the port's kernels
    against the host's launch counts."""
    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.AdamWConfig(warmup_steps=5, total_steps=TRAIN_STEPS)
    state = adamw.init_state(opt, params)
    step = train.make_train_step(model, opt)
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    batches = [{k: torch.from_numpy(v).cuda() for k, v in src.batch(t).items()} for t in (0, 1)]
    step(params, state, batches[0])
    torch.cuda.synchronize()
    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, batches[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: n for k, n in native.launch_counts().items() if n}
    events = device_events(prof)
    traced: dict[str, int] = {}
    for _, _, name in events:
        kernel = trace_kernel(name)
        if kernel is not None:
            traced[kernel] = traced.get(kernel, 0) + 1
    emit("train_profile", config=cfg.name, profiled_step_ms=wall * 1e3,
         **device_time(events, min(s for s, _, _ in events) if events else 0.0),
         trace_kernel_instances=traced, host_launches=launches)
    del model, params, state, step
    release_memory()


def train_resume(cfg, root: Path) -> None:
    """2k steps straight against k steps, a crash just after the step-k
    checkpoint, the supervisor's restart from it and k more (k =
    TRAIN_RESUME_K), both through the training CLI at full width and
    TRAIN_RESUME_LAYERS layers: the logged losses within TRAIN_RESUME_TOL,
    and the largest difference of any param or moment reported. Where it is
    not zero, two gradients of one step from one state show which leaves
    the backward does not give the same bits twice."""
    k = TRAIN_RESUME_K
    cut = dataclasses.replace(cfg, n_layers=TRAIN_RESUME_LAYERS)
    argv = lambda name: train_argv(2 * k, root / name, "--ckpt-every", str(k))  # noqa: E731
    straight = train.run(argv("straight"), cfg=cut)
    real, crashed = train.make_train_step, []

    def crash_after_checkpoint(*a, **kw):
        step = real(*a, **kw)

        def wrapped(params, state, batch):
            if int(state["step"]) == k and not crashed:
                crashed.append(k)
                raise RuntimeError("injected failure after the step-k checkpoint")
            return step(params, state, batch)
        return wrapped

    train.make_train_step = crash_after_checkpoint
    try:
        resumed = train.run(argv("resumed"), cfg=cut)
    finally:
        train.make_train_step = real
    want = CheckpointManager(str(root / "straight"))
    got = CheckpointManager(str(root / "resumed"))
    a, _ = want.restore(state_template(cut))
    b, _ = got.restore(state_template(cut))
    diffs = {p: float((x.float() - y.float()).abs().max())
             for (p, x), (_, y) in zip(leaves_with_path(a), leaves_with_path(b))}
    worst = max(diffs, key=diffs.get)
    loss_diff = max(abs(x - y) for x, y in zip(straight["loss_history"], resumed["loss_history"]))
    rec = {"config": cut.name, "reduced": {"n_layers": {"kept": TRAIN_RESUME_LAYERS,
                                                        "of": cfg.n_layers,
                                                        "why": "six saves of the state; at 22 "
                                                               "layers each is ~11 GB (bf16 "
                                                               "params, fp32 moments)"}},
           "k": k, "crashed_at": crashed, "losses_straight": straight["loss_history"],
           "losses_resumed": resumed["loss_history"], "max_loss_diff": loss_diff,
           "loss_tol": TRAIN_RESUME_TOL, "max_state_diff": diffs[worst],
           "at": worst if diffs[worst] > 0 else None,
           "checkpoint_bytes": checkpoint_bytes(root / "straight" / f"step_{2 * k:09d}"),
           "save_s": straight["save_s"], "restarts_straight": straight["restarts"],
           "restarts_resumed": resumed["restarts"]}
    if diffs[worst] > 0:
        rec["nondeterministic_grads"] = nondeterministic_leaves(cut)
    emit("train_resume", **rec)
    if crashed != [k] or len(resumed["loss_history"]) != 2 * k or loss_diff > TRAIN_RESUME_TOL \
            or straight["restarts"] or len(resumed["restarts"]) != 1 \
            or straight["final_step"] != 2 * k or resumed["final_step"] != 2 * k:
        raise AssertionError(f"resume: crashed {crashed}, restarts {straight['restarts']} / "
                             f"{resumed['restarts']}, losses {resumed['loss_history']} "
                             f"against {straight['loss_history']}")


def state_template(cfg):
    """A (params, AdamW state) template of `cfg` on the card, as the CLI saves it."""
    params = build_model(cfg, KernelDispatcher(), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(1))
    return params, adamw.init_state(adamw.AdamWConfig(), params)


def nondeterministic_leaves(cfg) -> list[str]:
    """The param leaves whose gradient differs between two backward passes
    of one loss on one batch."""
    model = build_model(cfg, KernelDispatcher(), device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    named = leaves_with_path(params)
    for _, t in named:
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)).batch(0).items()}
    grads = [torch.autograd.grad(model.loss(params, batch)[0], [t for _, t in named])
             for _ in range(2)]
    return [p for (p, _), g1, g2 in zip(named, *grads) if not torch.equal(g1, g2)]


def run_train_phase() -> None:
    """The train phase: `check_vjps`, `train_full_width`, `train_resume`,
    the checkpoints under a temporary directory of build/."""
    check_vjps()
    cfg = configs.get_config(TRAIN_ARCH)
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="train_", dir=ROOT / "build"))
    try:
        train_full_width(cfg, root)
        release_memory()
        profile_train_step(cfg)
        train_resume(cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release_memory()


# ---------------------------------------------------------------------------
# the distill phase: a teacher and a distilled student at full width, served
# as target and drafter
# ---------------------------------------------------------------------------


def distill_launches(cfg, teacher_steps: int, steps: int, eval_steps: int) -> tuple:
    """(the launches `distill.run` makes, its launches a step by kernel):
    a train step runs the forward and, under full remat, every layer's
    matmuls and attention again (the head is not recomputed); a student
    step adds one teacher forward without a gradient; each rollout step
    one forward of either model."""
    dcfg = draft_of(cfg)

    def fwd(c):
        return {"anemm": matmuls_per_forward(c), "flash": attention_layers(c)[0]}

    def step(c):
        return {"anemm": 2 * matmuls_per_forward(c) - 1, "flash": 2 * attention_layers(c)[0]}

    def add(*ds):
        return {k: sum(d[k] for d in ds) for k in ds[0]}

    per = {"teacher_step": step(cfg), "student_step": add(fwd(cfg), step(dcfg)),
           "rollout_step": add(fwd(cfg), fwd(dcfg))}
    total = {k: teacher_steps * per["teacher_step"][k] + steps * per["student_step"][k]
             + eval_steps * per["rollout_step"][k] for k in ("anemm", "flash")}
    return total, per


def distill_recipe() -> dict:
    """The reference's DEFAULTS with the phase's DISTILL_FLAGS."""
    return {**distill.DEFAULTS, **DISTILL_FLAGS}


def motif_prompts(cfg, n: int, length: int) -> tuple[np.ndarray, np.ndarray]:
    """(n held-out prompts of `length` tokens, each one's motif tail): the
    corpus's prompt stream (`prompt_batch`, seed 0, the teacher's motifs)
    cut two tokens into a motif planted whole, so the data continues each
    prompt with that motif's other MOTIF_LEN - 2 tokens. A prompt of
    `prompt_batch` itself ends on a background token (no motif is planted
    over its last position), after which the likeliest token is the Zipf
    head, token 0, for every context: a teacher that knows every motif
    still continues such a prompt greedily with 0 alone."""
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=length, global_batch=n))
    motifs, mlen = src._motifs, src.cfg.motif_len
    prompts, tails = [], []
    step = 0
    while len(prompts) < n:
        for row in src.prompt_batch(step, n, 2 * length):
            hits = [(st, m) for st in range(len(row) - mlen, length - 3, -1)
                    for m in range(len(motifs)) if np.array_equal(row[st:st + mlen], motifs[m])]
            if hits and len(prompts) < n:
                st, m = hits[0]
                prompts.append(row[st + 2 - length:st + 2])
                tails.append(motifs[m][2:])
        step += 1
    return np.stack(prompts).astype(np.int32), np.stack(tails)


@torch.no_grad()
def motif_rollout(cfg, teacher, tparams, students: dict, prompts: np.ndarray,
                  steps: int) -> tuple[np.ndarray, dict]:
    """The teacher's greedy rollout of `steps` tokens from `prompts`
    (full-context forwards, as `distill.rollout_agreement`) and each
    student's top-1 at every step over the true vocab: (the teacher's
    stream, {name: the student's picks})."""
    ctx = torch.from_numpy(prompts).to(teacher.device)
    picks = {name: [] for name in students}
    stream = []
    for _ in range(steps):
        t_pick = torch.argmax(distill._full_logits(teacher, tparams, ctx)[:, -1, :cfg.vocab],
                              dim=-1)
        for name, (student, sparams) in students.items():
            picks[name].append(torch.argmax(
                distill._full_logits(student, sparams, ctx)[:, -1, :cfg.vocab], dim=-1))
        stream.append(t_pick)
        ctx = torch.cat([ctx, t_pick[:, None].to(ctx.dtype)], dim=1)
    return (torch.stack(stream, 1).cpu().numpy(),
            {name: torch.stack(p, 1).cpu().numpy() for name, p in picks.items()})


def stream_stats(tokens: np.ndarray) -> dict:
    """Distinct tokens of a served or rolled-out stream and the share of
    its most frequent one."""
    _, counts = np.unique(tokens, return_counts=True)
    return {"distinct_tokens": len(counts), "top_token_share": float(counts.max() / tokens.size)}


def motif_agreement(cfg, teacher, tparams, students: dict, steps: int) -> dict:
    """On DISTILL_PROMPTS motif prompts (`motif_prompts`): the teacher's
    rollout (its stream's `stream_stats`; `tail_hits`, the share of the
    motif tails it reproduces in its first steps) and, for each student,
    its agreement with the teacher over all `steps` (`all`) and over the
    tail's steps alone (`tail`), where the teacher continues a motif."""
    prompts, tails = motif_prompts(cfg, DISTILL_PROMPTS, DISTILL_PROMPT_LEN)
    stream, picks = motif_rollout(cfg, teacher, tparams, students, prompts, steps)
    k = tails.shape[1]
    return {"teacher": {**stream_stats(stream),
                        "tail_hits": float((stream[:, :k] == tails).mean())},
            **{name: {"all": float((p == stream).mean()),
                      "tail": float((p[:, :k] == stream[:, :k]).mean())}
               for name, p in picks.items()}}


def distill_formula_gaps(lg: torch.Tensor, tl: torch.Tensor, targets: torch.Tensor,
                         vocab: int) -> dict:
    """`distill.distill_terms`' per-token KL at T 1 and 2 and its CE
    against torch's own `F.kl_div` and `F.cross_entropy` over the true
    vocab (sliced, not masked), on the same logits: each largest gap over
    the term's largest value. A KL, temperature or CE line written wrong
    moves these; the kernels cannot, both sides read the same logits."""
    gaps = {}
    for T in (1.0, 2.0):
        terms = distill.distill_terms(lg, tl, targets, vocab, T)
        logp_s = F.log_softmax(lg[..., :vocab].float() / T, dim=-1)
        logp_t = F.log_softmax(tl[..., :vocab].float() / T, dim=-1)
        kl = T * T * F.kl_div(logp_s, logp_t, reduction="none", log_target=True).sum(-1)
        gaps[f"kl_T{T:g}"] = float((terms["kl"] - kl).abs().max() / kl.abs().max())
    ce = F.cross_entropy(lg[..., :vocab].float().flatten(0, 1), targets.flatten().long(),
                         reduction="none").view(targets.shape)
    gaps["ce"] = float((terms["ce"] - ce).abs().max() / ce.abs().max())
    return gaps


def distill_step_zero(cfg, tparams) -> dict:
    """Step 0 of the distillation at full width on the card (the trained
    teacher, the student at its init from seed 1 as `distill_student`
    draws it, the first distillation batch), once through the kernels and
    once through their plain versions (`PlainDispatcher`): the teacher's
    logits, each token's KL and CE (`distill.distill_terms`), the loss of
    `make_distill_loss` and every student gradient leaf; on the kernels'
    logits also `distill_formula_gaps`. The routes must be all cuda, then
    all torch."""
    d = distill_recipe()
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=d["seq"], global_batch=d["batch"])).batch(
        distill.STUDENT_STEP_OFFSET).items()}
    runs = []
    for disp in (KernelDispatcher(), PlainDispatcher()):
        teacher = build_model(cfg, disp, device="cuda")
        student = build_model(draft_of(cfg), disp, device="cuda")
        sparams = student.init(torch.Generator(device="cuda").manual_seed(1))
        tl = distill.make_teacher_logits_fn(teacher)(tparams, batch["tokens"])
        named = leaves_with_path(sparams)
        for _, t in named:
            t.requires_grad_(True)
        loss_fn = distill.make_distill_loss(student, cfg.vocab, kl_weight=d["kl_weight"],
                                            temperature=d["temperature"])
        loss, _ = loss_fn(sparams, {**batch, "teacher_logits": tl})
        grads = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
        with torch.no_grad():
            lg = distill._full_logits(student, sparams, batch["tokens"])
            terms = distill.distill_terms(lg, tl, batch["targets"], cfg.vocab, d["temperature"])
            if not runs:
                formula = distill_formula_gaps(lg, tl, batch["targets"], cfg.vocab)
        backend = "torch" if isinstance(disp, PlainDispatcher) else "cuda"
        if {r.backend for r in disp.routes} != {backend}:
            raise AssertionError(f"distill step-0 routes {disp.census()}")
        runs.append((float(loss.detach()), tl, terms["kl"], terms["ce"],
                     {p: g for (p, _), g in zip(named, grads) if g is not None}))
        del teacher, student, sparams, named, loss, grads, terms, lg
        release_memory()
    (k_loss, k_tl, k_kl, k_ce, k_grads), (p_loss, p_tl, p_kl, p_ce, p_grads) = runs
    if k_grads.keys() != p_grads.keys():
        raise AssertionError("the kernels' and the plain versions' gradients reach other leaves")
    rel = {p: float((k_grads[p].float() - g.float()).abs().max()
                    / g.float().abs().max().clamp_min(1e-30)) for p, g in p_grads.items()}
    worst = max(rel, key=rel.get)
    rec = {"loss_step0_kernels": k_loss, "loss_step0_plain": p_loss,
           "logit_max_abs_diff": float((k_tl - p_tl).abs().max()),
           "logit_max_abs": float(p_tl.abs().max()),
           "logit_rel_diff": float((k_tl - p_tl).abs().max() / p_tl.abs().max()),
           "kl_token_max_abs_diff": float((k_kl - p_kl).abs().max()),
           "kl_token_mean": float(p_kl.mean()),
           "ce_token_max_abs_diff": float((k_ce - p_ce).abs().max()),
           "ce_token_mean": float(p_ce.mean()),
           "grad_leaves": len(rel), "grad_worst_leaf": worst, "grad_worst_rel": rel[worst],
           "grad_median_rel": statistics.median(rel.values()), "formula": formula,
           "limits": {"logit_rel": DISTILL_LOGIT_RTOL, "kl_token_atol": DISTILL_KL_ATOL,
                      "ce_token_atol": DISTILL_CE_ATOL, "grad_rel": DISTILL_GRAD_RTOL,
                      "formula_rel": DISTILL_FORMULA_RTOL}}
    del runs, k_grads, p_grads
    release_memory()
    return rec


def run_distill(cfg, root: Path) -> None:
    """The distill phase's gates, in order: (1) step 0 through the kernels
    within the DISTILL_* limits of the plain versions (`distill_step_zero`);
    (2) whole runs: the teacher and the student take exactly their step
    counts (the logged losses and the timed steps), nothing restarted, the
    teacher's loss falls, every route cuda and every launch the steps
    imply (`distill_launches`); (3) the teacher completes the motif tails
    (`motif_agreement`: DISTILL_TAIL_HITS, DISTILL_TOP_SHARE) and the
    distilled student's rollout agreement, the reference's and on the
    tails, is at least DISTILL_AGREE_MARGIN above the student's at its
    init; (4) `load_teacher` restores the teacher bit for bit, the
    student's metadata carries the reference's keys and the run's
    agreement; (5) `--ckpt teacher/ --schedule spec --draft shrink
    --draft-ckpt student/` at branches 1 and 2 on the motif prompts: the
    streams of the `--ckpt teacher/` continuous serve (more than one
    distinct token), acceptance above the random-init
    shrink drafter's (served here too), exact launches; (6) the same with
    the student packed as int4_palette: the drafter's matmuls on palette."""
    d = distill_recipe()
    eval_steps = 12
    dense, packed = root / "dense", root / "int4"
    release_memory()
    native.reset_launch_counts()
    t0 = time.perf_counter()
    flags = [a for k, v in DISTILL_FLAGS.items() for a in (f"--{k.replace('_', '-')}", str(v))]
    out = distill.run(["--arch", cfg.name, *flags, "--ckpt-dir", str(dense), "--log-every", "1",
                       "--eval-steps", str(eval_steps), "--device", "cuda"])
    run_s = time.perf_counter() - t0
    launches = {k: n for k, n in native.launch_counts().items() if n}
    want_launches, per_step = distill_launches(cfg, d["teacher_steps"], d["steps"], eval_steps)
    thist, hist = out["teacher_history"], out["loss_history"]
    tparams, sparams = out["teacher_params"], out["student_params"]
    failures = []
    if not (len(thist) == len(out["teacher_step_s"]) == d["teacher_steps"]
            and len(hist) == len(out["step_s"]) == d["steps"]):
        failures.append(f"runs not whole: teacher {len(thist)} losses / "
                        f"{len(out['teacher_step_s'])} steps, student {len(hist)} / "
                        f"{len(out['step_s'])}")
    if not statistics.mean(thist[-10:]) < statistics.mean(thist[:10]):
        failures.append(f"the teacher's loss did not fall: {thist[:3]} .. {thist[-3:]}")
    if {b for _, b in out["routes"]} != {"cuda"} or launches != want_launches:
        failures.append(f"routes {out['routes']}, launches {launches}, expected "
                        f"{want_launches}")
    release_memory()
    step0 = distill_step_zero(cfg, tparams)
    if step0["logit_rel_diff"] > DISTILL_LOGIT_RTOL or \
            step0["kl_token_max_abs_diff"] > DISTILL_KL_ATOL or \
            step0["ce_token_max_abs_diff"] > DISTILL_CE_ATOL or \
            step0["grad_worst_rel"] > DISTILL_GRAD_RTOL or \
            max(step0["formula"].values()) > DISTILL_FORMULA_RTOL:
        failures.append(f"step 0 off the plain versions: {step0}")
    teacher = build_model(cfg, KernelDispatcher(), device="cuda")
    student = build_model(draft_of(cfg), teacher.dispatcher, device="cuda")
    at_init = student.init(torch.Generator(device="cuda").manual_seed(1))
    untrained = distill.rollout_agreement(cfg, teacher, tparams, student, at_init,
                                          steps=eval_steps, seed=7)
    motif = motif_agreement(cfg, teacher, tparams, {"trained": (student, sparams),
                                                    "init": (student, at_init)}, eval_steps)
    del teacher, student, at_init
    if not out["agreement"] >= untrained + DISTILL_AGREE_MARGIN:
        failures.append(f"agreement {out['agreement']} against {untrained} at init")
    if not (motif["teacher"]["tail_hits"] >= DISTILL_TAIL_HITS
            and motif["teacher"]["top_token_share"] <= DISTILL_TOP_SHARE):
        failures.append(f"the teacher did not learn the motifs: {motif['teacher']}")
    if not motif["trained"]["tail"] >= motif["init"]["tail"] + DISTILL_AGREE_MARGIN:
        failures.append(f"agreement on the motif tails {motif['trained']} against "
                        f"{motif['init']} at init")
    release_memory()
    t0 = time.perf_counter()
    _, loaded = distill.load_teacher(cfg, str(dense / "teacher"), device="cuda")
    load_s = time.perf_counter() - t0
    got, want = leaves_with_path(loaded), leaves_with_path(tparams)
    restored = [p for p, _ in got] == [p for p, _ in want] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    del loaded, got, want
    meta = CheckpointManager(str(dense / "student")).metadata()
    meta_ok = set(meta) == {"role", "arch", "vocab", "d_model", "n_layers", "weight_form",
                            "target_arch", "agreement_top1"} and \
        meta["agreement_top1"] == out["agreement"] and meta["role"] == "draft-student"
    if not (restored and meta_ok):
        failures.append(f"teacher restored bit for bit: {restored}; student metadata {meta}")
    t0 = time.perf_counter()
    distill.save_student(str(packed), cfg, sparams, d["steps"], weight_form="int4_palette",
                         agreement=out["agreement"])
    pack_save_s = time.perf_counter() - t0
    step_dir = lambda sub, step: dense / sub / f"step_{step:09d}"  # noqa: E731
    rec = {"config": cfg.name, "student": draft_of(cfg).name, "teacher_layers": cfg.n_layers,
           "student_layers": draft_of(cfg).n_layers, **{k: d[k] for k in d},
           "run_s": run_s, "teacher_history": thist, "loss_history": hist,
           "teacher_step_ms_median": statistics.median(out["teacher_step_s"][1:]) * 1e3,
           "student_step_ms_median": statistics.median(out["step_s"][1:]) * 1e3,
           "teacher_step_ms_first": out["teacher_step_s"][0] * 1e3,
           "peak_memory_gb": out["peak_memory_gb"], "save_s": out["save_s"],
           "int4_pack_save_s": pack_save_s, "load_teacher_s": load_s,
           "checkpoint_bytes": {"teacher": checkpoint_bytes(step_dir("teacher",
                                                                     d["teacher_steps"])),
                                "student": checkpoint_bytes(step_dir("student", d["steps"])),
                                "student_int4": checkpoint_bytes(
                                    packed / "student" / f"step_{d['steps']:09d}")},
           "agreement": out["agreement"], "agreement_at_init": untrained,
           "motif_agreement": motif, "agree_margin": DISTILL_AGREE_MARGIN, "teacher_restored": restored,
           "student_metadata": meta, "routes": {f"{k}/{b}": n for (k, b), n in
                                                out["routes"].items()},
           "launches": launches, "launches_per_step": per_step, "step0": step0,
           "step0_equals_cli": step0["loss_step0_kernels"] == hist[0]}
    del out, tparams, sparams
    release_memory()
    prompts = [list(motif_prompts(cfg, DISTILL_PROMPTS, DISTILL_PROMPT_LEN)[0])]
    ckpt = ("--ckpt", str(dense / "teacher"))
    cont = serve_schedule(cfg, "distill continuous", serve_argv(cfg, 1, "fp16") + list(ckpt),
                          None, prompts=prompts)
    want_tokens = cont["tokens"]
    serves = {"continuous": {"tok_per_s": cont["tok_per_s"], **stream_stats(want_tokens)}}
    del cont
    if not serves["continuous"]["distinct_tokens"] > 1:
        failures.append(f"the served stream is one token: {serves['continuous']}")
    for branches in (1, 2):
        for label, extra in (("distilled", ckpt + ("--draft-ckpt", str(dense / "student"))),
                             ("random-init", ckpt)):
            _, sp = serve_spec(cfg, "shrink", branches, want_tokens, extra=extra,
                               prompts=prompts, label=label)
            serves[f"{label} x{branches}"] = {
                "acceptance_rate": sp["acceptance_rate"], "tok_per_s": sp["tok_per_s"],
                "trained": sp["engine"].drafter.trained}
            del sp
        if not serves[f"distilled x{branches}"]["acceptance_rate"] > \
                serves[f"random-init x{branches}"]["acceptance_rate"]:
            failures.append(f"x{branches}: acceptance {serves[f'distilled x{branches}']} not "
                            f"above the random-init drafter's {serves[f'random-init x{branches}']}")
    packed_launches, sp = serve_spec(cfg, "shrink", 1, want_tokens,
                                     extra=ckpt + ("--draft-ckpt", str(packed / "student")),
                                     prompts=prompts, draft_form="int4_palette",
                                     label="distilled int4_palette")
    serves["distilled int4_palette x1"] = {
        "acceptance_rate": sp["acceptance_rate"], "tok_per_s": sp["tok_per_s"],
        "palette_launches": packed_launches["palette"], "trained": sp["engine"].drafter.trained}
    del sp
    if not packed_launches["palette"] > 0:
        failures.append(f"int4_palette student: launches {packed_launches}")
    emit("distill", **rec, serves=serves, prompts=DISTILL_PROMPTS,
         prompt_len=DISTILL_PROMPT_LEN, gen=SERVE_GEN, draft_depth=SPEC_DEPTH,
         failures=failures)
    if failures:
        raise AssertionError("distill phase: " + "; ".join(failures))


def run_distill_phase() -> None:
    """The distill phase (`run_distill`), its checkpoints under a temporary
    directory of build/."""
    cfg = configs.get_config(DISTILL_ARCH)
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="distill_", dir=ROOT / "build"))
    try:
        run_distill(cfg, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release_memory()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
