"""The port's serve CLI: a thin front end over the serving schedules.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 8 --prompt-lens 37,64,100,128,200,256,300,512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --schedule spec --draft self --draft-depth 4 --batch 2 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --batch 8 --prompt-lens 8,16,24,32,48,64,100,128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --batch 2 --prompt-len 17 --gen 4 --requests 2 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --schedule slo --sampling categorical --prefill-chunk 8 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
        --smoke --device cpu --ckpt CKPT_DIR --schedule spec --draft-ckpt DRAFT_DIR

After `src/repro/launch/serve.py:119-419`. The model is built on the chosen
device with a `KernelDispatcher`: on `--device cuda` (the default) every
projection, MLP, logits and attention cell runs the port's hand-written CUDA
kernels, built first with nvcc if missing; `--device cpu` runs their plain
PyTorch versions. Without a CUDA device and without `--device cpu` the CLI
exits with an error instead of falling back. On the card every program
(prefill per bucket, decode, the spec windows) is captured into a CUDA graph
on its first dispatch and replayed after; the report gives the capture time
(`compile_s`, left out of tok/s as the reference leaves out its compiles)
and the graphs captured and replayed. On the CPU programs run eagerly.

Weights are random, drawn from a `torch.Generator` seeded with `--seed`, or
read from a checkpoint directory in the reference's layout (`--ckpt DIR`,
its latest committed step, restored into the drawn tree before any packing:
`checkpoint.CheckpointReader`); `--draft-ckpt DIR` (spec only, with
`--draft shrink`) reads the shrink drafter's weights likewise, its
metadata's vocab and d_model checked before any array loads. Prompts are
drawn with numpy from the same seed, as the reference draws them; an
encoder-decoder (`--arch whisper-small`) then draws one log-mel
frame array per request (`cfg.frame_shape`, float32 normals) from the same
generator, right after the prompts, as the reference does, and every prompt
must reach a prefill bucket (8 or more tokens). `--weight-form
int4_palette|sparse` packs every eligible matmul weight
after init, on the model's device (`optim.compression.compress_model_params`),
and those matmuls then run the `palette` / `sparse` kernels. The report line
is the reference's, followed by the measured dispatch floor, the route
census, each kernel's launch count, the packing time and the weight-form
census. `--schedule spec` serves speculative draft -> verify windows
(`launch.speculative`) on an `AsyncExecutionStream`, and its report adds the
windows, proposals, acceptance and step counts. `--prefix-cache` routes the
continuous schedule's admissions through the block-paged KV pool
(`launch.kv_pool`, `--prefix-blocks` blocks of `--prefix-block-size` tokens):
a request whose prompt prefix is resident admits with one gather dispatch
instead of re-prefilling it, and the report adds the pool's hits, misses,
skipped prefill tokens and evictions. The sequential schedule drops the pool
knobs (with a warning), the spec schedule and an encoder-decoder refuse them.
`--schedule slo` pipelines decode on an `AsyncExecutionStream` (up to
`--max-in-flight` steps a window, next-token selection inside the decode
program) and, with `--slo-ms`, defers an admission while the predicted
token latency exceeds it; its report adds the window, the deferred
admissions and the predicted p99 token latency. `--prefill-chunk C`
(continuous and slo) admits a prompt as chunk programs of C tokens, one a
tick, with decode steps between them; the report adds the chunks and their
prompt tokens. `--sampling categorical` draws each token with the key of its
(request, position) under `--seed` (jax's threefry, `core.prng`), on the
device that holds the logits. The engine is built from a `ServeConfig`
(`scheduler.build_scheduler`), which refuses a knob of another schedule.

`run(argv, prompts=...)` serves given rounds of prompts (a list of rounds,
each a list of int32 token arrays) in place of the seeded draws: the
library entry point for traffic whose requests share prefixes. `run(argv,
cfg=...)` serves a given config in place of the registered one (its name
must be that of `--arch`, or of its smoke config with `--smoke`): the
library entry point for a depth-cut copy (`dataclasses.replace(cfg,
n_layers=...)`), with no CLI flag.

`--arch` takes every registered architecture and `ane-paper`, the paper's
own float16 workload config (as the reference offers it); MoE configs
(dbrx-132b, deepseek-v3-671b) serve every expert on every token on one
device; deepseek-v3-671b's MLA layers carry their latent cache, and the
recurrent configs (recurrentgemma-9b, mamba2-1.3b) their state, through
every schedule, the prefix pool and chunked prefill.
"""

from __future__ import annotations

import argparse
import time
import warnings
from collections import Counter

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import CheckpointReader
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream,
                                       KernelDispatcher, ProgramCache)
from repro_torch.kernels import native
from repro_torch.launch.scheduler import (SAMPLING_MODES, SCHEDULES, ChunkConfig, PrefixConfig,
                                          Request, ServeConfig, SLOConfig, SpecConfig,
                                          build_scheduler)
from repro_torch.launch.speculative import DRAFT_KINDS
from repro_torch.models.model import build_model
from repro_torch.optim.compression import compress_model_params, weight_form_census

WEIGHT_FORMS = ("fp16", "int4_palette", "sparse")


def run(argv=None, *, prompts: list[list[np.ndarray]] | None = None,
        cfg: configs.ModelConfig | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.ARCH_NAMES + ["ane-paper"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config of the CPU tests")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode lanes (continuous) / requests per round")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--prompt-lens", default="",
                    help="comma-separated per-request prompt lengths "
                         "(heterogeneous round; overrides --prompt-len)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default="continuous", choices=sorted(SCHEDULES),
                    help="continuous = slot-masked batched decode with mid-flight "
                         "admission; slo = overlapped decode (async stream, sampling "
                         "inside the decode program) with SLO-aware admission; spec = "
                         "speculative draft->verify windows on the async stream "
                         "(--draft-depth proposals per window, verify/accept on the "
                         "card); sequential = one request at a time (parity reference)")
    ap.add_argument("--draft-depth", type=int, default=4,
                    help="spec only: drafter proposals per window (each window pays "
                         "two dispatch floors for up to draft-depth + 1 tokens)")
    ap.add_argument("--draft", default="shrink", choices=DRAFT_KINDS,
                    help="spec only: shrink = a one-layer draft model of the "
                         "target's widths (random weights); self = the target "
                         "itself (every proposal accepted)")
    ap.add_argument("--draft-ckpt", default="",
                    help="spec only: a checkpoint directory (the reference's layout) with "
                         "the shrink drafter's weights; a vocab or width mismatch is "
                         "refused before any array loads")
    ap.add_argument("--draft-branches", type=int, default=1,
                    help="spec only: sibling draft chains per lane (tree "
                         "verification, branching on the drafter's top-N)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="slo only: admit a queued request only while the predicted "
                         "token latency stays under this many milliseconds (default: "
                         "no limit)")
    ap.add_argument("--max-in-flight", type=int, default=8,
                    help="slo and spec: bounded in-flight window of the async stream")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="continuous / slo: route admissions through the block-paged "
                         "KV pool; a request whose prompt prefix is resident (shared "
                         "system prompt, repeated round) admits with one gather dispatch "
                         "instead of re-prefilling the matched blocks")
    ap.add_argument("--prefix-blocks", type=int, default=64,
                    help="prefix cache only: arena capacity in blocks")
    ap.add_argument("--prefix-block-size", type=int, default=8,
                    help="prefix cache only: tokens per block (should divide the "
                         "prefill buckets, or chains never anchor)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous / slo: admit a prompt as chunk programs of this "
                         "many tokens (one program per chunk width), one chunk a tick "
                         "with decode steps between them")
    ap.add_argument("--sampling", default="greedy", choices=SAMPLING_MODES,
                    help="greedy argmax, or categorical draws seeded by --seed per "
                         "(request, position)")
    ap.add_argument("--weight-form", default="fp16", choices=WEIGHT_FORMS,
                    help="stored weight form: fp16 = dense (anemm); int4_palette / "
                         "sparse = packed after init (palette / sparse kernels)")
    ap.add_argument("--ckpt", default="",
                    help="load the target's params from this checkpoint directory (the "
                         "reference's layout, its latest committed step) instead of "
                         "random init")
    ap.add_argument("--requests", type=int, default=1,
                    help="identical request rounds; round 2+ must hit the "
                         "program cache")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda = the hand-written kernels; cpu = their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available "
                 "(pass --device cpu to run the plain versions on the CPU)")

    named = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if cfg is not None and cfg.name != named.name:
        raise ValueError(f"cfg {cfg.name!r} is not --arch {args.arch!r} ({named.name!r})")
    build_s = 0.0
    if args.device == "cuda":
        build_s = native.build()["seconds"]
        # the plain fp32 products left on the path (a prefill chunk's
        # attention einsums) in full fp32, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    cfg = named if cfg is None else cfg
    dispatcher = KernelDispatcher()
    model = build_model(cfg, dispatcher, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    ckpt_step = None
    if args.ckpt:
        params, ckpt_step = CheckpointReader(args.ckpt).restore(params)
        print(f"loaded target params from {args.ckpt} (step {ckpt_step})")
    pack_s = 0.0
    if args.weight_form != "fp16":
        t0 = time.perf_counter()
        params = compress_model_params(params, args.weight_form)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pack_s = time.perf_counter() - t0
    census = Counter(weight_form_census(params).values())

    rng = np.random.default_rng(args.seed)
    if prompts is None:
        lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
                else [args.prompt_len] * args.batch)
        drawn = [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in lens]
        rounds = [drawn] * max(args.requests, 1)
    else:
        rounds = [[np.asarray(p, np.int32).reshape(-1) for p in r] for r in prompts]
        if not rounds or len({len(r) for r in rounds}) != 1:
            raise ValueError("prompts: want one or more rounds of equally many prompts")
        lens = [p.size for p in rounds[0]]
    frames = [None] * len(lens)
    if cfg.family == "encdec":
        frames = [np.asarray(rng.normal(size=cfg.frame_shape), np.float32) for _ in lens]
    max_len = max(p.size for r in rounds for p in r) + args.gen

    program_cache = ProgramCache()
    if args.schedule in ("slo", "spec"):
        stream = AsyncExecutionStream(program_cache, device=device,
                                      max_in_flight=args.max_in_flight)
    else:
        stream = ExecutionStream(program_cache, device=device)
    # each schedule-specific knob group is a section; validate() refuses a
    # section the chosen schedule cannot apply, except that the sequential
    # schedule drops the pool's knobs with a warning
    prefix = None
    if args.prefix_cache and args.schedule == "sequential":
        warnings.warn("--prefix-cache does not apply to the sequential schedule (the "
                      "prefix pool rides slot admission); dropped", UserWarning, stacklevel=2)
    elif args.prefix_cache:
        prefix = PrefixConfig(blocks=args.prefix_blocks, block_size=args.prefix_block_size)
    config = ServeConfig(
        schedule=args.schedule, max_len=max_len, n_slots=args.batch,
        sampling=args.sampling, seed=args.seed, stream=stream,
        slo=SLOConfig(slo_ms=args.slo_ms, max_in_flight=args.max_in_flight)
        if args.schedule == "slo" else None,
        spec=SpecConfig(draft_depth=args.draft_depth, draft=args.draft,
                        draft_ckpt=args.draft_ckpt or None,
                        draft_branches=args.draft_branches,
                        max_in_flight=args.max_in_flight)
        if args.schedule == "spec" else None,
        prefix=prefix,
        chunk=ChunkConfig(prefill_chunk=args.prefill_chunk)
        if args.prefill_chunk is not None else None)
    engine = build_scheduler(config, model, params, cfg)

    round_results = []
    native.reset_launch_counts()
    t0 = time.perf_counter()
    for r, round_prompts in enumerate(rounds):
        reqs = [Request(rid=r * len(lens) + i, prompt=p, max_new_tokens=args.gen,
                        frames=frames[i])
                for i, p in enumerate(round_prompts)]
        round_results.append(engine.run(reqs))
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    if isinstance(stream, AsyncExecutionStream):
        stream.close()
    results = round_results[-1]

    n_requests = len(lens) * len(rounds)
    stats = engine.stats(n_requests)
    # serving throughput excludes compilation, as the reference's does: on
    # the card the CUDA-graph captures (the ProgramCache's compile seconds)
    cstats = program_cache.stats
    serve_wall = max(wall - cstats.compile_seconds, 1e-9)
    routes = dispatcher.census()
    out = {
        "tokens": np.stack([r.tokens for r in results]),
        "round_tokens": [np.stack([r.tokens for r in rr]) for rr in round_results],
        "schedule": args.schedule,
        "sampling": args.sampling,
        "device": str(device),
        "weight_form": args.weight_form,
        "build_s": build_s,
        "pack_s": pack_s,
        "ckpt_step": ckpt_step,
        "weight_form_census": dict(census),
        "wall_s": wall,
        "compile_s": cstats.compile_seconds,
        "tok_per_s": args.gen * n_requests / serve_wall,
        "cache_hits": cstats.hits,
        "cache_misses": cstats.misses,
        "captures": cstats.captures,
        "recaptures": cstats.recaptures,
        "replays": cstats.replays,
        "floor_measured_s": stream.floor_s,
        "results": results,
        "routes": routes,
        "launches": launches,
        "records": list(stream.records),
        "engine": engine,
        **stats,
    }
    schedule_note = ""
    if args.schedule == "spec":
        schedule_note = (f" | {args.draft} drafter depth {args.draft_depth} "
                         f"x{stats['draft_branches']} branches: {stats['n_windows']} windows "
                         f"{stats['windows_by_kind']}, acceptance "
                         f"{stats['acceptance_rate']:.2f}, "
                         f"{stats['tokens_per_window_dispatch']:.2f} tok/window-dispatch")
    if args.schedule == "slo":
        schedule_note = (f" | in-flight<= {stats['max_in_flight']} (mean depth "
                         f"{stats['mean_inflight_depth']:.2f}), "
                         f"{stats['deferred_admissions']} deferred admissions, pred p99 "
                         f"token {stats['predicted_token_latency_s']*1e3:.2f} ms")
    chunk_note = ""
    if "chunked_prefill" in stats:
        cp = stats["chunked_prefill"]
        chunk_note = (f" | chunked prefill C={cp['prefill_chunk']}: {cp['n_chunks']} "
                      f"chunks / {cp['chunk_tokens']} prompt tokens")
    prefix_note = ""
    if "prefix_cache" in stats:
        pc = stats["prefix_cache"]
        prefix_note = (f" | prefix cache: {pc['hits']} hits / {pc['misses']} misses, "
                       f"{pc['hit_tokens']} prefill tokens skipped, "
                       f"{pc['evictions']} evictions")
    print(f"{args.schedule} x {args.sampling}: {n_requests} requests "
          f"(lens {lens}) gen {args.gen}: {wall*1e3:.1f} ms "
          f"({serve_wall*1e3:.1f} ms ex-compile, {out['tok_per_s']:.1f} "
          f"tok/s) | {stats['n_dispatches']} "
          f"dispatches, floor/request "
          f"{stats['per_request_dispatch_overhead_s']*1e6:.1f} us | "
          f"program cache h{cstats.hits}/m{cstats.misses}, compile "
          f"{cstats.compile_seconds*1e3:.1f} ms, graphs {cstats.captures} captured "
          f"/ {cstats.replays} replays{prefix_note}{chunk_note}{schedule_note}")
    route_text = ", ".join(f"{k}/{b}: {n}" for (k, b), n in sorted(routes.items()))
    print(f"device {device} | measured floor {stream.floor_s*1e6:.1f} us/dispatch | "
          f"routes {route_text} | kernel launches "
          + ", ".join(f"{k}: {n}" for k, n in launches.items()))
    print(f"weight form {args.weight_form}: packed in {pack_s:.2f} s | packed leaves "
          + (", ".join(f"{f}: {n}" for f, n in sorted(census.items())) or "none"))
    return out


if __name__ == "__main__":
    run()
