"""The port's serve CLI: a thin front end over the serving schedules.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --batch 8 --prompt-lens 37,64,100,128,200,256,300,512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --schedule spec --draft self --draft-depth 4 --batch 2 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
        --batch 8 --prompt-lens 8,16,24,32,48,64,100,128 --gen 32

After `src/repro/launch/serve.py:119-419`. The model is built on the chosen
device with a `KernelDispatcher`: on `--device cuda` (the default) every
projection, MLP, logits and attention cell runs the port's hand-written CUDA
kernels, built first with nvcc if missing; `--device cpu` runs their plain
PyTorch versions. Without a CUDA device and without `--device cpu` the CLI
exits with an error instead of falling back.

Weights are random, drawn from a `torch.Generator` seeded with `--seed`;
prompts are drawn with numpy from the same seed, as the reference draws
them; an encoder-decoder (`--arch whisper-small`) then draws one log-mel
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
windows, proposals, acceptance and step counts.
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.dispatch import (AsyncExecutionStream, ExecutionStream,
                                       KernelDispatcher, ProgramCache)
from repro_torch.kernels import native
from repro_torch.launch.scheduler import SAMPLING_MODES, SCHEDULES, Request
from repro_torch.launch.speculative import DRAFT_KINDS
from repro_torch.models.model import build_model
from repro_torch.optim.compression import compress_model_params, weight_form_census

WEIGHT_FORMS = ("fp16", "int4_palette", "sparse")


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=configs.ARCH_NAMES)
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
                         "admission; spec = speculative draft->verify windows on the "
                         "async stream (--draft-depth proposals per window, "
                         "verify/accept on the card); sequential = one request at a "
                         "time (parity reference)")
    ap.add_argument("--draft-depth", type=int, default=4,
                    help="spec only: drafter proposals per window (each window pays "
                         "two dispatch floors for up to draft-depth + 1 tokens)")
    ap.add_argument("--draft", default="shrink", choices=DRAFT_KINDS,
                    help="spec only: shrink = a one-layer draft model of the "
                         "target's widths (random weights); self = the target "
                         "itself (every proposal accepted)")
    ap.add_argument("--draft-branches", type=int, default=1,
                    help="spec only: sibling draft chains per lane (tree "
                         "verification, branching on the drafter's top-N)")
    ap.add_argument("--max-in-flight", type=int, default=8,
                    help="spec only: bounded in-flight window of the async stream")
    ap.add_argument("--sampling", default="greedy", choices=SAMPLING_MODES)
    ap.add_argument("--weight-form", default="fp16", choices=WEIGHT_FORMS,
                    help="stored weight form: fp16 = dense (anemm); int4_palette / "
                         "sparse = packed after init (palette / sparse kernels)")
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

    build_s = 0.0
    if args.device == "cuda":
        build_s = native.build()["seconds"]
    device = torch.device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    dispatcher = KernelDispatcher()
    model = build_model(cfg, dispatcher, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    pack_s = 0.0
    if args.weight_form != "fp16":
        t0 = time.perf_counter()
        params = compress_model_params(params, args.weight_form)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        pack_s = time.perf_counter() - t0
    census = Counter(weight_form_census(params).values())

    lens = ([int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens
            else [args.prompt_len] * args.batch)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=(L,)).astype(np.int32) for L in lens]
    frames = [None] * len(lens)
    if cfg.family == "encdec":
        frames = [np.asarray(rng.normal(size=cfg.frame_shape), np.float32) for _ in lens]
    max_len = max(lens) + args.gen

    program_cache = ProgramCache()
    kw = {"n_slots": args.batch} if args.schedule in ("continuous", "spec") else {}
    if args.schedule == "spec":
        stream = AsyncExecutionStream(program_cache, device=device,
                                      max_in_flight=args.max_in_flight)
        kw.update(draft_depth=args.draft_depth, draft=args.draft,
                  draft_branches=args.draft_branches)
    else:
        stream = ExecutionStream(program_cache, device=device)
    engine = SCHEDULES[args.schedule](model, params, cfg, max_len=max_len,
                                      sampling=args.sampling, stream=stream, **kw)

    results = []
    native.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(max(args.requests, 1)):
        reqs = [Request(rid=r * len(lens) + i, prompt=prompts[i], max_new_tokens=args.gen,
                        frames=frames[i])
                for i in range(len(lens))]
        results = engine.run(reqs)
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    if isinstance(stream, AsyncExecutionStream):
        stream.close()

    n_requests = len(lens) * max(args.requests, 1)
    stats = engine.stats(n_requests)
    # eager: no compile phase, so the ex-compile wall is the wall
    serve_wall = max(wall, 1e-9)
    routes = dispatcher.census()
    out = {
        "tokens": np.stack([r.tokens for r in results]),
        "schedule": args.schedule,
        "sampling": args.sampling,
        "device": str(device),
        "weight_form": args.weight_form,
        "build_s": build_s,
        "pack_s": pack_s,
        "weight_form_census": dict(census),
        "wall_s": wall,
        "tok_per_s": args.gen * n_requests / serve_wall,
        "cache_hits": program_cache.stats.hits,
        "cache_misses": program_cache.stats.misses,
        "floor_measured_s": stream.floor_s,
        "results": results,
        "routes": routes,
        "launches": launches,
        "records": list(stream.records),
        "engine": engine,
        **stats,
    }
    spec_note = ""
    if args.schedule == "spec":
        spec_note = (f" | {args.draft} drafter depth {args.draft_depth} "
                     f"x{stats['draft_branches']} branches: {stats['n_windows']} windows "
                     f"{stats['windows_by_kind']}, acceptance "
                     f"{stats['acceptance_rate']:.2f}, "
                     f"{stats['tokens_per_window_dispatch']:.2f} tok/window-dispatch")
    print(f"{args.schedule} x {args.sampling}: {n_requests} requests "
          f"(lens {lens}) gen {args.gen}: {wall*1e3:.1f} ms "
          f"({serve_wall*1e3:.1f} ms ex-compile, {out['tok_per_s']:.1f} "
          f"tok/s) | {stats['n_dispatches']} "
          f"dispatches, floor/request "
          f"{stats['per_request_dispatch_overhead_s']*1e6:.1f} us | "
          f"program cache h{program_cache.stats.hits}/"
          f"m{program_cache.stats.misses}{spec_note}")
    route_text = ", ".join(f"{k}/{b}: {n}" for (k, b), n in sorted(routes.items()))
    print(f"device {device} | measured floor {stream.floor_s*1e6:.1f} us/dispatch | "
          f"routes {route_text} | kernel launches "
          + ", ".join(f"{k}: {n}" for k, n in launches.items()))
    print(f"weight form {args.weight_form}: packed in {pack_s:.2f} s | packed leaves "
          + (", ".join(f"{f}: {n}" for f, n in sorted(census.items())) or "none"))
    return out


if __name__ == "__main__":
    run()
