"""Teacher recipes for the distill phase of `chip_smoke.py`, on one CUDA card.

For each LR:TEACHER_STEPS:SEQ given, runs `launch/distill.py`'s pipeline at
full tinyllama-1.1b (the reference's batch of 8, 300 student steps,
kl_weight 0.75, T 1), then `chip_smoke.motif_agreement` over 12 rollout
steps: whether the teacher completes the motif tails of held-out prompts
cut two tokens into a motif, and the distilled student's agreement with it
against the same student's at init. One JSON line a recipe.

    python3 chip_distill_recipes.py 3e-3:150:64 3e-4:150:128
"""

import gc
import json
import statistics
import sys
import time

import torch

import chip_smoke as cs
from repro_torch import configs
from repro_torch.kernels import native
from repro_torch.launch import distill
from repro_torch.launch.speculative import draft_of
from repro_torch.models.model import build_model


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available() or not argv:
        print("usage (on a CUDA card): python3 chip_distill_recipes.py LR:TEACHER_STEPS:SEQ ...",
              file=sys.stderr)
        return 1
    native.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(cs.DISTILL_ARCH)
    d = distill.DEFAULTS
    for recipe in argv:
        lr, teacher_steps, seq = recipe.split(":")
        t0 = time.perf_counter()
        out = distill.distill_pipeline(
            cfg, teacher_steps=int(teacher_steps), steps=d["steps"], batch=d["batch"],
            seq=int(seq), lr=float(lr), kl_weight=d["kl_weight"],
            temperature=d["temperature"], eval_steps=12, log_every=10, device="cuda")
        run_s = time.perf_counter() - t0
        at_init_model = build_model(draft_of(cfg), out["student"].dispatcher, device="cuda")
        at_init = at_init_model.init(torch.Generator(device="cuda").manual_seed(1))
        motif = cs.motif_agreement(cfg, out["teacher"], out["teacher_params"],
                                   {"trained": (out["student"], out["student_params"]),
                                    "init": (at_init_model, at_init)}, 12)
        print(json.dumps({
            "recipe": {"lr": float(lr), "teacher_steps": int(teacher_steps), "seq": int(seq)},
            "run_s": run_s, "teacher_loss_last": out["teacher_history"][-3:],
            "student_loss_last": out["history"][-3:], "agreement": out["agreement"],
            "motif": motif, "peak_memory_gb": out["peak_memory_gb"],
            "teacher_step_ms": statistics.median(out["teacher_step_s"][1:]) * 1e3,
            "student_step_ms": statistics.median(out["step_s"][1:]) * 1e3}), flush=True)
        del out, at_init_model, at_init
        gc.collect()
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
