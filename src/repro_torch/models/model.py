"""Model facade: init / prefill / decode on the port's dense decoder and
encoder-decoder.

After `src/repro/models/model.py` (`Model` :42, `init` :68, `_backbone` :97,
`forward` :119, `init_cache` :191, `prefill` :206, `decode_step` :216,
`build_model` :298):

    init(generator)                          -> params
    prefill(params, batch)                   -> (caches, last_logits)
    decode_step(params, caches, token, pos)  -> (caches, logits)
    init_cache(batch, max_len)               -> caches

Every matmul and attention cell runs through the model's `KernelDispatcher`
(the port has no undispatched path): on a CUDA device the hand-written
kernels, on the CPU their plain versions. An encoder-decoder (family
"encdec", whisper-small) prefills from `batch["frames"]`: the encoder runs
once, the cross K/V of every decoder layer is built from its output, and
the caches are `{"self": ..., "cross": ...}`; decode reads the resident
cross K/V and ignores frames. Training entry points come with the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dispatch import KernelDispatcher
from repro_torch.models import dispatched as dsp
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.layers import (Params, apply_norm, embed_tokens, init_embed,
                                       init_norm, logits as logits_fn)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    dispatcher: KernelDispatcher

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters in the reference's tree layout, drawn from
        `gen` (a generator on the model's device)."""
        cfg = self.cfg
        params = {"embed": init_embed(gen, cfg, self.dtype),
                  "final_ln": init_norm(cfg, cfg.d_model, self.device)}
        if cfg.family == "encdec":
            params["encdec"] = encdec_lib.init_encdec_stacks(gen, cfg, self.dtype)
        else:
            params["layers"] = tf_lib.init_stack(gen, cfg, self.dtype)
        return params

    def _backbone(self, params: Params, x: torch.Tensor, positions: torch.Tensor, *,
                  mode: str, caches=None, frames: torch.Tensor | None = None):
        cfg = self.cfg
        if cfg.family != "encdec":
            return tf_lib.apply_stack(cfg, params["layers"], x, positions, mode=mode,
                                      caches=caches)
        if mode == "decode":
            cross = caches["cross"]               # built at prefill; resident
        else:
            if frames is None:
                raise ValueError(f"{cfg.name}: prefill needs batch['frames'] "
                                 f"{cfg.frame_shape} per request")
            enc_out = encdec_lib.encode(cfg, params["encdec"], frames)
            cross = encdec_lib.build_cross_cache(cfg, params["encdec"], enc_out)
        x, self_caches = encdec_lib.decoder_stack(
            cfg, params["encdec"], x, positions, mode=mode, cross=cross,
            caches=caches["self"] if mode == "decode" else None)
        return x, {"self": self_caches, "cross": cross}

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, *, mode: str, caches=None,
                frames: torch.Tensor | None = None):
        """Decode ignores `frames`: an encoder-decoder reads its cross K/V
        from the caches."""
        with dsp.use_dispatcher(self.dispatcher):
            x = embed_tokens(params["embed"], tokens).to(self.dtype)
            x, new_caches = self._backbone(params, x, positions, mode=mode, caches=caches,
                                           frames=None if mode == "decode" else frames)
            h = apply_norm(self.cfg, params["final_ln"], x)
        return h, new_caches

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        if cfg.family == "encdec":
            return {"self": encdec_lib.init_decoder_cache(cfg, batch, max_len, self.dtype,
                                                          self.device),
                    "cross": encdec_lib.init_cross_cache(cfg, batch, self.dtype, self.device)}
        return tf_lib.init_stack_cache(cfg, batch, max_len, self.dtype, self.device)

    @torch.no_grad()
    def prefill(self, params: Params, batch: dict[str, Any]):
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        h, caches = self.forward(params, tokens, positions, mode="prefill",
                                 frames=batch.get("frames"))
        with dsp.use_dispatcher(self.dispatcher):
            lg = logits_fn(self.cfg, params["embed"], h[:, -1:])
        return caches, lg

    @torch.no_grad()
    def decode_step(self, params: Params, caches, token: torch.Tensor, pos: torch.Tensor):
        """token: (B, 1) int32; pos: (B,) int32 absolute positions. Writes
        the step into `caches` in place and returns them with the logits."""
        positions = pos[:, None]
        h, caches = self.forward(params, token, positions, mode="decode",
                                 caches=caches)
        with dsp.use_dispatcher(self.dispatcher):
            lg = logits_fn(self.cfg, params["embed"], h)
        return caches, lg


def build_model(cfg: ModelConfig, dispatcher: KernelDispatcher | None = None, *,
                device: str | torch.device = "cuda") -> Model:
    tf_lib.check_supported(cfg)
    return Model(cfg=cfg, device=torch.device(device),
                 dispatcher=dispatcher or KernelDispatcher())
