"""Model facade: init / train loss / prefill / decode on the port's decoders
(dense, MoE, MLA, the RG-LRU hybrid, the SSM) and encoder-decoder.

After `src/repro/models/model.py` (`Model` :42, `init` :68, `_backbone` :97,
`forward` :119, `loss` :136, `_mtp_loss` :160, `init_cache` :191,
`prefill` :206, `decode_step` :216, `prefill_chunk` :225, `_xent` :272,
`build_model` :298):

    init(generator)                                -> params
    loss(params, batch)                            -> (scalar, metrics)
    prefill(params, batch)                         -> (caches, last_logits)
    decode_step(params, caches, token, pos)        -> (caches, logits)
    prefill_chunk(params, caches, tokens, pos0)    -> (caches, last_logits)
    init_cache(batch, max_len)                     -> caches

Every matmul and attention cell runs through the model's `KernelDispatcher`
(the port has no undispatched path): on a CUDA device the hand-written
kernels, on the CPU their plain versions. An encoder-decoder (family
"encdec", whisper-small) prefills from `batch["frames"]`: the encoder runs
once, the cross K/V of every decoder layer is built from its output, and
the caches are `{"self": ..., "cross": ...}`; decode reads the resident
cross K/V and ignores frames. A decoder's caches are its stack's
(`transformer.init_stack_cache`): K/V rings for attention layers (of
`min(max_len, attn_window)` slots for a sliding-window layer), and for
recurrent layers state with no time axis (the RG-LRU's `h` / `conv`, the
SSM's `state` / `conv_x` / `conv_bc`), which decode and a prefill chunk
update in place like the K/V; an MLA layer caches its latent (`c_kv`,
`k_rope`, `pos`). A config with `mtp_depth` (deepseek-v3-671b) draws the
multi-token-prediction module's parameters as the reference does
(`init`, reference :73-85): `mtp/proj` (2d, d), the norms `ln_h` / `ln_e` and
`mtp/layer`, one layer of the last layer's signature with no stack axis. No
served program reads them: only the training loss does (`_mtp_loss`).

`loss` runs the stack in mode "train" (no caches, each unit under the
config's remat policy) with autograd on: the dense matmuls, flash and the
conv stem differentiate through their kernels' autograd wrappers
(`models.dispatched`), everything else through plain PyTorch ops.
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
from repro_torch.models.attention import NEG_INF
from repro_torch.models.layers import (Params, apply_norm, embed_tokens, init_embed,
                                       init_norm, logits as logits_fn, normal)

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
        `gen` (a generator on the model's device), the MTP module's
        included."""
        cfg = self.cfg
        params = {"embed": init_embed(gen, cfg, self.dtype),
                  "final_ln": init_norm(cfg, cfg.d_model, self.device)}
        if cfg.family == "encdec":
            params["encdec"] = encdec_lib.init_encdec_stacks(gen, cfg, self.dtype)
        else:
            params["layers"] = tf_lib.init_stack(gen, cfg, self.dtype)
        if cfg.mtp_depth:
            d = cfg.d_model
            sig = tf_lib.layer_signature(cfg, cfg.n_layers - 1)
            params["mtp"] = {
                "proj": normal(gen, (2 * d, d), self.dtype, (2 * d) ** -0.5),
                "ln_h": init_norm(cfg, d, self.device),
                "ln_e": init_norm(cfg, d, self.device),
                "layer": tf_lib.init_layer(gen, cfg, sig, self.dtype, None),
            }
        return params

    def _backbone(self, params: Params, x: torch.Tensor, positions: torch.Tensor, *,
                  mode: str, caches=None, frames: torch.Tensor | None = None):
        """(x, caches, the MoE balance loss)."""
        cfg = self.cfg
        if cfg.family != "encdec":
            return tf_lib.apply_stack(cfg, params["layers"], x, positions, mode=mode,
                                      caches=caches)
        if mode == "decode":
            cross = caches["cross"]               # built at prefill; resident
        else:
            if frames is None:
                raise ValueError(f"{cfg.name}: {mode} needs batch['frames'] "
                                 f"{cfg.frame_shape} per request")
            enc_out = encdec_lib.encode(cfg, params["encdec"], frames)
            cross = encdec_lib.build_cross_cache(cfg, params["encdec"], enc_out)
        x, self_caches = encdec_lib.decoder_stack(
            cfg, params["encdec"], x, positions, mode=mode, cross=cross,
            caches=caches["self"] if mode == "decode" else None)
        new_caches = None if mode == "train" else {"self": self_caches, "cross": cross}
        return x, new_caches, None

    def _forward(self, params: Params, tokens: torch.Tensor, positions: torch.Tensor, *,
                 mode: str, caches=None, frames: torch.Tensor | None = None):
        """(the final-normed hidden states, caches, the MoE balance loss:
        None where no layer is MoE, and always in serving modes)."""
        with dsp.use_dispatcher(self.dispatcher):
            x = embed_tokens(params["embed"], tokens).to(self.dtype)
            x, new_caches, aux = self._backbone(
                params, x, positions, mode=mode, caches=caches,
                frames=None if mode == "decode" else frames)
            h = apply_norm(self.cfg, params["final_ln"], x)
        return h, new_caches, aux

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, *, mode: str, caches=None,
                frames: torch.Tensor | None = None):
        """(h, caches). Decode ignores `frames`: an encoder-decoder reads its
        cross K/V from the caches."""
        h, new_caches, _ = self._forward(params, tokens, positions, mode=mode,
                                         caches=caches, frames=frames)
        return h, new_caches

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def loss(self, params: Params, batch: dict[str, Any]) -> tuple[torch.Tensor, dict]:
        """Next-token cross entropy with fp32 logits, plus 1e-4 z-loss and
        1e-2 the MoE balance loss, plus 0.3 the MTP loss where the params
        hold the MTP module (reference :136-158). Differentiable in every
        dense param."""
        cfg = self.cfg
        tokens, targets = batch["tokens"], batch["targets"]          # (B, S)
        lg, h, positions, aux = self._train_logits(params, batch)
        b, s = tokens.shape
        with dsp.use_dispatcher(self.dispatcher):
            ce, z = xent(lg, targets, cfg.vocab)
            loss = ce + 1e-4 * z + 1e-2 * aux
            metrics = {"ce": ce, "zloss": z, "moe_aux": aux,
                       "tokens": torch.tensor(float(b * s), device=tokens.device)}
            if cfg.mtp_depth and "mtp" in params:
                mtp = self._mtp_loss(params, tokens, targets, h, positions)
                loss = loss + 0.3 * mtp
                metrics["mtp"] = mtp
        metrics["loss"] = loss
        return loss, metrics

    def token_losses(self, params: Params, batch: dict[str, Any]) -> torch.Tensor:
        """Each token's next-token cross entropy (B, S), fp32, through the
        training forward: `loss`'s `ce` is their mean."""
        lg = self._train_logits(params, batch)[0]
        return token_xent(lg, batch["targets"], self.cfg.vocab)[0]

    def _train_logits(self, params: Params, batch: dict[str, Any]):
        """(fp32 logits (B, S, V), the final-normed hidden states, the
        positions, the MoE balance loss or a zero) of the training forward."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
        h, _, aux = self._forward(params, tokens, positions, mode="train",
                                  frames=batch.get("frames"))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        with dsp.use_dispatcher(self.dispatcher):
            lg = logits_fn(self.cfg, params["embed"], h)
        return lg, h, positions, aux

    def _mtp_loss(self, params: Params, tokens: torch.Tensor, targets: torch.Tensor,
                  h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction at depth 1 (reference
        :160-189): position t predicts token t+2 from the main stream at t
        merged with the embedding of token t+1, through one more layer of
        the last layer's signature; at full length (rolled, the last two
        positions masked)."""
        cfg = self.cfg
        p = params["mtp"]
        h_in = apply_norm(cfg, p["ln_h"], h)
        next_tok = torch.roll(tokens, -1, dims=1)          # t+1 (the last column is junk)
        e_next = apply_norm(cfg, p["ln_e"], embed_tokens(params["embed"], next_tok).to(h.dtype))
        x = dsp.linear(torch.cat([h_in, e_next], dim=-1), p["proj"])
        sig = tf_lib.layer_signature(cfg, cfg.n_layers - 1)
        x, _, _ = tf_lib.apply_layer(cfg, sig, p["layer"], x, positions, mode="train",
                                     cache=None)
        lg = logits_fn(cfg, params["embed"], apply_norm(cfg, params["final_ln"], x))
        s = tokens.shape[1]
        mask = (torch.arange(s, device=tokens.device) < s - 2).float()[None, :]
        ce, _ = xent(lg, torch.roll(targets, -1, dims=1), cfg.vocab, mask=mask)
        return ce

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

    @torch.no_grad()
    def prefill_chunk(self, params: Params, caches, tokens: torch.Tensor,
                      pos0: torch.Tensor):
        """One prefill chunk: the C prompt tokens `tokens` (B, C) int32 from
        absolute position `pos0` (B,) int32 written into the decode-shaped
        `caches` in place, as C decode steps would write them, each attending
        up to its own position. Returns (caches, the last token's logits),
        the contract of `prefill`; (B, C) is the program's whole shape."""
        c = tokens.shape[1]
        positions = pos0[:, None] + torch.arange(c, dtype=pos0.dtype, device=pos0.device)[None]
        h, caches = self.forward(params, tokens, positions, mode="decode", caches=caches)
        with dsp.use_dispatcher(self.dispatcher):
            lg = logits_fn(self.cfg, params["embed"], h[:, -1:])
        return caches, lg


def xent(lg: torch.Tensor, targets: torch.Tensor, vocab: int,
         mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cross entropy, z-loss) over the true vocab (reference `_xent`,
    :272-296): padded vocab slots masked to -1e30 in fp32, the max taken
    without a gradient, the target's logit picked by compare-select (no
    gather), each averaged over the tokens or, with a (1, S) `mask`, over
    the unmasked ones."""
    per_tok, z_tok = token_xent(lg, targets, vocab)
    if mask is None:
        return per_tok.mean(), z_tok.mean()
    denom = torch.clamp(mask.sum() * per_tok.shape[0] / mask.shape[0], min=1.0)
    return (per_tok * mask).sum() / denom, (z_tok * mask).sum() / denom


def token_xent(lg: torch.Tensor, targets: torch.Tensor,
               vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`xent`'s per-token terms: (cross entropy, squared log-normalizer),
    each of the targets' shape."""
    lg = lg.float()
    v = lg.shape[-1]
    cols = torch.arange(v, device=lg.device)
    lg = torch.where(cols < vocab, lg, torch.full((), NEG_INF, device=lg.device))
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    picked = torch.sum(torch.where(cols == targets[..., None], lg,
                                   torch.zeros((), device=lg.device)), dim=-1)
    return lse - picked, lse ** 2


def build_model(cfg: ModelConfig, dispatcher: KernelDispatcher | None = None, *,
                device: str | torch.device = "cuda") -> Model:
    tf_lib.check_supported(cfg)
    return Model(cfg=cfg, device=torch.device(device),
                 dispatcher=dispatcher or KernelDispatcher())
