"""Unified model API over decoder-only and encoder-decoder families.

`Model.from_config(cfg)` gives: schema/init/abstract params, `loss`
(train), `prefill`, `decode_step` (serve), `abstract_cache` and
`input_specs` — the interface the trainer, the serving engine, the
launchers and the tests consume.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.dispatch import resolve_device
from . import encdec, schema as schema_lib, transformer
from .transformer import ModelConfig, torch_dtype


@dataclass
class Model:
    cfg: ModelConfig
    schema: dict

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "Model":
        sch = encdec.build_encdec_schema(cfg) if cfg.encoder_layers \
            else transformer.build_schema(cfg)
        return cls(cfg=cfg, schema=sch)

    # ------------------------------------------------------------ params
    def init(self, seed: int = 0, dtype: torch.dtype | None = None,
             device=None, shardings=None) -> dict:
        """Random params on ``device`` (None = the card), drawn from a
        ``torch.Generator`` on that device seeded with ``seed``; placed leaf
        by leaf by ``shardings`` (``param_shardings()``) where given."""
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        return schema_lib.init_params(self.schema, g,
                                      dtype or torch_dtype(self.cfg.dtype),
                                      shardings)

    def abstract_params(self, dtype: torch.dtype | None = None) -> dict:
        return schema_lib.abstract_params(self.schema,
                                          dtype or torch_dtype(self.cfg.dtype))

    def param_shardings(self):
        return schema_lib.param_shardings(self.schema)

    def param_specs(self):
        return schema_lib.param_specs(self.schema)

    def n_params(self) -> int:
        return schema_lib.count_params(self.schema)

    # ------------------------------------------------------------ train
    def loss(self, params, batch, *, attn_mode="flash", ssm_mode="chunk",
             remat=None, loss_chunk=None, remat_group=1):
        """Scalar float32 training loss of ``batch`` (``tokens``,
        ``labels``, and ``frames`` or ``frontend`` where the arch has
        them), differentiable by autograd."""
        cfg = self.cfg
        if cfg.encoder_layers:
            return encdec.encdec_loss(params, cfg, batch["frames"],
                                      batch["tokens"], batch["labels"],
                                      attn_mode=attn_mode,
                                      loss_chunk=loss_chunk,
                                      remat=remat)
        return transformer.loss_fn(
            params, cfg, batch["tokens"], batch["labels"],
            frontend_embeds=batch.get("frontend"),
            attn_mode=attn_mode, ssm_mode=ssm_mode, remat=remat,
            loss_chunk=loss_chunk, remat_group=remat_group)

    # ------------------------------------------------------------ serve
    def prefill(self, params, batch, *, attn_mode="flash", ssm_mode="chunk"):
        """-> (last logits [B, 1, V], cache). The encoder-decoder's cache
        holds the prompt's decoder self-K/V (token j at slot j) beside the
        cross-K/V of the encoded frames."""
        cfg = self.cfg
        if cfg.encoder_layers:
            memory = encdec.encode(params, cfg, batch["frames"], attn_mode)
            logits, cache = encdec.decode_train(params, cfg, memory,
                                                batch["tokens"], attn_mode,
                                                return_cache=True)
            return logits[:, -1:], cache
        logits, cache, _ = transformer.forward(
            params, cfg, batch["tokens"], phase="prefill",
            frontend_embeds=batch.get("frontend"),
            attn_mode=attn_mode, ssm_mode=ssm_mode)
        return logits, cache

    def decode_step(self, params, cache, token, pos):
        cfg = self.cfg
        if cfg.encoder_layers:
            return encdec.decode_step(params, cfg, cache, token, pos)
        logits, new_cache, _ = transformer.forward(
            params, cfg, token, phase="decode", cache=cache, pos=pos,
            attn_mode="dense")
        return logits, new_cache

    def abstract_cache(self, batch: int, s_cache: int, s_enc: int = 0):
        cfg = self.cfg
        if cfg.encoder_layers:
            return encdec.abstract_encdec_cache(cfg, batch, s_cache,
                                                s_enc or s_cache)
        return transformer.abstract_cache(cfg, batch, s_cache)

    # ------------------------------------------------------------ inputs
    def input_specs(self, shape, *, for_loss=True) -> dict:
        """``meta`` stand-ins for every model input of a shape cell."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        dt = torch_dtype(cfg.dtype)
        meta = transformer._meta
        if cfg.encoder_layers:
            # audio: encoder frames take the sequence budget; text decode side
            st = min(s, 4096) if shape.kind == "train" else min(s, 1024)
            return {"frames": meta((b, s, cfg.frontend_dim), dt),
                    "tokens": meta((b, st), i32),
                    "labels": meta((b, st), i32)}
        text_len = s - (cfg.frontend_len if cfg.frontend else 0)
        specs = {"tokens": meta((b, text_len), i32)}
        if for_loss:
            specs["labels"] = meta((b, text_len), i32)
        if cfg.frontend:
            specs["frontend"] = meta((b, cfg.frontend_len, cfg.frontend_dim),
                                     dt)
        return specs
