"""Batched serving engine: prefill + decode loop over the Model API.

Single-program batching (all requests padded to a common prefill length,
aligned decode steps).

Before the first decode step every attention cache is widened from the
prefill's S slots to ``min(window or inf, S + max_new)``: the new slots are
zero and masked by ``kv_mask`` until written, and token j stays at slot
``j % sc``. A decode at position S into a cache of exactly S slots would
overwrite token 0, turning every full-attention layer into a sliding
window of S.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.dispatch import resolve_device
from ..models.api import Model
from ..models.schema import tree_map


def widen_cache(model: Model, cache: dict, batch: int, s_cache: int,
                s_enc: int = 0) -> dict:
    """``cache`` with every leaf that is shorter than
    ``model.abstract_cache(batch, s_cache, s_enc)``'s zero-padded on its slot
    axis (-3) to that length: the attention K/V (windowed layers stop at
    their window). State leaves (SSM, RWKV, cross-K/V) do not depend on
    ``s_cache`` and stay as they are."""
    target = model.abstract_cache(batch, s_cache, s_enc)

    def widen(t, like):
        if t.shape == like.shape:
            return t
        extra = like.shape[-3] - t.shape[-3]
        if extra < 0 or t.shape[:-3] + t.shape[-2:] != \
                like.shape[:-3] + like.shape[-2:]:
            raise ValueError(f"cache leaf {tuple(t.shape)} does not widen to "
                             f"{tuple(like.shape)}")
        return F.pad(t, (0, 0, 0, 0, 0, extra))

    return tree_map(widen, cache, target)


@dataclass
class ServeEngine:
    """Greedy (``temperature`` 0) or temperature sampling over ``model``
    with ``params`` on ``device`` (None = the card). Temperature draws come
    from a ``torch.Generator`` on the device seeded with ``seed``."""
    model: Model
    params: dict
    temperature: float = 0.0
    seed: int = 0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _start(self, tokens: np.ndarray, max_new: int, frontend):
        """Prefill ``tokens`` [B, S] and widen its cache for ``max_new``
        decode steps. -> (logits, cache, the first decode's positions)."""
        cfg, dev = self.model.cfg, self.device
        b, s = tokens.shape
        toks = torch.as_tensor(np.asarray(tokens), device=dev).long()
        batch = {"tokens": toks}
        s_enc = 0
        if cfg.encoder_layers:
            batch["frames"] = torch.as_tensor(np.asarray(frontend),
                                              device=dev)
            s_enc = batch["frames"].shape[1]
        elif frontend is not None:
            batch["frontend"] = torch.as_tensor(np.asarray(frontend),
                                                device=dev)
            s += batch["frontend"].shape[1]    # the embeds' positions first
        logits, cache = self.model.prefill(self.params, batch,
                                           attn_mode="dense")
        cache = widen_cache(self.model, cache, b, s + max_new, s_enc)
        return logits, cache, torch.full((b,), s, dtype=torch.long,
                                         device=dev)

    @torch.no_grad()
    def generate(self, tokens: np.ndarray, max_new: int = 16,
                 frontend=None) -> np.ndarray:
        """tokens [B, S] -> generated [B, max_new]."""
        logits, cache, pos = self._start(tokens, max_new, frontend)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        out = []
        tok = self._sample(logits[:, -1], gen)
        for _ in range(max_new):
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, cache,
                                                   tok[:, None], pos)
            tok = self._sample(logits[:, -1], gen)
            pos = pos + 1
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def greedy_margins(self, tokens: np.ndarray, gen: np.ndarray,
                       frontend=None) -> np.ndarray:
        """How far each token of ``gen`` [B, n] lies below the greedy pick
        of this engine's prefill + decode loop, each step fed ``gen``'s
        token: [n, B] float32, 0 where ``gen`` holds the argmax. A near-tie
        rule accepts another engine's greedy tokens (the card's, say) where
        every margin stays within its tolerance."""
        logits, cache, pos = self._start(tokens, gen.shape[1], frontend)
        out = []
        for i in range(gen.shape[1]):
            row = logits[:, -1].float()
            tok = torch.as_tensor(np.asarray(gen[:, i]),
                                  device=self.device).long()
            out.append(row.amax(-1) - row.gather(1, tok[:, None])[:, 0])
            logits, cache = self.model.decode_step(self.params, cache,
                                                   tok[:, None], pos)
            pos = pos + 1
        return torch.stack(out).cpu().numpy()

    def _sample(self, logits, gen: torch.Generator):
        if self.temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float() / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
