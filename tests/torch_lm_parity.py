"""Shared pieces of the LM parity tiers (tests/test_torch_models.py,
tests/test_torch_lm_serve.py): each reduced arch's reference model, params
and jitted serve functions, built once a process, the port's model with
the same params, seeded inputs, and the reference's cache widened with
numpy for decoding past the prompt.

The reference's own ``ServeEngine`` decodes into a prefill cache of exactly
S slots, so its first step overwrites token 0. The tests do not change the
reference: they widen its cache here, as the port's engine does, and drive
the reference's ``prefill`` + ``decode_step`` over it.
"""
import functools
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduce_config
from repro.data.synthetic import make_token_batch
from repro.models.api import Model as JModel

from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_config as t_reduce_config
from repro_torch.models.api import Model
from repro_torch.models.schema import params_from_numpy

B, S, MAX_NEW = 2, 16, 4
ENC_FRAMES = 8
#: Greedy near-tie rule: where the reference's best two logits lie within
#: this of each other, either token is accepted (and the margin reported).
#: The port's float32 logits agree with the reference's to ~1e-5.
TIE_ATOL = 1e-4


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference(arch: str):
    """The reduced arch's reference model, params (PRNGKey(0)), jitted
    dense prefill and decode step; the port's model and the same params
    on the CPU."""
    jm = JModel.from_config(reduce_config(get_config(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model.from_config(t_reduce_config(t_get_config(arch)))
    return SimpleNamespace(
        jm=jm, jp=jp, tm=tm, tp=params_from_numpy(to_np(jp), "cpu"),
        prefill=jax.jit(lambda p, b: jm.prefill(p, b, attn_mode="dense")),
        decode=jax.jit(jm.decode_step))


def arch_batch(cfg, seed=0, s=S):
    """Seeded numpy inputs of a prefill: tokens, and the frames (enc-dec)
    or the frontend embeds (vision)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": make_token_batch(cfg.vocab, B, s, seed=seed)}
    if cfg.encoder_layers:
        b["frames"] = rng.normal(size=(B, ENC_FRAMES, cfg.frontend_dim)
                                 ).astype(np.float32)
    elif cfg.frontend:
        b["frontend"] = rng.normal(size=(B, cfg.frontend_len,
                                         cfg.frontend_dim)).astype(np.float32)
    return b


def prompt_len(cfg, batch) -> int:
    """Positions a prefill consumes: the frontend's embeds come first."""
    s = batch["tokens"].shape[1]
    return s + (batch["frontend"].shape[1] if "frontend" in batch else 0)


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: (torch.from_numpy(v).long() if k == "tokens"
                else torch.from_numpy(v)) for k, v in batch.items()}


def widen_np(jm, cache, b, s_cache, s_enc=0):
    """The reference's prefill cache with every leaf shorter than
    ``jm.abstract_cache(b, s_cache, s_enc)``'s zero-padded on its slot axis
    (-3): the attention K/V, windowed layers up to their window."""
    target = jm.abstract_cache(b, s_cache, s_enc)

    def widen(x, like):
        x = np.asarray(x)
        if x.shape == like.shape:
            return x
        pad = [(0, 0)] * x.ndim
        pad[-3] = (0, like.shape[-3] - x.shape[-3])
        return np.pad(x, pad)

    return jax.tree_util.tree_map(widen, cache, target)


def reference_greedy(ref, batch, tokens, max_new=MAX_NEW):
    """Drive the reference's prefill + decode steps over a widened cache,
    feeding ``tokens`` [B, max_new] (the port's choices), and check each
    is the reference's greedy pick, or within ``TIE_ATOL`` of it.
    Returns the near-tie margins met (step, row, margin)."""
    cfg = ref.jm.cfg
    logits, cache = ref.prefill(ref.jp, as_jax(batch))
    n = prompt_len(cfg, batch)
    s_enc = batch["frames"].shape[1] if cfg.encoder_layers else 0
    cache = widen_np(ref.jm, cache, B, n + max_new, s_enc)
    pos = np.full((B,), n, np.int32)
    ties = []
    for i in range(max_new):
        row = np.asarray(logits[:, -1], np.float32)
        best = row.argmax(-1)
        for r in range(B):
            t = int(tokens[r, i])
            if t != best[r]:
                margin = float(row[r, best[r]] - row[r, t])
                assert margin <= TIE_ATOL, (
                    f"step {i} row {r}: token {t}, reference {best[r]} "
                    f"(margin {margin:.3e})")
                ties.append((i, r, margin))
        logits, cache = ref.decode(ref.jp, cache,
                                   jnp.asarray(tokens[:, i:i + 1]),
                                   jnp.asarray(pos))
        pos = pos + 1
    if ties:
        print(f"near ties accepted: {ties}")
    return ties
