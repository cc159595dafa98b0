"""Shared pieces of the LM training parity tiers (tests/test_torch_train.py,
tests/test_torch_trainer.py, tests/test_torch_ft.py): each reduced arch's
reference model and params (``PRNGKey(0)``, built once a process), the
port's model with the same params, seeded training batches, and the loss
and gradients of both packages as numpy, leaves in ``tree_leaves`` order
(sorted keys in both).
"""
import dataclasses
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
from repro_torch.models.schema import params_from_numpy, tree_leaves
from repro_torch.train.trainer import value_and_grad

B, S = 2, 16
ENC_FRAMES = 8
#: Gradient bound: every leaf within this fraction of the reference leaf's
#: largest magnitude (float32; the worst reduced arch, jamba's Mamba scan,
#: measured 6.0e-06).
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference(arch: str, **changes):
    """The reduced arch (with ``dataclasses.replace`` ``changes`` in both
    packages): the reference model and params, the port's model, and the
    params as numpy."""
    jcfg = dataclasses.replace(reduce_config(get_config(arch)), **changes)
    tcfg = dataclasses.replace(t_reduce_config(t_get_config(arch)), **changes)
    jm = JModel.from_config(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return SimpleNamespace(jm=jm, jp=jp, tm=Model.from_config(tcfg),
                           np_params=to_np(jp))


def port_params(ref, device="cpu"):
    """A fresh copy of the reference's params as the port's tensors."""
    return params_from_numpy(ref.np_params, device)


def train_batch(cfg, seed=0, b=B, s=S):
    """Seeded numpy inputs of a loss: tokens and next-token labels from one
    ``make_token_batch`` stream, and the frames (enc-dec) or the frontend
    embeds (vision)."""
    rng = np.random.default_rng(seed)
    toks = make_token_batch(cfg.vocab, b, s + 1, seed=seed)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder_layers:
        out["frames"] = rng.normal(size=(b, ENC_FRAMES, cfg.frontend_dim)
                                   ).astype(np.float32)
    elif cfg.frontend:
        out["frontend"] = rng.normal(size=(b, cfg.frontend_len,
                                           cfg.frontend_dim)
                                     ).astype(np.float32)
    return out


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: (torch.from_numpy(v).long() if k in ("tokens", "labels")
                else torch.from_numpy(v)) for k, v in batch.items()}


def jax_loss_and_grads(ref, batch, **kw):
    """The reference's jitted value_and_grad of ``Model.loss``."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: ref.jm.loss(p, b, **kw)))
    loss, grads = fn(ref.jp, as_jax(batch))
    return float(loss), [np.asarray(g) for g in
                         jax.tree_util.tree_leaves(grads)]


def torch_loss_and_grads(model, params, batch, **kw):
    """The port's ``Model.loss`` and its autograd gradients."""
    loss, grads = value_and_grad(lambda p, b: model.loss(p, b, **kw),
                                 params, as_torch(batch))
    return float(loss), [g.float().numpy() for g in tree_leaves(grads)]


def assert_grads_close(want, got, rel=GRAD_REL):
    """Leaf by leaf: the same shape, within ``rel`` of the reference leaf's
    largest magnitude."""
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        scale = max(float(np.abs(a).max()), 1e-30)
        err = float(np.abs(a.astype(np.float32) - b).max())
        assert err <= rel * scale, f"leaf {i} {a.shape}: {err:.3e} > " \
            f"{rel} x {scale:.3e}"
