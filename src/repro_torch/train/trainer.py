"""Training loop substrate: microbatched gradient accumulation, remat
policies, AdamW, LR schedule, checkpoint/restart hooks. ``make_train_step``
builds one step (forward + backward + optimizer update), eager on the
params' device. Under a sharding policy (``models/sharding.py``) the
params are DTensors placed by ``Model.param_shardings``: the step places
the batch by the policy and runs the same code on the mesh.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from ..ft.checkpoint import save_checkpoint
from ..models import sharding
from ..models.api import Model
from ..models.schema import tree_leaves, tree_map, tree_unflatten
from ..models.transformer import torch_dtype
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..optim.schedule import warmup_cosine


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1           # grad-accumulation steps per train step
    remat: str | None = "dots"      # None | "dots" | "full"
    attn_mode: str = "flash"
    ssm_mode: str = "chunk"
    loss_chunk: int | None = None   # chunked x-ent (big-vocab configs)
    remat_group: int = 1            # checkpoint a run of g periods
    warmup: int = 100
    total_steps: int = 10_000


def on_mesh(params):
    """The context a program over ``params`` runs in: DTensor params take
    the model's plain tensors (positions, masks, accumulators) as
    replicated; plain params need nothing."""
    if sharding.is_dtensor(tree_leaves(params)[0]):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd, taken on
    detached aliases of the params (which stay as they were). DTensor
    gradients come back placed as their params."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with on_mesh(params):
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    grads = [g.redistribute(p.device_mesh, p.placements)
             if sharding.is_dtensor(g) else g
             for g, p in zip(grads, tree_leaves(params))]
    return loss.detach(), tree_unflatten(params, grads)


_BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "frames": ("batch", "seq", None),
               "frontend": ("batch", "seq", None)}


def place_batch(batch: dict) -> dict:
    """A batch of full tensors placed by the active policy (each rank
    keeps its own rows; unchanged without a policy)."""
    return {k: v if sharding.is_dtensor(v) else sharding.distribute(
                v, sharding.sharding_for_shape(v.shape, *_BATCH_AXES[k]))
            for k, v in batch.items()}


def _microbatch(v, mb: int, i: int):
    """Microbatch i of mb along the leading axis: contiguous global rows,
    as the reference splits (a DTensor is gathered first); placed
    afterwards, each data-parallel rank takes its share of them."""
    if sharding.is_dtensor(v):
        v = v.full_tensor()
    return v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]


def make_train_step(model: Model, opt_cfg: AdamWConfig, tcfg: TrainConfig):
    """-> train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` is a dict of tensors on the params' device, placed here by
    the active policy. With microbatches > 1 the batch's leading axis is
    split into runs of contiguous rows before placing, and the gradients
    are summed in fp32 over the microbatches in order and divided by their
    count (memory: one microbatch's activations); the loss is the mean of
    the microbatch losses. ``opt_state`` is updated in place
    (``adamw_update``)."""
    def loss_fn(p, b):
        return model.loss(p, b, attn_mode=tcfg.attn_mode,
                          ssm_mode=tcfg.ssm_mode, remat=tcfg.remat,
                          loss_chunk=tcfg.loss_chunk,
                          remat_group=tcfg.remat_group)

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb > 1:
            loss = None
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32,
                memory_format=torch.contiguous_format), params)
            for i in range(mb):
                part = place_batch({k: _microbatch(v, mb, i)
                                    for k, v in batch.items()})
                l, g = value_and_grad(loss_fn, params, part)
                loss = l if loss is None else loss + l
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.to(torch.float32))
                del g
            loss = loss / mb
            grads = tree_map(lambda g: g / mb, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, place_batch(batch))
        lr_scale = warmup_cosine(opt_state["step"], warmup=tcfg.warmup,
                                 total=tcfg.total_steps)
        with on_mesh(params):
            params, opt_state, metrics = adamw_update(
                grads, opt_state, opt_cfg, lr_scale=lr_scale,
                model_dtype=torch_dtype(model.cfg.dtype))
        metrics["loss"] = loss.full_tensor() if sharding.is_dtensor(loss) else loss
        return params, opt_state, metrics

    return train_step


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``:
    token ids as int64, the rest as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device)
    return out


@dataclass
class TrainLoop:
    """Host-side loop: data pipeline, checkpointing, fault tolerance hooks."""
    model: Model
    opt_cfg: AdamWConfig = field(default_factory=AdamWConfig)
    tcfg: TrainConfig = field(default_factory=TrainConfig)
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None

    def run(self, params, batches, *, opt_state=None, hooks=(),
            start_step: int = 0):
        """batches: iterable of batch dicts (numpy or tensors), moved to the
        params' device. Returns (params, opt_state, history); each history
        entry holds ``step``, ``loss``, ``grad_norm`` and ``sec``, the host
        wall of the step up to the loss's read."""
        step_fn = make_train_step(self.model, self.opt_cfg, self.tcfg)
        opt_state = opt_state or init_opt_state(params)
        dev = tree_leaves(params)[0].device
        history = []
        for i, batch in enumerate(batches):
            step = start_step + i
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_to(batch, dev))
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "sec": time.perf_counter() - t0})
            for h in hooks:
                h(step, params, opt_state, history[-1])
            if self.checkpoint_every and self.checkpoint_dir and \
                    (step + 1) % self.checkpoint_every == 0:
                save_checkpoint(self.checkpoint_dir, step + 1, params,
                                opt_state)
        return params, opt_state, history
