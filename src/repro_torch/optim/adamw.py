"""AdamW with fp32 master weights and per-param fp32 moments.

Memory layout of large-scale practice: model params in the model's dtype
(bf16 at full width), master + m + v in fp32, trees of the params' keys.
The arithmetic is the reference's, op for op (not ``torch.optim.AdamW``,
whose order of rounding differs); m, v and the master are updated in place,
so a step allocates one leaf's transients at a time instead of new trees.
Under a sharding policy the leaves are DTensors placed alike (ZeRO: the
``embed``/``data`` axis shards the optimizer state), and the update runs
on each leaf's local shard: it is elementwise, so its bits are the
unsharded update's given the same global norm.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.schema import tree_leaves, tree_map
from ..models.sharding import is_dtensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _local(t):
    """A DTensor's local shard (a view that in-place updates write
    through); a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def init_opt_state(params) -> dict:
    """Zero moments, the params upcast to fp32 (a copy) as the master, and
    step 0, on the params' device (DTensor leaves: placed as the params)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                       copy=True), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(abstract_params) -> dict:
    """``init_opt_state``'s shapes and dtypes as ``meta`` tensors."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(f32, abstract_params),
            "v": tree_map(f32, abstract_params),
            "master": tree_map(f32, abstract_params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed in
    ``tree_leaves`` order (sorted keys, as ``jax.tree_util`` flattens)."""
    leaves = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


@torch.no_grad()
def adamw_update(grads, opt_state, cfg: AdamWConfig, lr_scale=1.0,
                 model_dtype=torch.bfloat16):
    """-> (new_params in ``model_dtype``, opt_state, metrics). Clips by the
    global norm (``min(1, clip / (norm + 1e-9))``), then bias-corrected
    Adam moments and decoupled weight decay on the fp32 master of every
    leaf. ``opt_state``'s m, v and master are updated in place; its step
    is replaced. The new params are a cast copy of the master. DTensor
    leaves (grads placed as their params) update their local shards; the
    scalars (norm, rates) are replicated."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = _local(torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0))

    stepf = _local(step).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    lr = cfg.lr * torch.as_tensor(_local(lr_scale), dtype=torch.float32,
                                  device=scale.device)

    for g, m, v, w in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"]),
                          tree_leaves(opt_state["master"])):
        g, m, v, w = _local(g), _local(m), _local(v), _local(w)
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        w.sub_(lr * (mhat / (torch.sqrt(vhat) + cfg.eps) +
                     cfg.weight_decay * w))
    new_params = tree_map(lambda w: w.to(model_dtype, copy=True),
                          opt_state["master"])
    new_state = {"m": opt_state["m"], "v": opt_state["v"],
                 "master": opt_state["master"], "step": step}
    if is_dtensor(gnorm):
        gnorm = gnorm.full_tensor()
    return new_params, new_state, {"grad_norm": gnorm, "step": step}
