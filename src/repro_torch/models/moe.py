"""Mixture-of-Experts layer (GShard/Mixtral style) with sort-based dispatch.

Dispatch is capacity-bounded with static shapes: tokens are sorted (stably)
by assigned expert, ranked within their expert group, and slots beyond
capacity C = ceil(T*K/E * capacity_factor) are dropped (GShard token
dropping; the residual path keeps dropped tokens intact). Supports shared
experts (DeepSeek-MoE) and top-k routing with renormalised gates.

Tie order follows the reference: the router's top-k breaks ties to the
lower expert index (a stable descending sort) and the dispatch's sort is
stable. The combine's scatter-add is ``index_add_``, which sums with
atomics on a CUDA tensor: card and CPU agree to a tolerance, not bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .sharding import is_dtensor, shard, sharding_for_shape


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                # per-expert FFN width
    n_shared: int = 0            # DeepSeek shared experts
    capacity_factor: float = 1.25
    every: int = 1               # MoE replaces the MLP every `every` layers


def router_probs(x, w_router):
    logits = x.float() @ w_router.float()
    return torch.softmax(logits, dim=-1), logits


def stable_topk(x, k: int):
    """The ``k`` largest along the last axis, ties to the lower index
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_one_group(flat, gate_idx, gate_vals, e, k, cap):
    """Sort-based capacity dispatch for ONE token group [T_g, D]."""
    t, d = flat.shape
    dev = flat.device
    expert_flat = gate_idx.reshape(-1)                          # [T*K]
    token_flat = torch.arange(t, device=dev).repeat_interleave(k)
    gates_flat = gate_vals.reshape(-1)
    order = torch.sort(expert_flat, stable=True).indices
    se, st_tok, sg = expert_flat[order], token_flat[order], gates_flat[order]
    group_start = torch.searchsorted(se, torch.arange(e, device=dev,
                                                      dtype=se.dtype))
    rank = torch.arange(t * k, device=dev) - group_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(rank, e * cap))          # overflow bin
    x_slots = torch.zeros((e * cap + 1, d), dtype=flat.dtype, device=dev)
    x_slots[slot] = flat[st_tok]
    return x_slots[:-1].reshape(e, cap, d), (slot, st_tok, sg, keep)


def _combine_one_group(y_e, meta, t, d):
    slot, st_tok, sg, keep = meta
    e, cap, _ = y_e.shape
    y_slots = torch.cat([y_e.reshape(e * cap, d),
                         torch.zeros((1, d), dtype=y_e.dtype,
                                     device=y_e.device)], 0)
    contrib = y_slots[slot] * sg[:, None].to(y_e.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    return torch.zeros((t, d), dtype=y_e.dtype, device=y_e.device
                       ).index_add_(0, st_tok, contrib)


def _route(x, router, e: int, k: int, cap: int):
    """The row-local half before the experts: routing, the load-balance
    statistics and the grouped dispatch, one group a batch row (a loop over
    rows stands for the reference's vmap). x [B, S, D] -> x_e [B, E, C, D],
    the combine's slot, token, gate and keep rows [B, S*K] each, the router
    probabilities summed over the tokens [E] and the tokens routed to each
    expert [E]."""
    b, s, d = x.shape
    probs, _ = router_probs(x.reshape(-1, d), router)          # [T, E]
    gate_vals, gate_idx = stable_topk(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device
                         ).index_add_(0, gate_idx.reshape(-1),
                                      torch.ones((gate_idx.numel(),),
                                                 dtype=torch.float32,
                                                 device=x.device))
    gv = gate_vals.reshape(b, s, k)
    gi = gate_idx.reshape(b, s, k)
    groups = [_dispatch_one_group(x[i], gi[i], gv[i], e, k, cap)
              for i in range(b)]
    meta = [torch.stack(m) for m in zip(*(g[1] for g in groups))]
    return (torch.stack([g[0] for g in groups]), *meta, probs.sum(0),
            counts)


def _combine(y_e, slot, st_tok, sg, keep, s: int):
    """The row-local half after the experts: each row's expert outputs
    back to its ``s`` tokens. y_e [B, E, C, D] -> [B, S, D]."""
    return torch.stack([_combine_one_group(
        y_e[i], (slot[i], st_tok[i], sg[i], keep[i]), s, y_e.shape[-1])
        for i in range(y_e.shape[0])])


def _on_row_shards(route, combine, shape):
    """``route`` and ``combine`` of a DTensor x [B, S, D], each run on every
    rank's own batch rows, which are their own dispatch groups (the stable
    sorts and the dispatch and combine scatters have no DTensor rule). The
    token statistics and the router's gradient are partial sums over the
    mesh dimensions that split the rows."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    rows = sharding_for_shape(shape, "batch", None, None)
    mesh, row = rows.mesh, rows.placements
    part = tuple(Partial() if p.is_shard() else Replicate() for p in row)
    rep = (Replicate(),) * mesh.ndim
    route = local_map(route, out_placements=(row,) * 5 + (part, part),
                      in_placements=(row, rep), in_grad_placements=(row, part),
                      redistribute_inputs=True, device_mesh=mesh)
    combine = local_map(combine, out_placements=(row,),
                        in_placements=(row,) * 5, redistribute_inputs=True,
                        device_mesh=mesh)
    return route, combine


def moe_layer(x, params, cfg: MoEConfig, phase: str = "train"):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar).

    GShard-style grouped dispatch: each batch row is its own dispatch group
    with its own capacity. On a DTensor x the routing and the combine run
    on each rank's own rows (``_on_row_shards``) and the experts' FFN on
    DTensors, sharded by expert.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(-(-s * k * cfg.capacity_factor // e)))

    def route(xr, router):
        return _route(xr, router, e, k, cap)

    def combine(*a):
        return _combine(*a, s)

    if is_dtensor(x):
        route, combine = _on_row_shards(route, combine, x.shape)
    x_e, *meta, probs_sum, counts = route(x, params["router"])

    # ---- load-balance auxiliary loss (Switch/GShard form, global)
    t_all = b * s
    me = probs_sum / t_all
    ce = counts / (t_all * k)
    aux = e * (me * ce).sum()

    if phase == "decode":
        x_e = shard(x_e, None, "expert", None, "expert_embed")
    else:
        x_e = shard(x_e, "batch", "expert", None, None)

    # ---- per-expert FFN (swiglu), weights [E, D, F]/[E, F, D]
    h = F.silu(torch.einsum("becd,edf->becf", x_e, params["w_gate"])) * \
        torch.einsum("becd,edf->becf", x_e, params["w_up"])
    y_e = torch.einsum("becf,efd->becd", h, params["w_down"])
    y_e = shard(y_e, "batch", "expert", None, None)

    # ---- combine back per group
    y = shard(combine(y_e, *meta), "batch", "seq", None)

    # ---- shared experts (DeepSeek): always-on dense path
    if cfg.n_shared:
        flat = x.reshape(-1, d)
        hs = F.silu(flat @ params["shared_w_gate"]) * \
            (flat @ params["shared_w_up"])
        y = y + (hs @ params["shared_w_down"]).reshape(b, s, d)

    return y.reshape(b, s, d).to(x.dtype), aux
