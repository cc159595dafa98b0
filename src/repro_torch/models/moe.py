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

from .sharding import shard


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


def moe_layer(x, params, cfg: MoEConfig, phase: str = "train"):
    """x [B, S, D] -> (y [B, S, D], aux_loss scalar).

    GShard-style grouped dispatch: each batch row is its own dispatch group
    with its own capacity (a loop over rows stands for the reference's
    vmap).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(-(-s * k * cfg.capacity_factor // e)))

    probs, _ = router_probs(x.reshape(-1, d), params["router"])  # [T, E]
    gate_vals, gate_idx = stable_topk(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # ---- load-balance auxiliary loss (Switch/GShard form, global)
    t_all = b * s
    me = probs.mean(0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, gate_idx.reshape(-1),
        torch.ones((t_all * k,), dtype=torch.float32, device=x.device)
    ) / (t_all * k)
    aux = e * (me * ce).sum()

    # ---- grouped dispatch, one group a batch row
    gv = gate_vals.reshape(b, s, k)
    gi = gate_idx.reshape(b, s, k)
    xs = x.reshape(b, s, d)
    groups = [_dispatch_one_group(xs[i], gi[i], gv[i], e, k, cap)
              for i in range(b)]
    x_e = torch.stack([g[0] for g in groups])                # [B, E, C, D]
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
    y = torch.stack([_combine_one_group(y_e[i], groups[i][1], s, d)
                     for i in range(b)])
    y = shard(y, "batch", "seq", None)

    # ---- shared experts (DeepSeek): always-on dense path
    if cfg.n_shared:
        flat = x.reshape(-1, d)
        hs = F.silu(flat @ params["shared_w_gate"]) * \
            (flat @ params["shared_w_up"])
        y = y + (hs @ params["shared_w_down"]).reshape(b, s, d)

    return y.reshape(b, s, d).to(x.dtype), aux
