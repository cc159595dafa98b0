"""State-space / linear-recurrence mixers: Mamba (Jamba) and RWKV-6 (Finch).

Both are attention-free token mixers with data-dependent gating of a
recurrent state; both support three execution paths:

- ``assoc``  — an associative scan over the full sequence (log depth: a
  Hillis–Steele scan of the reference's combine).
- ``chunk``  — a loop over sequence chunks with the same scan inside a
  chunk (O(chunk) memory).
- ``step``   — single-token recurrence for serve-time decode.

Numerical notes: the scan combines (decay, value) pairs as the reference
does, never through a cumulative product or a log-space closed form, where
small decays underflow. Decays live in log space (log w <= 0), and the
RWKV-6 intra-chunk pairwise term materialises exp(Lc_{t-1} - Lc_s) only
for s <= t-1 where the exponent is <= 0 — no overflow for any decay
strength.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .layers import checkpointed
from .sharding import is_dtensor, shard, sharding_for_shape


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0       # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64


# =========================================================== diagonal scan
def _assoc_combine(a, b):
    (aa, au), (ba, bu) = a, b
    return aa * ba, au * ba + bu


def _assoc_scan(a, x):
    """Inclusive scan of ``_assoc_combine`` over axis 1 (Hillis–Steele:
    step 2^j combines each element with the one 2^j before it)."""
    n = a.shape[1]
    step = 1
    while step < n:
        ca, cx = _assoc_combine((a[:, :-step], x[:, :-step]),
                                (a[:, step:], x[:, step:]))
        a = torch.cat([a[:, :step], ca], 1)
        x = torch.cat([x[:, :step], cx], 1)
        step *= 2
    return a, x


def diag_ssm_scan(alpha, u, h0, mode: str = "chunk", chunk: int = 128):
    """h_t = alpha_t * h_{t-1} + u_t over axis 1 of [B, S, ...] tensors.

    Returns (h_all [B, S, ...], h_last [B, ...]).
    """
    if mode == "assoc":
        a = torch.cat([torch.ones_like(alpha[:, :1]), alpha], 1)
        x = torch.cat([h0[:, None], u], 1)
        _, hh = _assoc_scan(a, x)
        return hh[:, 1:], hh[:, -1]
    if mode == "step":
        h = alpha[:, 0] * h0 + u[:, 0]
        return h[:, None], h
    # chunked: loop over chunks, associative scan inside
    s = alpha.shape[1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
    # checkpointed: backward recomputes a chunk's scan instead of keeping
    # its log-depth intermediates
    @checkpointed
    def step(h, a_c, u_c):
        a1 = torch.cat([torch.ones_like(a_c[:, :1]), a_c], 1)
        x1 = torch.cat([h[:, None], u_c], 1)
        _, hh = _assoc_scan(a1, x1)
        return hh[:, -1], hh[:, 1:]

    h, hs = h0, []
    for i in range(0, s, c):
        h, hh = step(h, alpha[:, i:i + c], u[:, i:i + c])
        hs.append(hh)
    return torch.cat(hs, 1), h


# ================================================================== Mamba
def mamba_forward(x, p, mcfg: MambaConfig, state=None, mode: str = "chunk"):
    """x [B, S, D] -> (y [B, S, D], new_state).

    state = (conv_tail [B, d_conv-1, d_inner], h [B, d_inner, d_state]).
    """
    b, s, d = x.shape
    d_inner = p["in_proj"].shape[1] // 2
    dt_rank = p["dt_proj"].shape[0]
    d_state = p["A_log"].shape[1]
    dc = mcfg.d_conv

    xz = x @ p["in_proj"]
    x_in, z = torch.split(xz, d_inner, dim=-1)           # [B, S, d_inner]

    conv_tail = state[0] if state is not None else \
        torch.zeros((b, dc - 1, d_inner), dtype=x.dtype, device=x.device)
    xin_ext = torch.cat([conv_tail, x_in], 1)            # [B, S+dc-1, di]
    # causal depthwise conv: windowed dot with kernel [dc, di]
    xc = sum(xin_ext[:, i:i + s] * p["conv_w"][i][None, None]
             for i in range(dc)) + p["conv_b"]
    xc = F.silu(xc)
    new_conv_tail = xin_ext[:, s:]                       # last dc-1 inputs

    xdb = xc @ p["x_proj"]
    dt_raw = xdb[..., :dt_rank]
    b_ssm = xdb[..., dt_rank:dt_rank + d_state]
    c_ssm = xdb[..., dt_rank + d_state:]
    pre = dt_raw @ p["dt_proj"] + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))     # softplus, [B,S,di]

    a = -torch.exp(p["A_log"].float())                   # [di, ds]
    h0 = state[1].float() if state is not None else \
        torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                    device=x.device)

    if mode == "chunk" and s > 1:
        # Chunk-local alpha/u: the [B, S, d_inner, d_state] tensors only
        # ever exist a chunk at a time.
        c = min(128, s)
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of chunk {c}")
        @checkpointed
        def step(h, xc_c, dt_c, b_c, c_c):
            alpha_c = torch.exp(dt_c.float()[..., None] * a[None, None])
            u_c = (dt_c * xc_c).float()[..., None] * \
                b_c.float()[:, :, None, :]
            a1 = torch.cat([torch.ones_like(alpha_c[:, :1]), alpha_c], 1)
            x1 = torch.cat([h[:, None], u_c], 1)
            _, hh = _assoc_scan(a1, x1)
            y_c = (hh[:, 1:] * c_c.float()[:, :, None, :]).sum(-1)
            return hh[:, -1], y_c.to(x.dtype)

        h, ys = h0, []
        for i in range(0, s, c):
            h, y_c = step(h, xc[:, i:i + c], dt[:, i:i + c],
                          b_ssm[:, i:i + c], c_ssm[:, i:i + c])
            ys.append(y_c)
        h_last = h
        y = torch.cat(ys, 1).float()
    else:
        alpha = torch.exp(dt.float()[..., None] * a[None, None])
        u = (dt * xc).float()[..., None] * \
            b_ssm.float()[:, :, None, :]                          # [B,S,di,ds]
        h_all, h_last = diag_ssm_scan(alpha, u, h0, mode=mode)
        y = (h_all * c_ssm.float()[:, :, None, :]).sum(-1)
    y = y + p["D"].float()[None, None] * xc.float()
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, (new_conv_tail, h_last.float())


# ================================================================== RWKV-6
def _rwkv_mix(x, x_prev, mu):
    """Token shift interpolation; x_prev is x_{t-1} (state for decode)."""
    xs = torch.cat([x_prev[:, None], x[:, :-1]], 1)
    return shard(x + (xs - x) * mu[None, None], "batch", "seq", None)


def _wkv(r, k, v, logw, u, s0, mode, chunk):
    """The RWKV-6 recurrence of ``rwkv_time_mix`` over r/k/v/logw [B, S,
    H, dk], u [H, dk] and the entering state s0 [B, H, dk, dk] (None:
    zeros) -> (y [B, S', H, dk], the state after the last token). Each
    batch row and head runs on its own."""
    b, s, h, dk = r.shape
    if s0 is None:
        s0 = torch.zeros((b, h, dk, dk), dtype=torch.float32,
                         device=r.device)

    def chunk_step(s_in, rc, kc, vc, lwc):
        tc = rc.shape[1]                         # [B, Tc, H, dk]
        lc = torch.cumsum(lwc, dim=1)
        lprev = torch.cat([torch.zeros_like(lc[:, :1]), lc[:, :-1]], 1)
        # inter-chunk: r_t decayed against entering state
        y_inter = torch.einsum("bthd,bhde->bthe", rc * torch.exp(lprev), s_in)
        # intra-chunk pairwise (s < t), exponent lprev_t - lc_s <= 0
        pair = lprev[:, :, None] - lc[:, None]   # [B, T, S, H, dk]
        tidx = torch.arange(tc, device=rc.device)
        mask = (tidx[:, None] > tidx[None, :])[None, :, :, None, None]
        # minimum, not clamp: at pair == 0 (s = t - 1) both halve the
        # gradient, as jnp.minimum does
        e = torch.where(mask, torch.exp(torch.minimum(pair,
                                                      torch.zeros_like(pair))),
                        torch.zeros_like(pair))
        att = torch.einsum("bthd,bshd,btshd->bhts", rc, kc, e)
        y_intra = torch.einsum("bhts,bshe->bthe", att, vc)
        # current-token bonus
        y_bonus = torch.einsum("bthd,bthd,bthe->bthe",
                               rc, u[None, None] * kc, vc)
        # state update to end of chunk
        decay_out = torch.exp(lc[:, -1])                       # [B, H, dk]
        kdec = kc * torch.exp(lc[:, -1][:, None] - lc)
        s_out = decay_out[..., None] * s_in + \
            torch.einsum("bshd,bshe->bhde", kdec, vc)
        return s_out, y_inter + y_intra + y_bonus

    if mode == "step":
        rc, kc, vc = r[:, 0], k[:, 0], v[:, 0]
        y = torch.einsum("bhd,bhde->bhe", rc, s0) + \
            torch.einsum("bhd,bhd,bhe->bhe", rc, u[None] * kc, vc)
        s_new = torch.exp(logw[:, 0])[..., None] * s0 + \
            torch.einsum("bhd,bhe->bhde", kc, vc)
        y = y[:, None]                                         # [B,1,H,dv]
    else:
        tc = min(chunk, s)
        if s % tc:
            raise ValueError(f"sequence {s} is not a multiple of chunk {tc}")
        # several chunks in chunk mode: each checkpointed, as the
        # reference's scan body is
        step = checkpointed(chunk_step) if mode == "chunk" and s > tc \
            else chunk_step
        ys, s_new = [], s0
        for i in range(0, s, tc):
            s_new, y_i = step(s_new, r[:, i:i + tc], k[:, i:i + tc],
                              v[:, i:i + tc], logw[:, i:i + tc])
            ys.append(y_i)
        y = torch.cat(ys, 1)

    return y, s_new


def _wkv_on_shards(r, k, v, logw, u, s0, mode, chunk):
    """``_wkv`` of DTensors on each rank's own batch rows and heads (a
    scan has no DTensor rule; the recurrence is row- and head-local), the
    sequence whole on every rank."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    b, _, h, dk = r.shape
    bshd = sharding_for_shape(r.shape, "batch", None, "heads", None)
    state = sharding_for_shape((b, h, dk, dk), "batch", "heads", None, None)
    heads = sharding_for_shape(u.shape, "heads", None)
    # u meets every rank's own rows: its gradient is a partial sum over
    # the mesh dimensions that split them
    u_grad = tuple(Partial() if p == Shard(0) else q
                   for p, q in zip(bshd.placements, heads.placements))
    s_pl = None if s0 is None else state.placements
    fn = local_map(
        lambda *a: _wkv(*a, mode, chunk),
        out_placements=(bshd.placements, state.placements),
        in_placements=(bshd.placements,) * 4 + (heads.placements, s_pl),
        in_grad_placements=(bshd.placements,) * 4 + (u_grad, s_pl),
        redistribute_inputs=True, device_mesh=bshd.mesh)
    return fn(r, k, v, logw, u, s0)


def rwkv_time_mix(x, p, rcfg: RWKVConfig, state=None, mode: str = "chunk",
                  chunk: int = 32):
    """RWKV-6 time mixing. x [B, S, D] -> (y, new_state).

    state = (x_prev [B, D], s [B, H, dk, dv] recurrent matrix state).
    Recurrence (per head):  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
                            S_t = diag(w_t) S_{t-1} + k_t^T v_t
    with data-dependent decay w_t = exp(-exp(w0 + tanh(x_w W1) W2)).
    """
    b, s, d = x.shape
    dk = rcfg.head_dim
    h = p["w_r"].shape[1] // dk
    x_prev = state[0] if state is not None else \
        torch.zeros_like(x[:, 0])
    s0 = state[1].float() if state is not None else None

    xr = _rwkv_mix(x, x_prev, p["mu_r"])
    xk = _rwkv_mix(x, x_prev, p["mu_k"])
    xv = _rwkv_mix(x, x_prev, p["mu_v"])
    xw = _rwkv_mix(x, x_prev, p["mu_w"])
    xg = _rwkv_mix(x, x_prev, p["mu_g"])
    def heads(t):           # a projection onto the heads, [B, S, H*dk]
        return shard(t, "batch", "seq", "heads")

    r = heads(xr @ p["w_r"]).reshape(b, s, h, dk).float()
    k = heads(xk @ p["w_k"]).reshape(b, s, h, dk).float()
    v = heads(xv @ p["w_v"]).reshape(b, s, h, dk).float()
    g = heads(F.silu(xg @ p["w_g"]))
    lora = shard(torch.tanh(xw @ p["w1"]), "batch", "seq", None)
    logw = -torch.exp(p["w0"].reshape(h, dk)[None, None] +
                      heads(lora @ p["w2"]).reshape(b, s, h, dk).float())
    u = p["u"].float()                                         # [H, dk]
    if is_dtensor(r):
        y, s_new = _wkv_on_shards(r, k, v, logw, u, s0, mode, chunk)
    else:
        y, s_new = _wkv(r, k, v, logw, u, s0, mode, chunk)

    # per-head group norm, gate, output
    y32 = y.reshape(b, -1, h, dk)
    mean = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y32 = (y32 - mean) * torch.rsqrt(var + 1e-5)
    y_out = (y32.reshape(b, -1, h * dk).to(x.dtype) *
             p["ln_x"][None, None]) * g
    out = shard(y_out @ p["w_o"], "batch", "seq", None)
    return out, (x[:, -1], s_new)


def rwkv_channel_mix(x, p, state=None):
    """RWKV FFN with token shift. state = x_prev [B, D]."""
    b, s, d = x.shape
    x_prev = state if state is not None else \
        torch.zeros_like(x[:, 0])
    xk = _rwkv_mix(x, x_prev, p["mu_kc"])
    xr = _rwkv_mix(x, x_prev, p["mu_rc"])
    rr = torch.sigmoid(xr @ p["w_rc"])
    kk = shard(torch.square(torch.relu(xk @ p["w_kc"])), "batch", "seq",
               "ffn")
    return rr * shard(kk @ p["w_vc"], "batch", "seq", None), x[:, -1]
