"""Core transformer building blocks (plain functions on tensors).

Attention comes in two modes that compute the same function:

- ``dense``  — materialised float32 scores + mask, queries in chunks of
  1,024 so the score transients stay bounded. The serving path's mode.
- ``flash``  — online softmax over query and key/value chunks (plain loops).
  Peak memory stays at tile size.

GQA (n_kv_heads < n_heads), RoPE, optional qk-norm (qwen3), optional sliding
window (gemma3 local layers), and KV-cache decode (full cache or ring buffer
for windowed layers) are all supported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .sharding import is_dtensor, shard

NEG_INF = -1e30


def rms_norm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + gamma.float())).to(dt)


def rope(x, positions, theta: float = 1e4):
    """x [..., S, H, hd], positions [..., S] -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].float() * freqs                # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _causal_window_mask(sq, skv, q_off, kv_off, window, device):
    """[sq, skv] mask: kv position visible from q position (causal + window)."""
    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = kv_off + torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention_dense(q, k, v, *, causal=True, window=None, q_off=0, kv_off=0,
                    softcap=None, kv_mask=None, q_chunk: int | None = 1024):
    """q [B,Sq,H,hd], k/v [B,Skv,KVH,hd] -> [B,Sq,H,hd].

    Queries are processed in chunks of ``q_chunk`` to bound the float32
    score transients ([B, KVH, H/KVH, q_chunk, Skv]). GQA is computed with
    grouped einsums (query heads folded onto their KV head as a group
    axis), so the KV cache is never broadcast to H heads."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    k32 = k.float()
    v32 = v.float()

    def block(qb, q_off_b):
        sqb = qb.shape[1]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(),
                              k32) / math.sqrt(hd)
        if softcap:
            scores = torch.tanh(scores / softcap) * softcap
        if causal or window is not None:
            m = _causal_window_mask(sqb, k.shape[1], q_off_b, kv_off, window,
                                    q.device)[None, None, None]
            scores = scores.masked_fill(~m, NEG_INF)
        if kv_mask is not None:  # [B, Skv] validity (decode ring buffers)
            scores = scores.masked_fill(~kv_mask[:, None, None, None, :],
                                        NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, v32)
        return out.reshape(b, sqb, h, hd).to(q.dtype)

    if q_chunk is None or sq <= q_chunk:
        return block(qg, q_off)
    outs = [block(qg[:, i:i + q_chunk], q_off + i)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_flash(q, k, v, *, causal=True, window=None, q_off=0, kv_off=0,
                    softcap=None, q_chunk=512, kv_chunk=512):
    """Online-softmax tiled attention: a loop over query chunks, and inside
    it a loop over key/value chunks carrying (acc, running max, running
    sum). Key/value chunks are broadcast to H heads a tile at a time."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    qpad, kpad = (-sq) % qc, (-skv) % kc
    qp = F.pad(q, (0, 0, 0, 0, 0, qpad))
    kp = F.pad(k, (0, 0, 0, 0, 0, kpad))
    vp = F.pad(v, (0, 0, 0, 0, 0, kpad))
    nq, nk = qp.shape[1] // qc, kp.shape[1] // kc
    dev = q.device
    kv_valid = (torch.arange(nk * kc, device=dev) < skv).reshape(nk, kc)
    outs = []
    for qi in range(nq):
        qblk32 = qp[:, qi * qc:(qi + 1) * qc].float() / math.sqrt(hd)
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32, device=dev)
        m_run = torch.full((b, h, qc), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        for kj in range(nk):
            kblk = kp[:, kj * kc:(kj + 1) * kc]
            vblk = vp[:, kj * kc:(kj + 1) * kc]
            s = torch.einsum("bqhd,bkhd->bhqk", qblk32, kblk.float())
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            if causal or window is not None:
                mask = _causal_window_mask(qc, kc, q_off + qi * qc,
                                           kv_off + kj * kc, window, dev)
            else:
                mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            mask = mask & kv_valid[kj][None, :]
            s = s.masked_fill(~mask[None, None], NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            scale = torch.exp(m_run - m_new)
            l_run = l_run * scale + p.sum(-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vblk.float())
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))        # [b, qc, h, hd]
    return torch.cat(outs, dim=1)[:, :sq]


def attention(q, k, v, *, mode="dense", **kw):
    fn = attention_dense if mode == "dense" else attention_flash
    if is_dtensor(q):
        return _attention_on_shards(fn, q, k, v, **kw)
    return fn(q, k, v, **kw)


def _attention_on_shards(fn, q, k, v, *, q_off=0, kv_mask=None, **kw):
    """Attention of DTensor q [B,Sq,H,hd], k/v [B,Skv,KVH,hd] as the plain
    ``fn`` on each rank's own rows and heads: attention is head-local, and
    DTensor cannot split the head axis into (KV head, group), nor run the
    causal mask of a sequence shard. K/V (and ``kv_mask``) are
    redistributed to q's batch and head shards, whole along the sequence
    (the all-gather a sequence-sharded cache needs); a rank's query heads
    take their own KV heads' slice (GQA groups of H/KVH), and a sequence
    shard its offset in the causal mask. On a one-rank mesh the plain
    ``fn`` runs on the whole tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset as local_of
    mesh, qpl = q.device_mesh, tuple(q.placements)
    if any(not isinstance(p, (Shard, Replicate)) or
           (isinstance(p, Shard) and p.dim == 3) for p in qpl):
        raise NotImplementedError(f"attention on query placements {qpl}")

    def like_q(t, head_ok):
        want = tuple(p if p == Shard(0) or (p == Shard(2) and head_ok)
                     else Replicate() for p in qpl)
        return t.redistribute(mesh, want)

    kv_heads_sharded = all(kp == Shard(2) for p, kp in
                           zip(qpl, k.placements) if p == Shard(2))
    k = like_q(k, kv_heads_sharded)
    v = like_q(v, kv_heads_sharded)
    _, q_at = local_of(q.shape, mesh, qpl)
    _, k_at = local_of(k.shape, mesh, k.placements)
    # a rank's queries reach only part of whole K/V: its K/V gradient is a
    # partial sum over the mesh dimensions that split the queries
    kv_grad = tuple(Partial() if isinstance(p, Shard) and kp == Replicate()
                    else kp for p, kp in zip(qpl, k.placements))
    ql = q.to_local()
    kl = k.to_local(grad_placements=kv_grad)
    vl = v.to_local(grad_placements=kv_grad)
    g = q.shape[2] // k.shape[2]
    h0, h1 = q_at[2], q_at[2] + ql.shape[2]
    a, b = h0 // g - k_at[2], (h1 - 1) // g + 1 - k_at[2]
    if ql.shape[2] % (b - a):
        raise NotImplementedError(f"query heads [{h0}, {h1}) split a GQA "
                                  f"group of {g}")
    if kv_mask is not None:
        if is_dtensor(kv_mask):
            kv_mask = like_q(kv_mask, False).to_local()
        else:
            kv_mask = kv_mask[q_at[0]:q_at[0] + ql.shape[0]]
    out = fn(ql, kl[:, :, a:b], vl[:, :, a:b], q_off=q_off + q_at[1],
             **({"kv_mask": kv_mask} if kv_mask is not None else {}), **kw)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


# --------------------------------------------------------------------- MLPs
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    h = shard(h, "batch", "seq", "ffn")
    return h @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu((x @ w_up) + b_up, approximate="tanh")
    h = shard(h, "batch", "seq", "ffn")
    return (h @ w_down) + b_down


# ----------------------------------------------------------------- softmax x-ent
def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims (``aten.mm`` /
    ``aten.addmm``, not ``aten.bmm``) and recompute the rest: the rule of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def checkpointed(fn, mode: str | None = "full"):
    """``fn`` under one of the reference's remat modes: None runs it as it
    is; ``"full"`` recomputes it in backward instead of keeping its
    intermediates (``jax.checkpoint``); ``"dots"`` keeps only the outputs
    of its matmuls without batch dims. Under ``no_grad`` every mode is a
    plain call."""
    if mode is None:
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        from torch.utils.checkpoint import checkpoint
        if mode == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return run


def _label_logit(logits, labels):
    """[..., V] logits at [...] labels, as [..., 1]. The trailing 1 stays
    until the value meets ``lse``: on vocab-sharded DTensor logits the
    gather's result is a masked partial sum, and DTensor reduces it only
    with the mask's own shape."""
    return torch.gather(logits, -1, labels[..., None].long())


def cross_entropy_loss(logits, labels, z_loss: float = 1e-4):
    """Mean token cross entropy (+ z-loss for stability at big vocab)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = _label_logit(logits, labels)
    loss = (lse[..., None] - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss


def chunked_cross_entropy(x, head, labels, *, chunk: int = 256,
                          softcap=None, z_loss: float = 1e-4):
    """Loss without materialising [B, S, V] logits: a loop over sequence
    chunks, computing (and discarding) one logits chunk at a time, with the
    chunk recomputed in backward. S is padded to a multiple of the chunk
    and the pad masked; the sum is divided by B * S."""
    b, s, d = x.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    n = x.shape[1] // c
    valid = (torch.arange(n * c, device=x.device) < s).reshape(n, c)

    def chunk_loss(xc, lc, vc):
        logits = shard(xc @ head.to(xc.dtype), "batch", "seq",
                       "vocab").float()
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        lse = torch.logsumexp(logits, dim=-1)[..., None]
        ll = _label_logit(logits, lc)
        per_tok = (lse - ll) + z_loss * lse ** 2
        return (per_tok * vc[None, :, None]).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpointed(chunk_loss)(x[:, sl], labels[:, sl],
                                                 valid[i])
    return total / (b * s)
