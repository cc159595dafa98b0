"""Encoder–decoder transformer (seamless-m4t backbone).

The audio frontend is a stub: inputs are precomputed frame embeddings
[B, S_enc, frontend_dim]. The backbone is fully implemented: bidirectional
encoder, causal decoder with cross-attention, teacher-forced training
(``encdec_loss``), and a serve path (encode once -> cached cross-K/V ->
decode steps). Layers are stacked ``[n_layers, ...]`` leaves, which the
loops take apart once (``unstack``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import (attention, checkpointed, chunked_cross_entropy,
                     cross_entropy_loss, rms_norm, rope)
from .schema import ParamSpec, unstack
from .sharding import gather_dp, shard
from .transformer import (LayerDesc, ModelConfig, _apply_mlp, _attn_schema,
                          _meta, _mlp_schema, torch_dtype)

GELU = LayerDesc(mlp="gelu")


def _xattn_schema(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sx = tuple(None for _ in stack)
    return {
        "ln_x": ParamSpec(stack + (d,), sx + (None,), "zeros"),
        "xwq": ParamSpec(stack + (d, h * hd), sx + ("embed", "heads")),
        "xwk": ParamSpec(stack + (d, kvh * hd), sx + ("embed", "kv_heads")),
        "xwv": ParamSpec(stack + (d, kvh * hd), sx + ("embed", "kv_heads")),
        "xwo": ParamSpec(stack + (h * hd, d), sx + ("heads", "embed")),
    }


def build_encdec_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    ne, nd = cfg.encoder_layers, cfg.n_layers
    enc_block = {"mixer": _attn_schema(cfg, (ne,)),
                 "mlp": _mlp_schema(cfg, "gelu", (ne,))}
    dec_block = {"mixer": _attn_schema(cfg, (nd,)),
                 "cross": _xattn_schema(cfg, (nd,)),
                 "mlp": _mlp_schema(cfg, "gelu", (nd,))}
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "frontend_proj": ParamSpec((cfg.frontend_dim, d), (None, "embed")),
        "encoder": enc_block,
        "decoder": dec_block,
        "enc_norm": ParamSpec((d,), (None,), "zeros"),
        "final_norm": ParamSpec((d,), (None,), "zeros"),
    }


def _self_attn(p, x, cfg, positions, causal, attn_mode, cache=None, pos=None):
    """-> (x + attention, {"k", "v"}): without a cache, the sequence's own
    (roped) K/V, which a prefill keeps; with one, the cache with this step's
    K/V written at slot ``pos % sc``."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hx = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = shard(rope((hx @ p["wq"]).reshape(b, s, h, hd), positions),
              "batch", "seq", "heads", None)
    k = shard(rope((hx @ p["wk"]).reshape(b, s, kvh, hd), positions),
              "batch", "seq", "kv_heads", None)
    v = (hx @ p["wv"]).reshape(b, s, kvh, hd)
    if cache is None:
        o = attention(q, k, v, mode=attn_mode, causal=causal)
        new_cache = {"k": k, "v": v}
    else:
        sc = cache["k"].shape[1]
        slot = pos % sc
        rows = torch.arange(b, device=x.device)
        kc = cache["k"].index_put((rows, slot), k[:, 0].to(cache["k"].dtype))
        vc = cache["v"].index_put((rows, slot), v[:, 0].to(cache["v"].dtype))
        kv_mask = torch.arange(sc, device=x.device)[None] < \
            torch.clamp(pos + 1, max=sc)[:, None]
        o = attention(q, kc, vc, mode="dense", causal=False, kv_mask=kv_mask)
        new_cache = {"k": kc, "v": vc}
    return shard(x + o.reshape(b, s, h * hd) @ p["wo"], "batch", "seq",
                 None), new_cache


def _cross_attn(p, x, memory_kv, cfg, attn_mode):
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
    q = shard((hx @ p["xwq"]).reshape(b, s, h, hd), "batch", "seq",
              "heads", None)
    k, v = memory_kv
    o = attention(q, k, v, mode=attn_mode, causal=False)
    return shard(x + o.reshape(b, s, h * hd) @ p["xwo"], "batch", "seq",
                 None)


def _gathered(params) -> dict:
    """The params outside the layer stacks gathered over the data axes
    (``gather_dp``; each layer gathers its own)."""
    return {k: v if k in ("encoder", "decoder") else gather_dp(v)
            for k, v in params.items()}


def _embed(params, tokens, dt):
    return shard(F.embedding(tokens, params["embed"]).to(dt), "batch",
                 "seq", None)


def encode(params, cfg: ModelConfig, frames, attn_mode="flash", remat=None):
    dt = torch_dtype(cfg.dtype)
    params = _gathered(params)
    x = frames.to(dt) @ params["frontend_proj"].to(dt)
    x = shard(x, "batch", "seq", None)
    b, se, _ = x.shape
    positions = torch.arange(se, device=x.device)[None].expand(b, se)

    def body(xx, blk):
        blk = gather_dp(blk)
        xx, _ = _self_attn(blk["mixer"], xx, cfg, positions, causal=False,
                           attn_mode=attn_mode)
        xx, _, _ = _apply_mlp(blk["mlp"], xx, cfg, GELU, "train", None)
        return shard(xx, "batch", "seq", None)

    body = checkpointed(body, "full" if remat else None)
    for blk in unstack(params["encoder"]):
        x = body(x, blk)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _memory_kv(cross, memory, cfg):
    b, se, _ = memory.shape
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k = (memory @ cross["xwk"]).reshape(b, se, kvh, hd)
    v = (memory @ cross["xwv"]).reshape(b, se, kvh, hd)
    return k, v


def decode_train(params, cfg: ModelConfig, memory, tokens, attn_mode="flash",
                 return_cache=False, remat=None, return_hidden=False):
    """Teacher-forced decoder over ``tokens`` -> logits [B, S, V] (the final
    hidden [B, S, D] with ``return_hidden``); with ``return_cache``, also
    the serve cache of the sequence: the decoder's self-K/V (token j at
    slot j) and the cross-K/V of ``memory``, each stacked over layers as
    ``abstract_encdec_cache`` lays them out. ``remat`` (any mode)
    checkpoints each layer, as the reference's ``jax.checkpoint`` does."""
    dt = torch_dtype(cfg.dtype)
    params = _gathered(params)
    x = _embed(params, tokens, dt)
    b, st = tokens.shape
    positions = torch.arange(st, device=x.device)[None].expand(b, st)

    def body(xx, blk):
        blk = gather_dp(blk)
        xx, kv = _self_attn(blk["mixer"], xx, cfg, positions, causal=True,
                            attn_mode=attn_mode)
        mkv = _memory_kv(blk["cross"], memory, cfg)
        xx = _cross_attn(blk["cross"], xx, mkv, cfg, attn_mode)
        xx, _, _ = _apply_mlp(blk["mlp"], xx, cfg, GELU, "train", None)
        xx = shard(xx, "batch", "seq", None)
        return (xx, kv["k"], kv["v"], *mkv) if return_cache else xx

    body = checkpointed(body, "full" if remat else None)
    kvs = []
    for blk in unstack(params["decoder"]):
        if return_cache:
            x, *kv = body(x, blk)
            kvs.append(kv)
        else:
            x = body(x, blk)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    logits = x @ params["embed"].T.to(x.dtype)
    if not return_cache:
        return logits
    ks, vs, xks, xvs = (torch.stack(t).to(dt) for t in zip(*kvs))
    return logits, {"k": ks, "v": vs, "xk": xks, "xv": xvs}


def encdec_loss(params, cfg: ModelConfig, frames, tokens_in, labels,
                attn_mode="flash", loss_chunk=None, remat=None):
    memory = encode(params, cfg, frames, attn_mode, remat=remat)
    if loss_chunk:
        x = decode_train(params, cfg, memory, tokens_in, attn_mode,
                         remat=remat, return_hidden=True)
        return chunked_cross_entropy(x, params["embed"].T, labels,
                                     chunk=loss_chunk)
    logits = decode_train(params, cfg, memory, tokens_in, attn_mode,
                          remat=remat)
    return cross_entropy_loss(logits, labels)


# ------------------------------------------------------------- serving
def abstract_encdec_cache(cfg: ModelConfig, batch: int, s_cache: int,
                          s_enc: int):
    dt = torch_dtype(cfg.dtype)
    nd = cfg.n_layers
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": _meta((nd, batch, s_cache, kvh, hd), dt),
            "v": _meta((nd, batch, s_cache, kvh, hd), dt),
            "xk": _meta((nd, batch, s_enc, kvh, hd), dt),
            "xv": _meta((nd, batch, s_enc, kvh, hd), dt)}


def decode_step(params, cfg: ModelConfig, cache, token, pos, attn_mode="dense"):
    """One serve-time decoder step against self- and cross-K/V caches."""
    dt = torch_dtype(cfg.dtype)
    params = _gathered(params)
    x = _embed(params, token, dt)               # [B, 1, D]
    positions = pos[:, None]
    ks, vs = [], []
    for i, blk in enumerate(unstack(params["decoder"])):
        blk = gather_dp(blk)
        x, nc = _self_attn(blk["mixer"], x, cfg, positions, causal=True,
                           attn_mode="dense",
                           cache={"k": cache["k"][i], "v": cache["v"][i]},
                           pos=pos)
        x = _cross_attn(blk["cross"], x, (cache["xk"][i], cache["xv"][i]),
                        cfg, attn_mode)
        x, _, _ = _apply_mlp(blk["mlp"], x, cfg, GELU, "decode", None)
        x = shard(x, "batch", "seq", None)
        ks.append(nc["k"])
        vs.append(nc["v"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["embed"].T.to(x.dtype)
    new_cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "xk": cache["xk"], "xv": cache["xv"]}
    return logits, new_cache
