"""Decoder-only LM family: dense / GQA / sliding-window / MoE / hybrid
(Mamba) / RWKV architectures from one periodic layer-pattern description.

A config declares a *period* — a tuple of layer descriptors (mixer + MLP
kind) — repeated ``n_periods`` times (parameters stacked over periods, the
leaves ``[n_periods, ...]``; ``forward`` takes the stack apart once and
loops over its periods) plus an optional explicit *head*
and *tail* (e.g. gemma3's 62 = 10*6 + 2 local layers).

Four phases share the same parameters:
  train    — full-sequence causal forward, no cache, returns logits
  hidden   — train's forward up to the final norm (for a chunked loss)
  prefill  — forward + KV/SSM cache construction
  decode   — single-token step against the cache

Execution modes (attn_mode dense/flash, ssm_mode assoc/chunk) select the
attention and scan algorithms; each pair computes the same function.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .layers import (attention, checkpointed, chunked_cross_entropy,
                     cross_entropy_loss, gelu_mlp, rms_norm, rope, swiglu)
from .moe import MoEConfig, moe_layer
from .schema import ParamSpec, tree_map, unstack
from .sharding import gather_dp, shard
from .ssm import (MambaConfig, RWKVConfig, mamba_forward, rwkv_channel_mix,
                  rwkv_time_mix)

def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


@dataclass(frozen=True)
class LayerDesc:
    mixer: str = "attn"            # attn | mamba | rwkv
    mlp: str = "swiglu"            # swiglu | gelu | moe | rwkv_cm
    window: int | None = None      # sliding-window (local) attention
    rope_theta: float = 1e4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 128
    d_ff: int = 0
    period: tuple = (LayerDesc(),)
    head: tuple = ()               # explicit layers BEFORE the scanned periods
    tail: tuple = ()               # explicit layers AFTER the scanned periods
    qk_norm: bool = False
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    tie_embeddings: bool = True
    normalize_embed: bool = False
    final_softcap: float | None = None
    norm_eps: float = 1e-6
    frontend: str | None = None    # vision | audio (stub: precomputed embeds)
    frontend_dim: int = 0
    frontend_len: int = 0
    encoder_layers: int = 0        # >0 -> enc-dec wrapper (encdec.py)
    dtype: str = "bfloat16"
    subquadratic: bool = False     # may run long_500k decode

    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.head) - len(self.tail)) // len(self.period)

    @property
    def all_descs(self):
        return (list(self.head) + list(self.period) * self.n_periods +
                list(self.tail))


# ============================================================== schemas
def _attn_schema(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sx = tuple(None for _ in stack)
    s = {
        "ln1": ParamSpec(stack + (d,), sx + (None,), "zeros"),
        "wq": ParamSpec(stack + (d, h * hd), sx + ("embed", "heads")),
        "wk": ParamSpec(stack + (d, kvh * hd), sx + ("embed", "kv_heads")),
        "wv": ParamSpec(stack + (d, kvh * hd), sx + ("embed", "kv_heads")),
        "wo": ParamSpec(stack + (h * hd, d), sx + ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec(stack + (hd,), sx + (None,), "zeros")
        s["k_norm"] = ParamSpec(stack + (hd,), sx + (None,), "zeros")
    return s


def _mamba_schema(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d = cfg.d_model
    m = cfg.mamba
    di = m.expand * d
    dtr = m.dt_rank or -(-d // 16)
    sx = tuple(None for _ in stack)
    return {
        "ln1": ParamSpec(stack + (d,), sx + (None,), "zeros"),
        "in_proj": ParamSpec(stack + (d, 2 * di), sx + ("embed", "ffn")),
        "conv_w": ParamSpec(stack + (m.d_conv, di), sx + (None, "ffn")),
        "conv_b": ParamSpec(stack + (di,), sx + ("ffn",), "zeros"),
        "x_proj": ParamSpec(stack + (di, dtr + 2 * m.d_state), sx + ("ffn", None)),
        "dt_proj": ParamSpec(stack + (dtr, di), sx + (None, "ffn")),
        "dt_bias": ParamSpec(stack + (di,), sx + ("ffn",), "zeros"),
        "A_log": ParamSpec(stack + (di, m.d_state), sx + ("ffn", None), "a_log"),
        "D": ParamSpec(stack + (di,), sx + ("ffn",), "ones"),
        "out_proj": ParamSpec(stack + (di, d), sx + ("ffn", "embed")),
    }


def _rwkv_schema(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d = cfg.d_model
    dk = cfg.rwkv.head_dim
    h = d // dk
    lora = cfg.rwkv.decay_lora
    sx = tuple(None for _ in stack)
    mu = lambda: ParamSpec(stack + (d,), sx + (None,), "zeros")
    return {
        "ln1": ParamSpec(stack + (d,), sx + (None,), "zeros"),
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
        "w_r": ParamSpec(stack + (d, h * dk), sx + ("embed", "heads")),
        "w_k": ParamSpec(stack + (d, h * dk), sx + ("embed", "heads")),
        "w_v": ParamSpec(stack + (d, h * dk), sx + ("embed", "heads")),
        "w_g": ParamSpec(stack + (d, h * dk), sx + ("embed", "heads")),
        "w_o": ParamSpec(stack + (h * dk, d), sx + ("heads", "embed")),
        "w0": ParamSpec(stack + (h * dk,), sx + ("heads",), "zeros"),
        "w1": ParamSpec(stack + (d, lora), sx + ("embed", None)),
        "w2": ParamSpec(stack + (lora, h * dk), sx + (None, "heads")),
        "u": ParamSpec(stack + (h, dk), sx + ("heads", None), "zeros"),
        "ln_x": ParamSpec(stack + (h * dk,), sx + ("heads",), "ones"),
    }


def _mlp_schema(cfg: ModelConfig, kind: str, stack: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sx = tuple(None for _ in stack)
    ln = {"ln2": ParamSpec(stack + (d,), sx + (None,), "zeros")}
    if kind == "swiglu":
        return ln | {
            "w_gate": ParamSpec(stack + (d, f), sx + ("embed", "ffn")),
            "w_up": ParamSpec(stack + (d, f), sx + ("embed", "ffn")),
            "w_down": ParamSpec(stack + (f, d), sx + ("ffn", "embed")),
        }
    if kind == "gelu":
        return ln | {
            "w_up": ParamSpec(stack + (d, f), sx + ("embed", "ffn")),
            "b_up": ParamSpec(stack + (f,), sx + ("ffn",), "zeros"),
            "w_down": ParamSpec(stack + (f, d), sx + ("ffn", "embed")),
            "b_down": ParamSpec(stack + (d,), sx + (None,), "zeros"),
        }
    if kind == "moe":
        m = cfg.moe
        e, fe = m.n_experts, m.d_expert
        s = ln | {
            "router": ParamSpec(stack + (d, e), sx + ("embed", None)),
            "w_gate": ParamSpec(stack + (e, d, fe),
                                sx + ("expert", "expert_embed", None)),
            "w_up": ParamSpec(stack + (e, d, fe),
                              sx + ("expert", "expert_embed", None)),
            "w_down": ParamSpec(stack + (e, fe, d),
                                sx + ("expert", None, "expert_embed")),
        }
        if m.n_shared:
            fs = m.n_shared * fe
            s |= {
                "shared_w_gate": ParamSpec(stack + (d, fs), sx + ("embed", "ffn")),
                "shared_w_up": ParamSpec(stack + (d, fs), sx + ("embed", "ffn")),
                "shared_w_down": ParamSpec(stack + (fs, d), sx + ("ffn", "embed")),
            }
        return s
    if kind == "rwkv_cm":
        return ln | {
            "mu_kc": ParamSpec(stack + (d,), sx + (None,), "zeros"),
            "mu_rc": ParamSpec(stack + (d,), sx + (None,), "zeros"),
            "w_rc": ParamSpec(stack + (d, d), sx + ("embed", None)),
            "w_kc": ParamSpec(stack + (d, f), sx + ("embed", "ffn")),
            "w_vc": ParamSpec(stack + (f, d), sx + ("ffn", "embed")),
        }
    raise ValueError(kind)


def _layer_schema(cfg: ModelConfig, desc: LayerDesc, stack: tuple = ()) -> dict:
    mixer = {"attn": _attn_schema, "mamba": _mamba_schema,
             "rwkv": _rwkv_schema}[desc.mixer](cfg, stack)
    return {"mixer": mixer, "mlp": _mlp_schema(cfg, desc.mlp, stack)}


def build_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    np_ = cfg.n_periods
    s = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamSpec((d,), (None,), "zeros"),
        "period": {str(j): _layer_schema(cfg, desc, stack=(np_,))
                   for j, desc in enumerate(cfg.period)},
    }
    if cfg.head:
        s["head"] = {str(j): _layer_schema(cfg, desc)
                     for j, desc in enumerate(cfg.head)}
    if cfg.tail:
        s["tail"] = {str(j): _layer_schema(cfg, desc)
                     for j, desc in enumerate(cfg.tail)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((d, cfg.vocab), ("embed", "vocab"))
    if cfg.frontend:
        s["frontend_proj"] = ParamSpec((cfg.frontend_dim, d), (None, "embed"))
    return s




# ============================================================== caches
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_layer_cache(cfg: ModelConfig, desc: LayerDesc, batch: int,
                         s_cache: int, stack: tuple = ()):
    """One layer's cache as ``meta`` tensors (the reference's
    ``ShapeDtypeStruct``s)."""
    dt = torch_dtype(cfg.dtype)
    if desc.mixer == "attn":
        sc = min(desc.window, s_cache) if desc.window else s_cache
        shp = stack + (batch, sc, cfg.n_kv_heads, cfg.head_dim)
        return {"k": _meta(shp, dt), "v": _meta(shp, dt)}
    if desc.mixer == "mamba":
        m = cfg.mamba
        di = m.expand * cfg.d_model
        return {"conv": _meta(stack + (batch, m.d_conv - 1, di), dt),
                "h": _meta(stack + (batch, di, m.d_state), torch.float32)}
    if desc.mixer == "rwkv":
        dk = cfg.rwkv.head_dim
        h = cfg.d_model // dk
        c = {"x_prev": _meta(stack + (batch, cfg.d_model), dt),
             "s": _meta(stack + (batch, h, dk, dk), torch.float32)}
        if desc.mlp == "rwkv_cm":
            c["x_prev_cm"] = _meta(stack + (batch, cfg.d_model), dt)
        return c
    raise ValueError(desc.mixer)


def abstract_cache(cfg: ModelConfig, batch: int, s_cache: int):
    np_ = cfg.n_periods
    cache = {"period": {str(j): abstract_layer_cache(cfg, d, batch, s_cache,
                                                     stack=(np_,))
                        for j, d in enumerate(cfg.period)}}
    if cfg.head:
        cache["head"] = {str(j): abstract_layer_cache(cfg, d, batch, s_cache)
                         for j, d in enumerate(cfg.head)}
    if cfg.tail:
        cache["tail"] = {str(j): abstract_layer_cache(cfg, d, batch, s_cache)
                         for j, d in enumerate(cfg.tail)}
    return cache


# ============================================================== forward
def _apply_attn(p, x, cfg: ModelConfig, desc: LayerDesc, positions, phase,
                cache, attn_mode):
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hx = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (hx @ p["wq"]).reshape(b, s, h, hd)
    k = (hx @ p["wk"]).reshape(b, s, kvh, hd)
    v = (hx @ p["wv"]).reshape(b, s, kvh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, desc.rope_theta)
    k = rope(k, positions, desc.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)

    if phase == "train":
        o = attention(q, k, v, mode=attn_mode, causal=True, window=desc.window)
        new_cache = None
    elif phase == "prefill":
        sc = min(desc.window, s) if desc.window else s
        o = attention(q, k, v, mode=attn_mode, causal=True, window=desc.window)
        # Ring-buffer invariant: token j lives at slot j % sc.
        dt = torch_dtype(cfg.dtype)
        kc, vc = k[:, -sc:], v[:, -sc:]
        if s % sc:
            kc = torch.roll(kc, shifts=s % sc, dims=1)
            vc = torch.roll(vc, shifts=s % sc, dims=1)
        new_cache = {"k": kc.to(dt).contiguous(), "v": vc.to(dt).contiguous()}
    else:  # decode: s == 1, write at pos (ring for windowed layers)
        pos = positions[:, 0]
        sc = cache["k"].shape[1]
        slot = pos % sc
        rows = torch.arange(b, device=x.device)
        kc = cache["k"].index_put((rows, slot), k[:, 0].to(cache["k"].dtype))
        vc = cache["v"].index_put((rows, slot), v[:, 0].to(cache["v"].dtype))
        n_valid = torch.clamp(pos + 1, max=sc)
        kv_mask = torch.arange(sc, device=x.device)[None, :] < n_valid[:, None]
        o = attention(q, kc, vc, mode="dense", causal=False, kv_mask=kv_mask)
        new_cache = {"k": kc, "v": vc}
    o = o.reshape(b, s, h * hd)
    return x + o @ p["wo"], new_cache


def _apply_mixer(p, x, cfg, desc, positions, phase, cache, attn_mode, ssm_mode):
    if desc.mixer == "attn":
        return _apply_attn(p, x, cfg, desc, positions, phase, cache, attn_mode)
    dt = torch_dtype(cfg.dtype)
    if desc.mixer == "mamba":
        hx = rms_norm(x, p["ln1"], cfg.norm_eps)
        st = (cache["conv"], cache["h"]) if cache is not None else None
        mode = "step" if phase == "decode" else ssm_mode
        y, (conv, hstate) = mamba_forward(hx, p, cfg.mamba, state=st, mode=mode)
        new_cache = None if phase == "train" else \
            {"conv": conv.to(dt), "h": hstate}
        return x + y, new_cache
    if desc.mixer == "rwkv":
        hx = rms_norm(x, p["ln1"], cfg.norm_eps)
        st = (cache["x_prev"], cache["s"]) if cache is not None else None
        mode = "step" if phase == "decode" else ssm_mode
        y, (x_prev, s_state) = rwkv_time_mix(hx, p, cfg.rwkv, state=st,
                                             mode=mode)
        new_cache = None if phase == "train" else \
            {"x_prev": x_prev.to(dt), "s": s_state}
        return x + y, new_cache
    raise ValueError(desc.mixer)


def _apply_mlp(p, x, cfg, desc, phase, cache):
    hx = rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    extra = {}
    if desc.mlp == "swiglu":
        y = swiglu(hx, p["w_gate"], p["w_up"], p["w_down"])
    elif desc.mlp == "gelu":
        y = gelu_mlp(hx, p["w_up"], p["b_up"], p["w_down"], p["b_down"])
    elif desc.mlp == "moe":
        y, aux = moe_layer(hx, p, cfg.moe, phase=phase)
    elif desc.mlp == "rwkv_cm":
        st = cache.get("x_prev_cm") if cache is not None else None
        y, x_prev = rwkv_channel_mix(hx, p, state=st)
        if phase != "train":
            extra = {"x_prev_cm": x_prev.to(torch_dtype(cfg.dtype))}
    else:
        raise ValueError(desc.mlp)
    return x + y, aux, extra


def _apply_layer(desc, p, x, cfg, positions, phase, cache, attn_mode,
                 ssm_mode):
    phase = "train" if phase == "hidden" else phase
    x, mixer_cache = _apply_mixer(p["mixer"], x, cfg, desc, positions, phase,
                                  cache, attn_mode, ssm_mode)
    x = shard(x, "batch", "seq", None)
    x, aux, extra = _apply_mlp(p["mlp"], x, cfg, desc, phase, cache)
    x = shard(x, "batch", "seq", None)
    new_cache = None if phase == "train" else {**(mixer_cache or {}), **extra}
    return x, aux, new_cache


def forward(params, cfg: ModelConfig, tokens, *, phase="train", cache=None,
            pos=None, frontend_embeds=None, attn_mode="flash",
            ssm_mode="chunk", remat=None, remat_group: int = 1):
    """tokens [B, S] -> (logits [B, S', V], new_cache, aux_loss); phase
    ``hidden`` -> (final hidden [B, S', D], head [D, V], aux_loss), for a
    loss that computes the logits in chunks itself.

    pos: [B] current lengths for decode (defaults to zeros for train/prefill).
    The period loop takes the stacked params and cache apart once
    (``unstack``) and restacks the new caches, so caches keep
    ``abstract_cache``'s shapes. ``remat`` (None | "full" | "dots")
    checkpoints each layer; ``remat_group`` g > 1 also checkpoints each
    run of g periods (train and hidden phases, when g divides
    ``n_periods``), so backward keeps n_periods / g activations between
    groups.
    """
    if phase not in ("train", "prefill", "decode", "hidden"):
        raise ValueError(f"unknown phase {phase!r}")
    b, s = tokens.shape
    dt = torch_dtype(cfg.dtype)
    params = {k: v if k in ("head", "period", "tail") else gather_dp(v)
              for k, v in params.items()}
    # F.embedding, not indexing: DTensor has a rule for the embedding's
    # backward on a vocab-sharded table, and its index_put one fails there
    x = shard(F.embedding(tokens, params["embed"]).to(dt), "batch", "seq",
              None)
    if cfg.normalize_embed:
        x = x * math.sqrt(cfg.d_model)
    if cfg.frontend and frontend_embeds is not None:
        fe = frontend_embeds.to(dt) @ params["frontend_proj"].to(dt)
        x = torch.cat([fe, x], dim=1)
        s = x.shape[1]
    ar = torch.arange(s, device=x.device)
    positions = ar[None].expand(b, s) if pos is None else \
        pos[:, None] + ar[None]
    x = shard(x, "batch", "seq", None)

    def make_layer(desc):
        def f(p, xx, cj):
            return _apply_layer(desc, gather_dp(p), xx, cfg, positions,
                                phase, cj, attn_mode, ssm_mode)
        return checkpointed(f, remat)

    layer_fns = {d: make_layer(d)
                 for d in {*cfg.head, *cfg.period, *cfg.tail}}

    def run(descs, layer_params, layer_cache, xx, aux):
        new = {}
        for j, desc in enumerate(descs):
            cj = layer_cache[str(j)] if layer_cache is not None else None
            xx, a, nc = layer_fns[desc](layer_params[str(j)], xx, cj)
            aux = aux + a
            if nc is not None:
                new[str(j)] = nc
        return xx, aux, new

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux_total, head_cache = run(
        cfg.head, params.get("head"),
        cache.get("head") if cache is not None else None, x, aux_total)
    np_ = cfg.n_periods
    per_params = unstack(params["period"])
    per_cache_in = unstack(cache["period"]) if cache is not None \
        else [None] * np_
    g = remat_group if (remat_group and phase in ("train", "hidden")
                        and np_ % remat_group == 0) else 1
    per_caches = []
    if g > 1:
        def group(xx, aux, *ps):
            for pp in ps:
                xx, aux, _ = run(cfg.period, pp, None, xx, aux)
            return xx, aux
        for i in range(0, np_, g):
            x, aux_total = checkpointed(group)(x, aux_total,
                                               *per_params[i:i + g])
    else:
        for pp, pc in zip(per_params, per_cache_in):
            x, aux_total, nc = run(cfg.period, pp, pc, x, aux_total)
            per_caches.append(nc)
    x, aux_total, tail_cache = run(
        cfg.tail, params.get("tail"),
        cache.get("tail") if cache is not None else None, x, aux_total)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if phase == "hidden":       # the loss computes the logits chunked
        return x, head, aux_total
    if phase == "prefill":      # serving needs only the last position
        x = x[:, -1:]
    logits = x @ head.to(x.dtype)
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    logits = shard(logits, "batch", "seq", "vocab")

    new_cache = None
    if phase != "train":
        new_cache = {"period": tree_map(lambda *ts: torch.stack(ts),
                                        *per_caches)}
        if cfg.head:
            new_cache["head"] = head_cache
        if cfg.tail:
            new_cache["tail"] = tail_cache
    return logits, new_cache, aux_total


def loss_fn(params, cfg: ModelConfig, tokens, labels, *, frontend_embeds=None,
            attn_mode="flash", ssm_mode="chunk", remat=None, aux_weight=0.01,
            loss_chunk: int | None = None, remat_group: int = 1):
    """Mean next-token cross entropy (+ z-loss) + ``aux_weight`` x the MoE
    load-balance loss; the frontend's positions carry no label."""
    kw = dict(frontend_embeds=frontend_embeds, attn_mode=attn_mode,
              ssm_mode=ssm_mode, remat=remat, remat_group=remat_group)
    n_front = frontend_embeds.shape[1] \
        if cfg.frontend and frontend_embeds is not None else 0
    if loss_chunk:
        x, head, aux = forward(params, cfg, tokens, phase="hidden", **kw)
        loss = chunked_cross_entropy(x[:, n_front:], head, labels,
                                     chunk=loss_chunk,
                                     softcap=cfg.final_softcap)
        return loss + aux_weight * aux
    logits, _, aux = forward(params, cfg, tokens, phase="train", **kw)
    return cross_entropy_loss(logits[:, n_front:], labels) + aux_weight * aux
