"""Architecture registry: ``--arch <id>`` resolution, reduced smoke configs
and the training presets."""
from __future__ import annotations

import dataclasses

from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import MambaConfig, RWKVConfig
from repro_torch.models.transformer import ModelConfig

from . import (dbrx_132b, deepseek_moe_16b, gemma3_27b, internlm2_1_8b,
               jamba_v0_1_52b, pixtral_12b, qwen3_32b, rwkv6_1_6b,
               seamless_m4t_medium, starcoder2_15b)

ARCHS: dict[str, ModelConfig] = {
    "gemma3-27b": gemma3_27b.CONFIG,
    "qwen3-32b": qwen3_32b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "internlm2-1.8b": internlm2_1_8b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "pixtral-12b": pixtral_12b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "deepseek-moe-16b": deepseek_moe_16b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def reduce_config(cfg: ModelConfig, d_model: int = 64) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths, few
    layers (one period), tiny vocab/experts — structure preserved."""
    head_dim = 16
    n_heads = max(2, cfg.n_heads // 8) if cfg.n_heads else 0
    n_kv = max(1, cfg.n_kv_heads // 8) if cfg.n_kv_heads else 0
    if cfg.n_kv_heads == cfg.n_heads:   # keep MHA archs MHA
        n_kv = n_heads
    moe = None
    if cfg.moe:
        moe = MoEConfig(n_experts=min(cfg.moe.n_experts, 4),
                        top_k=min(cfg.moe.top_k, 2),
                        d_expert=32, n_shared=min(cfg.moe.n_shared, 1),
                        every=cfg.moe.every)
    mamba = MambaConfig(d_state=4, d_conv=4, expand=2) if cfg.mamba else None
    rwkv = RWKVConfig(head_dim=16, decay_lora=8) if cfg.rwkv else None
    n_layers = len(cfg.head) + len(cfg.period) + len(cfg.tail)
    period = tuple(dataclasses.replace(d, window=min(d.window, 8))
                   if d.window else d for d in cfg.period)
    tail = tuple(dataclasses.replace(d, window=min(d.window, 8))
                 if d.window else d for d in cfg.tail)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke",
        d_model=d_model, n_layers=n_layers, vocab=512,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=head_dim,
        d_ff=128, period=period, tail=tail, moe=moe, mamba=mamba, rwkv=rwkv,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_dim=32 if cfg.frontend else 0,
        frontend_len=4 if cfg.frontend else 0,
        dtype="float32",
    )


def preset_config(arch: str, preset: str) -> ModelConfig:
    """The training presets of ``launch/train.py`` (the reference's
    ``examples/train_lm.py::preset_config``): ``full`` is the arch's own
    config, ``smoke`` its ``reduce_config``, ``100m`` a ~100M-param scale
    of the same family (d 512, ~8 layers of periods, vocab 16,384)."""
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return reduce_config(cfg)
    if preset != "100m":
        raise ValueError(f"unknown preset {preset!r}")
    base = reduce_config(cfg, d_model=512)
    n_rep = max(1, 8 // max(1, len(base.period)))
    return dataclasses.replace(
        base, name=f"{arch}-100m", vocab=16_384, d_ff=2048,
        n_layers=len(base.head) + n_rep * len(base.period) + len(base.tail),
        n_heads=8 if base.n_heads else 0,
        n_kv_heads=min(8, base.n_kv_heads * 4) if base.n_kv_heads else 0,
        head_dim=64)
