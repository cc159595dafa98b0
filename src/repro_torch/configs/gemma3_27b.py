"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) hd=128 ff=21504 V=262144.
5:1 local:global attention (local window 1024, global full), 128k-context
RoPE bases (10k local / 1M global). [hf:google/gemma-3-1b-pt; unverified]

Sub-quadratic at decode: local layers keep a ring-buffer window cache; the
~10 global layers are O(seq) memory-bound at decode -> long_500k runs.
"""
from repro_torch.models.transformer import LayerDesc, ModelConfig

LOCAL = LayerDesc(mixer="attn", mlp="swiglu", window=1024, rope_theta=1e4)
GLOBAL = LayerDesc(mixer="attn", mlp="swiglu", window=None, rope_theta=1e6)

CONFIG = ModelConfig(
    name="gemma3-27b",
    d_model=5376, n_layers=62, vocab=262_144,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=21_504,
    period=(LOCAL,) * 5 + (GLOBAL,),            # 10 periods of 6
    tail=(LOCAL, LOCAL),                        # 62 = 10*6 + 2
    tie_embeddings=True, normalize_embed=True, final_softcap=30.0,
    subquadratic=True,
)
