"""qwen3-32b [dense]: 64L d=5120 64H (GQA kv=8) hd=128 ff=25600 V=151936.
qk_norm on attention heads. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    d_model=5120, n_layers=64, vocab=151_936,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25_600,
    period=(LayerDesc(mixer="attn", mlp="swiglu", rope_theta=1e6),),
    qk_norm=True, tie_embeddings=False,
)
