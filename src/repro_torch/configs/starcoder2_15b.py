"""starcoder2-15b [dense]: 40L d=6144 48H (GQA kv=4) hd=128 ff=24576 V=49152.
GQA + RoPE, GELU MLP (code model). [arXiv:2402.19173; hf]"""
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    d_model=6144, n_layers=40, vocab=49_152,
    n_heads=48, n_kv_heads=4, head_dim=128, d_ff=24_576,
    period=(LayerDesc(mixer="attn", mlp="gelu", rope_theta=1e5),),
    tie_embeddings=False,
)
