"""internlm2-1.8b [dense]: 24L d=2048 16H (GQA kv=8) hd=128 ff=8192 V=92544.
[arXiv:2403.17297; hf]"""
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    d_model=2048, n_layers=24, vocab=92_544,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192,
    period=(LayerDesc(mixer="attn", mlp="swiglu", rope_theta=1e6),),
    tie_embeddings=False,
)
