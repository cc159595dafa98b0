"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) hd=128 ff=14336 V=131072.
Pixtral ViT frontend is a STUB (input_specs provides 64 precomputed 1024-d
patch embeddings per sample); backbone = mistral-nemo-style decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    d_model=5120, n_layers=40, vocab=131_072,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14_336,
    period=(LayerDesc(mixer="attn", mlp="swiglu", rope_theta=1e6),),
    frontend="vision", frontend_dim=1024, frontend_len=64,
    tie_embeddings=False,
)
