"""seamless-m4t-medium [audio]: enc-dec 12L+12L d=1024 16H (kv=16, MHA)
hd=64 ff=4096 V=256206. Audio frontend is a STUB (input_specs provides
precomputed frame embeddings, 1024-d). [arXiv:2308.11596; hf]"""
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    d_model=1024, n_layers=12, vocab=256_256,  # padded from 256206 for TP16 divisibility
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096,
    period=(LayerDesc(mixer="attn", mlp="gelu"),),
    encoder_layers=12,
    frontend="audio", frontend_dim=1024,
    tie_embeddings=True,
)
