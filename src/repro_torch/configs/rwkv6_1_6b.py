"""rwkv6-1.6b (Finch) [ssm]: 24L d=2048 attn-free, data-dependent decay,
channel-mix ff=7168 V=65536, 32 heads of 64. [arXiv:2404.05892; unverified]"""
from repro_torch.models.ssm import RWKVConfig
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    d_model=2048, n_layers=24, vocab=65_536,
    d_ff=7168,
    period=(LayerDesc(mixer="rwkv", mlp="rwkv_cm"),),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    tie_embeddings=False, subquadratic=True,
)
