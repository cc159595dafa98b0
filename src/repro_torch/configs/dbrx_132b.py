"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) hd=128 V=100352,
fine-grained MoE 16 experts top-4 (d_expert=10752) in every layer.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    d_model=6144, n_layers=40, vocab=100_352,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=10_752,
    period=(LayerDesc(mixer="attn", mlp="moe", rope_theta=5e5),),
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10_752),
    tie_embeddings=False,
)
