"""deepseek-moe-16b [moe]: 28L d=2048 16H (MHA kv=16) hd=128 V=102400,
fine-grained MoE: 64 routed experts top-6 + 2 shared experts, d_expert=1408.
Layer 0 is dense in the reference model; we place the dense layer in the
explicit `head` slot. [arXiv:2401.06066; hf]"""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerDesc, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    d_model=2048, n_layers=28, vocab=102_400,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=10_944,
    head=(LayerDesc(mixer="attn", mlp="swiglu"),),          # dense layer 0
    period=(LayerDesc(mixer="attn", mlp="moe"),),           # 27 MoE layers
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    tie_embeddings=False,
)
