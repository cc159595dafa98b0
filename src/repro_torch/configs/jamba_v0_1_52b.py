"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) hd=128 ff=14336,
MoE 16e top-2 (every 2nd layer), Mamba:attention 7:1 interleave (attention at
position 4 of each 8-layer period). [arXiv:2403.19887; hf]"""
from repro_torch.models.ssm import MambaConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LayerDesc, ModelConfig

def _desc(j):
    mixer = "attn" if j == 4 else "mamba"
    mlp = "moe" if j % 2 == 1 else "swiglu"
    return LayerDesc(mixer=mixer, mlp=mlp, rope_theta=1e4)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096, n_layers=32, vocab=65_536,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14_336,
    period=tuple(_desc(j) for j in range(8)),   # 4 periods of 8
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14_336, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False, subquadratic=True,
)
