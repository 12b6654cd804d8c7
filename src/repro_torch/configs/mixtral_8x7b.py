"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA.  [arXiv:2401.04088; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    act="silu",
    rope_theta=1_000_000.0,
    window=4096,  # sliding-window attention -> bounded decode state
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    source="[arXiv:2401.04088; hf]",
))
