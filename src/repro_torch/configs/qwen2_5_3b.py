"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
))
