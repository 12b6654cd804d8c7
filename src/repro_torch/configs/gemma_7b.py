"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",              # GeGLU
    rope_theta=10000.0,
    tie_embeddings=True,     # Gemma ties input/output embeddings
    embed_scale=True,
    source="[arXiv:2403.08295; hf]",
))
