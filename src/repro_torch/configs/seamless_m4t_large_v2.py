"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal.  Backbone only; the speech frontend is a
stub (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,       # text decoder layers
    enc_layers=24,       # speech encoder layers (frontend stubbed)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    act="silu",
    rope_theta=10000.0,
    source="[arXiv:2308.11596; hf]",
))
