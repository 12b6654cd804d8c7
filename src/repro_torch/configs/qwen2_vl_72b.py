"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  Backbone only; the vision
frontend is a stub (input_specs provides precomputed patch embeddings).
[arXiv:2409.12191; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # (t, h, w) rotary channel split
    source="[arXiv:2409.12191; hf]",
))
