"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, pattern 2 recurrent : 1 attention
(Griffin).  [arXiv:2402.19427; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,      # MQA in the local-attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    act="gelu",          # GeGLU (gemma family)
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), d_rnn=4096,
                        conv_width=4, local_window=2048),
    source="[arXiv:2402.19427; unverified]",
))
