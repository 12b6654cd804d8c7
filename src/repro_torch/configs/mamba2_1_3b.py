"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from repro_torch.configs import register
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,        # d_inner / head_dim = 4096/64
    num_kv_heads=0,      # attention-free
    head_dim=64,
    d_ff=0,              # no separate FFN: the Mamba block is the mixer
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128,
                  conv_width=4, n_groups=1),
    source="[arXiv:2405.21060; unverified]",
))
