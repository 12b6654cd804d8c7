"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 (routed expert)
vocab=102400, MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed.
First layer dense FFN (d_ff=12288).  [arXiv:2405.04434; hf]"""
from repro_torch.configs import register
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # nominal; MLA replaces classic KV heads
    head_dim=128,
    d_ff=12288,         # layer-0 dense FFN width (DSv2)
    vocab_size=102400,
    act="silu",
    rope_theta=10000.0,
    moe=MoEConfig(
        num_experts=160, top_k=6, d_ff_expert=1536,
        shared_experts=2, first_dense_layers=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512, q_lora_rank=1536,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    ),
    source="[arXiv:2405.04434; hf]",
))
