"""Reduced (CPU-smoke) variants of every assigned architecture (copy of
``repro.configs.reduced``).

Same family, same code paths (GQA ratios, MoE routing, MLA ranks, hybrid
pattern, SSD chunks) — tiny dimensions.  The CPU tests and the reduced
serving runs use these; the full configs run on the card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (HybridConfig, MLAConfig, ModelConfig,
                                MoEConfig, SSMConfig)


def reduced(cfg: ModelConfig) -> ModelConfig:
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads,
                                4 * cfg.num_kv_heads // max(cfg.num_heads, 1))
                         ) if cfg.num_kv_heads else 0,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
    )
    if cfg.family == "hybrid":
        kw["num_layers"] = 5  # exercises pattern remainder (3 + 2)
        kw["hybrid"] = HybridConfig(pattern=cfg.hybrid.pattern, d_rnn=64,
                                    conv_width=cfg.hybrid.conv_width,
                                    local_window=16)
    if cfg.ssm is not None:
        kw["num_heads"] = 8   # d_inner/head_dim = 128/16
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2, chunk=8,
                              conv_width=cfg.ssm.conv_width, n_groups=1)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            shared_experts=cfg.moe.shared_experts,
            first_dense_layers=cfg.moe.first_dense_layers,
            group_tokens=32,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                              rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    if cfg.enc_layers:
        kw["enc_layers"] = 2
    if cfg.window is not None:
        kw["window"] = 16
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (2, 3, 3)  # sums to head_dim/2 = 8
    return dataclasses.replace(cfg, **kw)
