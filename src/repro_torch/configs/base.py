"""Model configuration schema for the assigned architecture pool (copy of
``repro.configs.base``, kept in the port so the port imports nothing of the
reference).

Every architecture in ``repro_torch/configs/<id>.py`` instantiates
``ModelConfig`` with the exact published numbers; ``reduced()`` derives the
CPU-smoke-test variant (same family and code paths, tiny dimensions).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0          # deepseek-v2: 2 shared experts
    first_dense_layers: int = 0      # deepseek-v2: layer 0 uses dense FFN
    capacity_factor: float = 1.25
    group_tokens: int = 1024         # dispatch group size (tokens)
    router_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Griffin-style block pattern: ``pattern`` repeats; e.g. ("rec","rec","attn")."""
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    d_rnn: Optional[int] = None      # RG-LRU width (defaults to d_model)
    conv_width: int = 4
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU — gemma)
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen2.5 / qwen2-vl
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window attention (mixtral)
    logits_softcap: Optional[float] = None
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma family: x *= sqrt(d_model)
    norm_eps: float = 1e-6

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # enc-dec (seamless-m4t): encoder layer count; num_layers = decoder layers
    enc_layers: int = 0
    # vlm (qwen2-vl): M-RoPE section split of head_dim/2 rotary channels
    mrope_sections: Optional[tuple[int, int, int]] = None

    # citation tag: [source; verification-tier]
    source: str = ""

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can serve 500k-token contexts (bounded attention state)."""
        return (self.family in ("ssm", "hybrid")
                or self.window is not None)

    def vocab_padded(self, divisor: int = 256) -> int:
        """Vocab padded for clean TP sharding (Megatron practice)."""
        return math.ceil(self.vocab_size / divisor) * divisor

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, nl = self.d_model, self.num_layers
        emb = self.vocab_padded() * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
                   + d_in * d + d_in)  # in_proj + out_proj + norm-ish
            return emb + nl * per
        attn = d * self.num_heads * self.head_dim * 2 \
            + d * self.num_kv_heads * self.head_dim * 2
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.num_heads * (m.nope_head_dim + m.rope_head_dim)
                    + d * (m.kv_lora_rank + m.rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        if self.moe is not None:
            mo = self.moe
            ffn_moe = 3 * d * mo.d_ff_expert * mo.num_experts \
                + 3 * d * mo.d_ff_expert * mo.shared_experts + d * mo.num_experts
            ffn_dense = 3 * d * self.d_ff
            n_moe = nl - mo.first_dense_layers
            ffn_total = n_moe * ffn_moe + mo.first_dense_layers * ffn_dense
        else:
            ffn_total = nl * 3 * d * self.d_ff
        enc = self.enc_layers * (attn * 2 + 3 * d * self.d_ff)  # enc + cross approx
        return emb + nl * attn + ffn_total + enc

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d, nl = self.d_model, self.num_layers
        full = self.param_count()
        all_experts = (nl - mo.first_dense_layers) * 3 * d * mo.d_ff_expert * mo.num_experts
        active = (nl - mo.first_dense_layers) * 3 * d * mo.d_ff_expert * mo.top_k
        return full - all_experts + active
