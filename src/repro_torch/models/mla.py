"""DeepSeek-V2 Multi-head Latent Attention (port of ``repro.models.mla``).

Train / prefill: queries through a low-rank path (q_lora); keys and values
through a shared compressed latent c_kv (kv_lora_rank) plus a decoupled
shared RoPE key (rope_head_dim).  The cache holds only (c_kv, k_rope) per
token.  Decode uses the absorbed form: W^UK folds into the query and W^UV
into the output, so attention runs against the latent cache directly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm


def mla_init(gen, cfg: ModelConfig, device, lead: tuple[int, ...] = ()):
    """MLA parameters; ``lead`` prepends stacked axes (the layers)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qd = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": cm.ninit(gen, lead + (d, m.q_lora_rank), d ** -0.5, device),
        "q_norm": cm.ones(lead + (m.q_lora_rank,), device),
        "wq_b": cm.ninit(gen, lead + (m.q_lora_rank, h, qd),
                         m.q_lora_rank ** -0.5, device),
        "wkv_a": cm.ninit(gen, lead + (d, m.kv_lora_rank + m.rope_head_dim),
                          d ** -0.5, device),
        "kv_norm": cm.ones(lead + (m.kv_lora_rank,), device),
        "wk_b": cm.ninit(gen, lead + (m.kv_lora_rank, h, m.nope_head_dim),
                         m.kv_lora_rank ** -0.5, device),
        "wv_b": cm.ninit(gen, lead + (m.kv_lora_rank, h, m.v_head_dim),
                         m.kv_lora_rank ** -0.5, device),
        "wo": cm.ninit(gen, lead + (h, m.v_head_dim, d),
                       (h * m.v_head_dim) ** -0.5, device),
    }


def mla_latent(p, x, cfg: ModelConfig, cos, sin):
    """Compress x to the cached latent: (c_kv (B,S,R), k_rope (B,S,1,Er))."""
    m = cfg.mla
    kv_a = x @ p["wkv_a"]
    c_kv = cm.rmsnorm(kv_a[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., m.kv_lora_rank:][:, :, None, :]          # (B,S,1,Er)
    return c_kv, cm.apply_rope(k_rope, cos, sin)


def mla_queries(p, x, cfg: ModelConfig, cos, sin):
    """(q_nope (B,S,H,En), q_rope (B,S,H,Er))."""
    m = cfg.mla
    cq = cm.rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhe->bshe", cq, p["wq_b"])
    q_rope = cm.apply_rope(q[..., m.nope_head_dim:], cos, sin)
    return q[..., : m.nope_head_dim], q_rope


def mla_attention(p, x, cfg: ModelConfig, cos, sin, q_block=512,
                  kv_block=1024, shard=None):
    """Full-sequence MLA attention (train / prefill).  Returns (out, cache)
    with cache = (c_kv (B,S,R), k_rope (B,S,Er)) for the serving layer."""
    m = cfg.mla
    h = cfg.num_heads
    q_nope, q_rope = mla_queries(p, x, cfg, cos, sin)
    c_kv, k_rope = mla_latent(p, x, cfg, cos, sin)
    if shard is not None:
        # gather the compact latent along the sequence, not its expansion
        c_kv = shard(c_kv, "mla_latent")
        k_rope = shard(k_rope[:, :, 0], "mla_latent")[:, :, None]

    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)                     # (B,S,H,En+Er)
    k = torch.cat([k_nope, k_rope.expand(k_nope.shape[:3]
                                         + (m.rope_head_dim,))], dim=-1)
    if shard is not None:
        k = shard(k, "kv_heads")
        v = shard(v, "kv_heads")
    b, s = x.shape[:2]
    q = q.reshape(b, s, h, 1, -1)
    if shard is not None:
        q = shard(q, "q_heads")
    o = cm.blockwise_attention(q, k, v, causal=True, q_block=q_block,
                               kv_block=kv_block)          # (B,S,H,1,Ev)
    out = torch.einsum("bshe,hed->bsd", o[:, :, :, 0], p["wo"])
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(p, x, cfg: ModelConfig, cos, sin, cache, lengths):
    """Absorbed single-token decode.  cache = (c_kv (B,T,R), k_rope
    (B,T,Er)), already holding the current token at lengths - 1."""
    m = cfg.mla
    q_nope, q_rope = mla_queries(p, x, cfg, cos, sin)           # (B,1,H,*)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]                 # (B,H,*)
    c_kv, k_rope = cache

    q_lat = torch.einsum("bhe,rhe->bhr", q_nope, p["wk_b"])     # absorb W^UK
    s_lat = cm.f32_einsum("bhr,btr->bht", q_lat, c_kv)
    s_rope = cm.f32_einsum("bhe,bte->bht", q_rope, k_rope)
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = (s_lat + s_rope) * scale
    t = c_kv.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    s = torch.where(mask[:, None], s, cm.NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", pattn.to(c_kv.dtype), c_kv)
    o = torch.einsum("bhr,rhe->bhe", o_lat, p["wv_b"])          # absorb W^UV
    return torch.einsum("bhe,hed->bd", o, p["wo"])[:, None, :]
