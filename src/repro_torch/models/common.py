"""Transformer building blocks the serving engine uses (port of the
matching part of ``repro.models.common``).

Plain functions on tensors over explicit parameter dicts, with the
reference's conventions: compute dtype bf16, norm scales and rotary tables
f32, softmax and logits accumulation f32.  Dimension names: B batch, S
sequence, D model, H query heads, K KV heads, G query heads per KV head
(H = K * G), E head dim, F d_ff, V vocab.

Initializers draw from an explicit ``torch.Generator`` and create their
tensors on ``device`` (``"meta"`` gives shapes and dtypes without memory).
The prefill attention, the M-RoPE branch and the one-hot embedding belong
to the LM-stack port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def ninit(gen: torch.Generator | None, shape, scale, device, dtype=DTYPE):
    """Normal(0, scale) drawn in f32 and cast to ``dtype``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def zeros(shape, device, dtype=DTYPE):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, device, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# norms and rotary embeddings
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_angles(positions, head_dim, theta):
    """positions: (B, S) integer.  Returns (cos, sin): (B, S, head_dim/2)
    f32 (the plain RoPE branch of the reference)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, N, E); cos/sin: (B, S, E/2).  Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device, lead: tuple[int, ...] = ()):
    """Attention parameters; ``lead`` prepends stacked axes (the layers)."""
    d, h, k, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ninit(gen, lead + (d, h, e), d ** -0.5, device),
        "wk": ninit(gen, lead + (d, k, e), d ** -0.5, device),
        "wv": ninit(gen, lead + (d, k, e), d ** -0.5, device),
        "wo": ninit(gen, lead + (h, e, d), (h * e) ** -0.5, device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(lead + (h, e), device)
        p["bk"] = zeros(lead + (k, e), device)
        p["bv"] = zeros(lead + (k, e), device)
    if cfg.qk_norm:
        p["q_norm"] = ones(lead + (e,), device)
        p["k_norm"] = ones(lead + (e,), device)
    return p


def _proj(x, w):
    """x (B, S, D) against w (D, ...) -> (B, S, ...)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(x.shape[:-1] + w.shape[1:])


def attn_qkv(p, x, cfg: ModelConfig, cos, sin):
    """Project + position-encode.
    x: (B,S,D) -> q (B,S,K,G,E), k/v (B,S,K,E)."""
    h, k = cfg.num_heads, cfg.num_kv_heads
    q = _proj(x, p["wq"])
    kx = _proj(x, p["wk"])
    vx = _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        kx = kx + p["bk"]
        vx = vx + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        kx = rmsnorm(kx, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, cos, sin)
    kx = apply_rope(kx, cos, sin)
    b, s = q.shape[:2]
    return q.reshape(b, s, k, h // k, cfg.head_dim), kx, vx


def attn_out(p, o):
    """o: (B, S, K, G, E) -> (B, S, D)."""
    b, s, k, g, e = o.shape
    return o.reshape(b, s, k * g * e) @ p["wo"].reshape(k * g * e, -1)


# --------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, device, lead: tuple[int, ...] = ()):
    return {
        "wi": ninit(gen, lead + (d_model, d_ff), d_model ** -0.5, device),
        "wg": ninit(gen, lead + (d_model, d_ff), d_model ** -0.5, device),
        "wo": ninit(gen, lead + (d_ff, d_model), d_ff ** -0.5, device),
    }


def mlp_apply(p, x, act: str):
    gate = x @ p["wg"]
    up = x @ p["wi"]
    # jax.nn.gelu defaults to the tanh approximation
    a = F.gelu(gate, approximate="tanh") if act == "gelu" else F.silu(gate)
    return (a * up) @ p["wo"]


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, device):
    v = cfg.vocab_padded()
    p = {"table": ninit(gen, (v, cfg.d_model), cfg.d_model ** -0.5, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = ninit(gen, (cfg.d_model, v), cfg.d_model ** -0.5,
                             device)
    return p


def embed_apply(p, tokens, cfg: ModelConfig):
    x = p["table"][tokens]
    if cfg.embed_scale:
        # gemma scaling; sqrt(d_model) is rounded to the table's dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed_apply(p, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return x @ p["table"].T
    return x @ p["unembed"]
