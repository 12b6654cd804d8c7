"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro.models.rglru``).

x -> (GeLU gate branch) * (conv1d -> RG-LRU branch) -> output projection.
The recurrence

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = exp(c * r_t * -softplus(lam))          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

is linear in h.  The reference runs the sequence form as one
``jax.lax.associative_scan`` over (a, b) pairs; here it is a log-depth
(Hillis-Steele) scan over the same pairs in f32: log2(S) rounds of
elementwise products, each combining every position with the one 2^r
before it.  Gate projections are block-diagonal (num_heads blocks).
Decode keeps (h, conv window) as state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm

C_FACTOR = 8.0


def rglru_init(gen, cfg: ModelConfig, device, lead: tuple[int, ...] = ()):
    """RG-LRU parameters; ``lead`` prepends stacked axes (the layers)."""
    hy = cfg.hybrid
    d = cfg.d_model
    dr = hy.d_rnn or d
    nb = cfg.num_heads            # block-diagonal gate blocks
    bd = dr // nb
    f32 = torch.float32
    # lam so that a^c spans ~(0.9, 0.999), as in the Griffin paper
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, dr, dtype=f32)) / C_FACTOR))
    return {
        "w_gate": cm.ninit(gen, lead + (d, dr), d ** -0.5, device),
        "w_x": cm.ninit(gen, lead + (d, dr), d ** -0.5, device),
        "conv_w": cm.ninit(gen, lead + (hy.conv_width, dr),
                           hy.conv_width ** -0.5, device),
        "conv_b": cm.zeros(lead + (dr,), device),
        "wa_gate": cm.ninit(gen, lead + (nb, bd, bd), bd ** -0.5, device),
        "ba_gate": cm.zeros(lead + (dr,), device, f32),
        "wx_gate": cm.ninit(gen, lead + (nb, bd, bd), bd ** -0.5, device),
        "bx_gate": cm.zeros(lead + (dr,), device, f32),
        "lam": lam.to(device).expand(lead + (dr,)).contiguous(),
        "w_out": cm.ninit(gen, lead + (dr, d), dr ** -0.5, device),
    }


def _block_linear(w, b, x):
    """Block-diagonal linear: x (B,S,NB,BD) @ w (NB,BD,BD), plus b."""
    y = cm.einsum("bsnd,nde->bsne", x, w)
    return y + b.reshape(1, 1, w.shape[0], -1).to(y.dtype)


def _causal_conv(x, w, b, state=None):
    """Width-W causal conv over the sequence.  x: (B,S,D); state: (B,W-1,D)
    history.  Returns (y, new_state)."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i: i + s] * w[width - 1 - i] for i in range(width))
    return y + b, xp[:, -(width - 1):]


def _gates(p, xr, cfg: ModelConfig):
    """(a, gated input) of the recurrence, f32 (B,S,Dr)."""
    nb = cfg.num_heads
    b, s, dr = xr.shape
    xb = xr.reshape(b, s, nb, dr // nb)
    r = torch.sigmoid(_block_linear(p["wa_gate"], p["ba_gate"], xb)
                      ).reshape(b, s, dr).float()
    i = torch.sigmoid(_block_linear(p["wx_gate"], p["bx_gate"], xb)
                      ).reshape(b, s, dr).float()
    log_a = -C_FACTOR * r * F.softplus(p["lam"])
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i \
        * xr.float()
    return a, gated_x


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h_{-1} = 0, by a
    log-depth scan of the pairs (a, b) under
    (al, bl) . (ar, br) = (al ar, ar bl + br)."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_seq(p, x, cfg: ModelConfig, conv_state=None, h0=None):
    """Full-sequence recurrent block.  x: (B,S,D) -> (y, (h_last,
    conv_state))."""
    # the scan runs over whole sequences (channels over "model")
    x = cm.batch_only(x)
    gate = F.gelu(cm.matmul(x, p["w_gate"]), approximate="tanh")
    xr, conv_state = _causal_conv(cm.matmul(x, p["w_x"]), p["conv_w"],
                                  p["conv_b"], conv_state)
    a, bterm = _gates(p, xr, cfg)
    if h0 is not None:
        # fold the carried state into the first step: b_0 += a_0 * h0
        bterm = torch.cat([bterm[:, :1] + (a[:, 0] * h0)[:, None],
                           bterm[:, 1:]], dim=1)
    h = linear_scan(a, bterm)
    y = h.to(x.dtype) * gate
    return cm.matmul(y, p["w_out"]), (h[:, -1], conv_state)


def rglru_step(p, x, cfg: ModelConfig, state):
    """Single-token decode.  x: (B,1,D); state = (h (B,Dr) f32, conv
    (B,W-1,Dr))."""
    h_prev, conv_state = state
    gate = F.gelu(cm.matmul(x, p["w_gate"]), approximate="tanh")
    xr, conv_state = _causal_conv(cm.matmul(x, p["w_x"]), p["conv_w"],
                                  p["conv_b"], conv_state)
    a, bterm = _gates(p, xr, cfg)
    h = a[:, 0] * h_prev + bterm[:, 0]                          # (B,Dr)
    y = h[:, None].to(x.dtype) * gate
    return cm.matmul(y, p["w_out"]), (h, conv_state)
