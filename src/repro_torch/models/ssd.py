"""Mamba-2 SSD (state-space duality) block (port of ``repro.models.ssd``).

Chunked SSD (Dao & Gu, arXiv:2405.21060): the sequence runs in chunks of Q
tokens; within a chunk the quadratic (dual) form computes the outputs with
a decay-masked C·Bᵀ score matrix, and a loop over the chunks carries the
state (B, H, N, P) from one to the next, so peak memory is one chunk's
score tile (B, Q, Q, H).  Decode carries (conv windows, state): constant
size.  Projections are split per component (z / x / B / C / dt); a single
group (n_groups = 1) shares B and C across heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import common as cm


def ssd_init(gen, cfg: ModelConfig, device, lead: tuple[int, ...] = ()):
    """SSD parameters; ``lead`` prepends stacked axes (the layers)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nheads = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    f32 = torch.float32

    def fixed(v):  # the same values on every stacked layer
        return v.to(device).expand(lead + v.shape).contiguous()

    return {
        "w_z": cm.ninit(gen, lead + (d, d_in), d ** -0.5, device),
        "w_x": cm.ninit(gen, lead + (d, d_in), d ** -0.5, device),
        "w_b": cm.ninit(gen, lead + (d, gn), d ** -0.5, device),
        "w_c": cm.ninit(gen, lead + (d, gn), d ** -0.5, device),
        "w_dt": cm.ninit(gen, lead + (d, nheads), d ** -0.5, device),
        "conv_x": cm.ninit(gen, lead + (s.conv_width, d_in),
                           s.conv_width ** -0.5, device),
        "conv_x_b": cm.zeros(lead + (d_in,), device),
        "conv_b": cm.ninit(gen, lead + (s.conv_width, gn),
                           s.conv_width ** -0.5, device),
        "conv_b_b": cm.zeros(lead + (gn,), device),
        "conv_c": cm.ninit(gen, lead + (s.conv_width, gn),
                           s.conv_width ** -0.5, device),
        "conv_c_b": cm.zeros(lead + (gn,), device),
        "dt_bias": cm.zeros(lead + (nheads,), device, f32),
        "a_log": fixed(torch.log(torch.linspace(1.0, 16.0, nheads,
                                                dtype=f32))),
        "d_skip": cm.ones(lead + (nheads,), device),
        "norm": cm.ones(lead + (d_in,), device),
        "out_proj": cm.ninit(gen, lead + (d_in, d), d_in ** -0.5, device),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv + SiLU.  x: (B,S,C); state: (B,W-1,C)."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i: i + s] * w[width - 1 - i] for i in range(width))
    return F.silu(y + b), xp[:, -(width - 1):]


def _project(p, x, cfg: ModelConfig, conv_state):
    """The shared projection path.  Returns (z, xh, bmat, cmat, dt,
    conv_state)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    cs = conv_state or {}
    z = cm.matmul(x, p["w_z"])
    xs, cx = _causal_conv(cm.matmul(x, p["w_x"]), p["conv_x"], p["conv_x_b"],
                          cs.get("x"))
    bmat, cb = _causal_conv(cm.matmul(x, p["w_b"]), p["conv_b"], p["conv_b_b"],
                            cs.get("b"))
    cmat, cc = _causal_conv(cm.matmul(x, p["w_c"]), p["conv_c"], p["conv_c_b"],
                            cs.get("c"))
    dt = cm.matmul(x, p["w_dt"])
    bsz, slen = x.shape[:2]
    xh = xs.reshape(bsz, slen, nheads, s.head_dim)
    return z, xh, bmat, cmat, dt, {"x": cx, "b": cb, "c": cc}


def _gated_out(p, y, z, cfg: ModelConfig):
    """Gated RMSNorm, then the output projection."""
    y = cm.rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return cm.matmul(y, p["out_proj"])


def ssd_seq(p, x, cfg: ModelConfig, conv_state=None, h0=None):
    """Full-sequence SSD.  x: (B,S,D) -> (y (B,S,D), (h_last, conv_state)).
    A length that is no chunk multiple is right-padded to one; the padded
    steps only decay the carried state, so the outputs of the real
    positions are exact (callers that keep the state use whole chunks)."""
    s = cfg.ssm
    # the chunked scan runs over whole sequences (heads over "model")
    x = cm.batch_only(x)
    bsz, slen0, _ = x.shape
    q = min(s.chunk, slen0)
    pad = (-slen0) % q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    slen = slen0 + pad
    nc = slen // q

    z, xh, bmat, cmat, dt, conv_state = _project(p, x, cfg, conv_state)
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    hdim = s.head_dim
    xh = xh.float()
    bmat = bmat.reshape(bsz, slen, s.d_state).float()           # G = 1
    cmat = cmat.reshape(bsz, slen, s.d_state).float()
    dt = F.softplus(dt.float() + p["dt_bias"])                  # (B,S,H)
    a = -torch.exp(p["a_log"])                                  # (H,)
    xdt = xh * dt[..., None]                                    # (B,S,H,P)

    dac = (dt * a).reshape(bsz, nc, q, nheads)
    xc = xdt.reshape(bsz, nc, q, nheads, hdim)
    bc = bmat.reshape(bsz, nc, q, s.d_state)
    cc = cmat.reshape(bsz, nc, q, s.d_state)
    cums = cm.local_apply(lambda t: torch.cumsum(t, dim=2), dac, 2)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    # DTensors: a zero carried state is left out (its contribution is 0)
    # rather than made whole on every rank, and each chunk's gradient of
    # the model-replicated B and C is reduced where the chunk takes them,
    # so the projections' gradients arrive alike whatever the chunk count
    dist = is_dtensor(x)
    h = h0 if h0 is not None or dist else torch.zeros(
        (bsz, nheads, s.d_state, hdim), dtype=torch.float32, device=x.device)
    ys = []
    # one unbind a tensor: its backward stacks the chunks' gradients once
    # (indexing each chunk out would add a whole-size gradient per chunk,
    # bytes quadratic in the chunk count)
    for cums_c, xc_c, bc_c, cc_c in zip(*(t.unbind(1)
                                          for t in (cums, xc, bc, cc))):
        if dist:
            bc_c, cc_c = cm.grad_as_input(bc_c), cm.grad_as_input(cc_c)
        # intra-chunk decay L[q1,q2] = exp(cums[q1] - cums[q2]), q1 >= q2;
        # masked before the exp (above the diagonal it overflows)
        seg = cums_c[:, :, None, :] - cums_c[:, None, :, :]     # (B,Q,Q,H)
        l_mask = torch.exp(torch.where(tri[None, :, :, None], seg, -1e30))
        scores = cm.einsum("bqn,bkn->bqk", cc_c, bc_c)       # (B,Q,Q)
        y_diag = cm.einsum("bqk,bqkh,bkhp->bqhp", scores, l_mask, xc_c)
        # h' = decay_all * h + sum_k B_k (x) x_k decayed to the chunk's end
        decay_all = torch.exp(cums_c[:, -1])                    # (B,H)
        decay_out = torch.exp(cums_c[:, -1:, :] - cums_c)       # (B,Q,H)
        states = cm.einsum("bkn,bkh,bkhp->bhnp", bc_c, decay_out, xc_c)
        if h is None:
            ys.append(y_diag)
            h = states
            continue
        # the carried state's contribution
        decay_in = torch.exp(cums_c)                            # (B,Q,H)
        y_off = cm.einsum("bqn,bhnp,bqh->bqhp", cc_c, h, decay_in)
        h = decay_all[:, :, None, None] * h + states
        ys.append(y_diag + y_off)
    # (the gradient comes back laid out as the chunks' output, whatever
    # layout the gated norm's backward gave it, before it is split into
    # chunks again)
    y = cm.grad_as_input(torch.stack(ys, dim=1).reshape(bsz, slen, nheads,
                                                         hdim))
    y = y + p["d_skip"][:, None] * xh                           # D skip
    y = y.reshape(bsz, slen, d_in).to(x.dtype)
    out = _gated_out(p, y, z, cfg)
    if pad:
        out = out[:, :-pad]
    return out, (h, conv_state)


def ssd_step(p, x, cfg: ModelConfig, state):
    """Single-token decode.  x: (B,1,D); state = (h (B,H,N,P) f32, conv)."""
    s = cfg.ssm
    h_prev, conv_state = state
    z, xh, bmat, cmat, dt, conv_state = _project(p, x, cfg, conv_state)
    d_in = s.expand * cfg.d_model
    xh = xh[:, 0].float()                                       # (B,H,P)
    bv = bmat[:, 0].float()                                     # (B,N)
    cv = cmat[:, 0].float()
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])           # (B,H)
    decay = torch.exp(dtv * -torch.exp(p["a_log"]))             # (B,H)
    h = decay[:, :, None, None] * h_prev + cm.einsum(
        "bn,bh,bhp->bhnp", bv, dtv, xh)
    y = cm.einsum("bn,bhnp->bhp", cv, h) + p["d_skip"][:, None] * xh
    y = y.reshape(-1, 1, d_in).to(x.dtype)
    return _gated_out(p, y, z, cfg), (h, conv_state)
