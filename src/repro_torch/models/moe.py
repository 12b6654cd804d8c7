"""Top-k routed Mixture-of-Experts with dense dispatch and combine (port of
``repro.models.moe``).

Tokens are processed in groups of ``group_tokens``; each group builds a
(T, X, C) dispatch tensor (X experts, C capacity slots, filled in arrival
order, a token past an expert's capacity dropped) and the expert FFN runs
as batched products over the expert axis.  Router: softmax probabilities,
top-k, the k weights renormalised (the Mixtral convention); a switch-style
load-balance loss is returned for training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common as cm


def moe_init(gen, cfg: ModelConfig, device, lead: tuple[int, ...] = ()):
    """Router (f32) and expert weights; ``lead`` prepends stacked axes."""
    mo = cfg.moe
    d, f, x = cfg.d_model, mo.d_ff_expert, mo.num_experts
    p = {
        "router": cm.ninit(gen, lead + (d, x), d ** -0.5, device,
                           torch.float32),
        "wi": cm.ninit(gen, lead + (x, d, f), d ** -0.5, device),
        "wg": cm.ninit(gen, lead + (x, d, f), d ** -0.5, device),
        "wo": cm.ninit(gen, lead + (x, f, d), f ** -0.5, device),
    }
    if mo.shared_experts:
        p["shared"] = cm.mlp_init(gen, d, f * mo.shared_experts, device,
                                  lead)
    return p


def _capacity(mo: MoEConfig, group_tokens: int) -> int:
    c = int(mo.capacity_factor * group_tokens * mo.top_k / mo.num_experts)
    return max(8, (c + 7) // 8 * 8)  # a multiple of 8, as the reference


def _act(h, act: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)


def _groups(x, g: int, tg: int):
    """x (B, S, D) as (G, T, D) dispatch groups.  A DTensor keeps a
    batch shard only where whole groups fall in each shard (G divisible
    by its shards) and is gathered on every other mesh dim first: DTensor
    cannot merge axes sharded over two mesh dims."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        rows = 1
        for p, size in zip(x.placements, x.device_mesh.shape):
            if isinstance(p, Shard) and p.dim == 0:
                rows *= size
        want = [p if isinstance(p, Shard) and p.dim == 0 and g % rows == 0
                else Replicate() for p in x.placements]
        if want != list(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.reshape(g, tg, x.shape[-1])


def moe_apply(p, x, cfg: ModelConfig, act: str, top_i=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss f32 scalar).

    ``top_i`` (B, S, top_k), when given, names the experts each token
    takes in place of the router's top-k (the router's probabilities still
    weight them): two computations that round apart at a near tie are
    compared under one routing this way."""
    mo = cfg.moe
    b, s, d = x.shape
    tg = min(mo.group_tokens, b * s)
    while (b * s) % tg:  # the largest divisor of b*s within group_tokens
        tg -= 1
    g = b * s // tg
    xt = _groups(x, g, tg)

    logits = cm.einsum("gtd,dx->gtx", xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)                       # (G,T,X)
    if top_i is None:
        top_p, top_i = torch.topk(probs, mo.top_k, dim=-1)      # (G,T,K)
    else:
        top_i = top_i.reshape(g, tg, mo.top_k).long()
        top_p = torch.gather(probs, -1, top_i)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)             # renormalise

    nx = mo.num_experts
    cap = _capacity(mo, tg)
    onehot = F.one_hot(top_i, nx).float()                       # (G,T,K,X)
    # each (token, choice)'s place in its expert's arrival order
    flat = onehot.reshape(g, tg * mo.top_k, nx)
    pos_flat = torch.cumsum(flat, dim=1) - 1.0                  # (G,T*K,X)
    pos = torch.gather(pos_flat.reshape(g, tg, mo.top_k, nx), -1,
                       top_i[..., None])[..., 0]                # (G,T,K)
    keep = pos < cap
    pos_oh = F.one_hot(pos.long().clamp(0, cap - 1), cap).float() \
        * keep[..., None]

    # dispatch: (G,T,X,C); combine adds the router weights
    dispatch = cm.einsum("gtkx,gtkc->gtxc", onehot, pos_oh)
    combine = cm.einsum("gtkx,gtkc,gtk->gtxc", onehot, pos_oh, top_p)

    xe = cm.einsum("gtxc,gtd->gxcd", dispatch.to(x.dtype), xt)
    hg = cm.einsum("gxcd,xdf->gxcf", xe, p["wg"])
    hu = cm.einsum("gxcd,xdf->gxcf", xe, p["wi"])
    ye = cm.einsum("gxcf,xfd->gxcd", _act(hg, act) * hu, p["wo"])
    out = cm.einsum("gtxc,gxcd->gtd", combine.to(x.dtype), ye)
    # the gradient comes back as the groups' layout before the reshape
    # splits it into groups again
    out = cm.grad_as_input(out.reshape(b, s, d))

    if mo.shared_experts:
        out = out + cm.mlp_apply(p["shared"], x, act)

    # switch-style load-balance loss: X * sum_x f_x * P_x
    f = dispatch.sum(dim=-1).mean(dim=(0, 1))                   # per expert
    pr = probs.mean(dim=(0, 1))
    aux = nx * torch.sum(f * pr)
    return out, aux
