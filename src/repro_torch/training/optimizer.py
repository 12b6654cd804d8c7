"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.training.optimizer``).

Parameters may be bf16; the first and second moments are f32 and mirror
the parameter dict leaf for leaf.  The arithmetic is the reference's, in
its order and in f32, with every scalar divisor a tensor on the operand's
device (PyTorch divides a CUDA tensor by a Python scalar as a product with
its reciprocal, which rounds otherwise).

``apply_updates`` updates parameters and moments **in place**, leaf by
leaf under ``torch.no_grad()``, and a leaf past ``CHUNK`` elements a slice
of its leading (layer) axis at a time: a functional update of Qwen2.5-3B
would hold old and new moments side by side (2 x 24.7 GB) beside f32
temporaries of its largest leaf, more than one 80 GB card holds.

Leaves may be DTensors (``launch/train.py`` under a mesh).  Each gradient
is first laid out as its parameter (a ``Partial`` gradient reduces), the
update then runs on every rank's local shards, which parameter, moments
and gradient share, so the in-place slices of the layer axis stay local
(every rule replicates that axis); ``global_norm`` sums each leaf's local
squares and all-reduces over the mesh dims that shard it, a replicated
scalar on every rank.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.training.tree import leaves, tree_map

# elements of a leaf updated at once: a larger leaf goes a slice of its
# leading axis at a time, so each f32 temporary stays under 256 MB
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_opt_state(params) -> dict:
    """f32 zero moments mirroring ``params`` (on each leaf's device; meta
    leaves give meta moments) and a 0-d int32 step."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def true_div(a, b):
    """``a / b`` with a scalar operand made a tensor on the other's device:
    a true division on every device."""
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return a / b


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_ratio."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = true_div(step, max(cfg.warmup_steps, 1))
    prog = torch.clamp(true_div(step - cfg.warmup_steps,
                            max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * torch.where(
        step < cfg.warmup_steps, 1.0, cos)


def _chunks(x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` whole, or past CHUNK elements as views of slices of its
    leading axis."""
    if x.dim() == 0 or x.numel() <= CHUNK:
        return [x]
    rows = max(1, CHUNK // (x.numel() // x.shape[0]))
    return [x[i:i + rows] for i in range(0, x.shape[0], rows)]


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def _sum_squares(x):
    """f32 sum of squares of ``x``'s elements; for a DTensor, each
    rank's local sum all-reduced over the mesh dims that shard ``x``."""
    total = sum(torch.sum(torch.square(c.float()))
                for c in _chunks(_local(x)))
    if not is_dtensor(x):
        return total
    from torch.distributed.tensor import DTensor, Partial, Replicate
    return DTensor.from_local(
        total, x.device_mesh,
        [Partial() if p.is_shard() else Replicate() for p in x.placements],
        run_check=False).full_tensor()


def global_norm(tree):
    """sqrt of the f32 sum of squares over the leaves, summed leaf by leaf
    in the reference's order."""
    return torch.sqrt(sum(_sum_squares(x) for x in leaves(tree)))


def _as_param(g, p):
    """``g`` laid out as ``p`` (a DTensor gradient may come back
    ``Partial`` or otherwise placed)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, opt_state, grads):
    """One AdamW step.  Returns (params, opt_state, metrics), as the
    reference does; ``params`` and the moments in ``opt_state`` are updated
    in place (the returned dicts hold the same tensors), so a caller that
    needs the old values copies them first."""
    grads = tree_map(_as_param, grads, params)
    step = _local(opt_state["step"]) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(
        true_div(cfg.grad_clip, torch.clamp(gnorm, min=1e-9)), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, m, v, g, decay: bool):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:  # decay matrices only (standard)
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)  # copy_ rounds to p's dtype

    for p, m, v, g in zip(leaves(params), leaves(opt_state["m"]),
                          leaves(opt_state["v"]), leaves(grads)):
        local = [_local(x) for x in (p, m, v, g)]
        for parts in zip(*map(_chunks, local)):
            upd(*parts, decay=p.dim() >= 2)
    if is_dtensor(opt_state["step"]):
        from torch.distributed.tensor import DTensor
        old = opt_state["step"]
        step = DTensor.from_local(step, old.device_mesh, old.placements,
                                  run_check=False)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, metrics
