"""The training step: loss -> gradients -> (optional compression) -> AdamW
(port of ``repro.training.train_step``).

Compression is a ``grad_transform`` (``launch.train`` passes
``compression.compress_decompress`` with its error state under
``--compress-grads``); ``TrainConfig`` carries no switch for it, since the
reference's ``TrainConfig.compress_grads`` is read by nothing.

Gradients come from ``torch.autograd.grad`` over the parameter leaves, in
the parameters' dtype (bf16 gradients for bf16 parameters, as the
reference's).  AdamW updates the state's tensors in place
(``optimizer.apply_updates``).  Under a mesh the state and batch are
DTensors (``launch/train.py``), ``shard`` is ``Rules.act_shard()`` and
every rank runs the same step, with or without microbatches.  Microbatch
i is the global rows ``i*mb .. (i+1)*mb`` of the batch, as the
reference's ``dynamic_slice_in_dim``: a DTensor batch is gathered along
its batch axis once (token ids, not activations) and each microbatch is
laid out again as the batch was where its rows divide the mesh dims that
shard them (``_microbatches``); the f32 accumulators take each
parameter's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.lm import LM, Shard, _identity, mesh_scope
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    microbatch: int = 0           # 0 = no gradient accumulation


def init_train_state(lm: LM, generator: torch.Generator | None = None,
                     device=None) -> dict:
    """Parameters drawn from ``generator`` (``device="meta"``: shapes and
    dtypes only) and a fresh optimizer state."""
    params = lm.init_params(generator, device=device)
    return {"params": params, "opt": opt.init_opt_state(params)}


def _grads(lm: LM, params, batch, shard: Shard):
    """(loss, metrics, gradients) of ``lm.loss`` at ``params``.  With
    DTensor parameters the backward runs in the model's mesh scope too:
    it meets the plain tensors the forward saved."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with mesh_scope(params):
        loss, metrics = lm.loss(live, batch, shard)
        grads = torch.autograd.grad(loss, leaves(live),
                                    materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, grads))


def _batch_axis(a, b: int) -> int:
    """The batch axis of a batch leaf: 1 for M-RoPE positions (3, B, S),
    else 0."""
    return 1 if (a.dim() >= 2 and a.shape[0] == 3 and a.shape[1] == b) \
        else 0


def _microbatches(a, axis: int, mb: int):
    """A function of i giving rows ``i*mb .. (i+1)*mb`` of ``a`` along
    ``axis``.  A DTensor is gathered along ``axis`` once; each slice is
    then laid out as ``a`` where ``mb`` divides the mesh dims that shard
    ``axis`` (a local split, no collective), else replicated on them."""
    if not is_dtensor(a):
        return lambda i: a.narrow(axis, i * mb, mb)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = a.device_mesh
    on_axis = [isinstance(p, Shard) and p.dim == axis for p in a.placements]
    whole = a.redistribute(mesh, [Replicate() if on else p for on, p in
                                  zip(on_axis, a.placements)])
    ways = 1
    for on, size in zip(on_axis, mesh.shape):
        ways *= size if on else 1
    want = a.placements if mb % ways == 0 else whole.placements

    def take(i):
        part = DTensor.from_local(
            whole.to_local().narrow(axis, i * mb, mb), mesh,
            whole.placements, run_check=False)
        return part.redistribute(mesh, want)
    return take


def train_step(lm: LM, tcfg: TrainConfig, state: dict, batch: dict,
               shard: Shard = _identity,
               grad_transform: Optional[Callable] = None):
    """One optimizer step, ``grad_transform`` between backprop and AdamW.
    Returns (state, metrics: ce, aux, lr, grad_norm, loss); the state's
    tensors are updated in place."""
    b = batch["tokens"].shape[0]

    if tcfg.microbatch and tcfg.microbatch < b:
        # gradient accumulation over microbatches (sequential, memory-lean)
        mb = tcfg.microbatch
        if b % mb:
            raise ValueError(f"batch {b} is not a multiple of the "
                             f"microbatch {mb}")
        n = b // mb
        slicers = {k: _microbatches(v, _batch_axis(v, b), mb)
                   for k, v in batch.items()}
        params = state["params"]
        with mesh_scope(params):
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n):
                loss_i, _, g = _grads(lm, params,
                                      {k: f(i) for k, f in slicers.items()},
                                      shard)
                tree_map(_accumulate, grads, g)
                del g  # free this microbatch's gradients before the next
                loss = loss + loss_i
            grads = tree_map(lambda g: opt.true_div(g, n), grads)
            loss = opt.true_div(loss, n)
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
    else:
        loss, metrics, grads = _grads(lm, state["params"], batch, shard)

    if grad_transform is not None:
        grads = grad_transform(grads)

    params, opt_state, opt_metrics = opt.apply_updates(
        tcfg.adamw, state["params"], state["opt"], grads)
    metrics = dict(metrics, **opt_metrics, loss=loss)
    return {"params": params, "opt": opt_state}, metrics


def _accumulate(acc, g):
    """``acc += g`` in f32; a DTensor ``g`` is first laid out as ``acc``
    (its parameter's layout)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(acc.placements):
        g = g.redistribute(acc.device_mesh, acc.placements)
    acc.add_(g.float())
