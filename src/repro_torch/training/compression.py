"""int8 error-feedback gradient compression (port of
``repro.training.compression``).

Quantizing gradients to int8 with a per-tensor scale cuts a data-parallel
all-reduce's bytes 4x (f32) / 2x (bf16); the local quantization residual
is carried in an error-feedback buffer and added back before the next
step's quantization, which preserves convergence (Karimireddy et al.,
2019).  ``compress_decompress`` is the round trip (on plain tensors, or on
DTensors laid out as the parameters); ``quantized_psum`` is the collective
form, an all-reduce over a ``torch.distributed`` process group (the
reference's ``psum`` inside ``shard_map``).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.common import local_apply
from repro_torch.training.optimizer import true_div
from repro_torch.training.tree import tree_map


def init_error_state(params):
    """f32 zeros laid out as each parameter (a DTensor's placements too)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _absmax(x):
    """``max(|x|)`` over the whole tensor.  Of a DTensor (no ``Partial``
    placement), a replicated 0-d DTensor: each rank's shard's maximum,
    then one all-reduce MAX over the mesh dims that shard ``x``, the
    global value ``jnp.max`` gives under GSPMD; the gradient is not
    gathered."""
    if not is_dtensor(x):
        return torch.max(torch.abs(x))
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = x.device_mesh
    local = torch.max(torch.abs(x.to_local()))
    return DTensor.from_local(
        local, mesh, [Partial("max") if p.is_shard() else Replicate()
                      for p in x.placements],
        run_check=False).redistribute(mesh, [Replicate()] * mesh.ndim)


def _quant(x):
    """(int8 codes, per-tensor scale) of ``x``; on a DTensor the scale is a
    plain 0-d tensor, the same on every rank, and the codes keep ``x``'s
    layout, computed shard by shard (DTensor has no rule for ``round``,
    ``clamp`` or the int8 cast in some torch versions)."""
    amax = _absmax(x)
    if is_dtensor(amax):
        amax = amax.to_local()
    scale = true_div(torch.clamp(amax, min=1e-12), 127.0)
    # torch.round, like jnp.round, rounds half to even
    q = local_apply(lambda a: torch.clamp(torch.round(a / scale), -127,
                                          127).to(torch.int8), x, None)
    return q, scale


def _dequant(q, scale):
    return local_apply(lambda a: a.float() * scale, q, None)


def compress_decompress(grads, err_state):
    """Error-feedback int8 round trip.  Returns (grads', new_err_state).
    DTensor gradients are first laid out as their error buffers (the
    parameters' layout); both results keep it."""

    def one(g, e):
        if is_dtensor(g) and tuple(g.placements) != tuple(e.placements):
            g = g.redistribute(e.device_mesh, e.placements)
        x = g.float() + e
        q, scale = _quant(x)
        deq = _dequant(q, scale)
        return deq.to(g.dtype), x - deq

    pairs = tree_map(one, grads, err_state)
    return (tree_map(lambda pair: pair[0], pairs),
            tree_map(lambda pair: pair[1], pairs))


def quantized_psum(x, group=None):
    """int8-quantized all-reduce over ``group`` (the default group when
    None), in the reference's f32 order: quantize locally, take the
    largest scale over the group (``all_reduce`` MAX), requantize against
    it so the integer sum is coherent, all-reduce the int32 payload (wire
    bytes ~= 1/4 of f32) and rescale.  Approximate (scale unification) —
    the error-feedback buffer absorbs the difference.  Every rank of the
    group calls it and gets the same result."""
    import torch.distributed as dist

    xf = x.float()
    _, scale = _quant(xf)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    q2 = torch.clamp(torch.round(xf / scale_max), -127, 127).to(torch.int32)
    dist.all_reduce(q2, op=dist.ReduceOp.SUM, group=group)
    return q2.float() * scale_max
