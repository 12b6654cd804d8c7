"""GPipe-style pipeline parallelism over a mesh axis, default "pod" (port
of ``repro.distributed.pipeline``).

Microbatches stream through stages placed on successive ranks of the
stage axis; activations move stage to stage with ``batch_isend_irecv``.
The static schedule runs ``num_micro + S - 1`` ticks; each tick every
stage computes one microbatch and posts the send of its output to stage
``(i + 1) % S`` (and the receive from ``(i - 1) % S``) before the next
tick's compute, so the transfer overlaps it: the first stage, which
feeds microbatches and reads no received activation, computes before it
waits.  The last stage writes the outputs, and a closing ``all_reduce``
(SUM) over the stage group gives them to every stage (the reference's
``psum``).  Bubble fraction (S-1)/(T+S-1).
"""
from __future__ import annotations

import torch

from repro_torch.training.tree import tree_map


def _stages(stage_params) -> int:
    from repro_torch.training.tree import leaves
    return leaves(stage_params)[0].shape[0]


def sequential_apply(stage_fn, stage_params, x):
    """Reference: every stage in order over each microbatch.
    stage_params: (S, ...) (or a dict of such); x: (num_micro, mb, d)."""
    s = _stages(stage_params)
    out = []
    for xm in x:
        for i in range(s):
            xm = stage_fn(tree_map(lambda a: a[i], stage_params), xm)
        out.append(xm)
    return torch.stack(out)


def pipeline_apply(stage_fn, stage_params, x, mesh, stage_axis: str = "pod"):
    """x: (num_micro, mb, d), the same on every rank; stage_params: (S, ...)
    with S the size of ``mesh``'s ``stage_axis``; the rank at position i
    of that axis runs stage i.  Every rank calls it (SPMD) and gets the
    (num_micro, mb, d) outputs."""
    import torch.distributed as dist

    group = mesh.get_group(stage_axis)
    s = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    assert _stages(stage_params) == s, (_stages(stage_params), s)
    stage = mesh.get_local_rank(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % s], ranks[(stage - 1) % s]
    p_local = tree_map(lambda a: a[stage], stage_params)
    num_micro = x.shape[0]

    state = torch.zeros_like(x[0])
    outputs = torch.zeros_like(x)
    pending, inflight = [], None
    for t in range(num_micro + s - 1):
        feeds = stage == 0 and t < num_micro
        if not feeds:
            for req in pending:
                req.wait()
            pending = []
        y = stage_fn(p_local, x[t] if feeds else state).contiguous()
        for req in pending:
            req.wait()
        mb = t - (s - 1)
        if mb >= 0 and stage == s - 1:
            outputs[mb] = y
        if s > 1 and t < num_micro + s - 2:
            state = torch.empty_like(y)
            inflight = (y, state)  # alive until the requests complete
            pending = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, nxt, group),
                dist.P2POp(dist.irecv, state, prv, group)])
        else:
            pending = []
    del inflight
    # only the last stage wrote outputs
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs
