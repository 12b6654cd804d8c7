"""maglev_select on the card: CUDA kernel ``csrc/maglev.cu``.

Replaces ``repro/kernels/maglev/kernel.py::maglev_kernel`` (the TPU kernel
tiles the five header fields to (N, 128) lanes and keeps the lookup table
resident in VMEM; here one thread takes one packet and a block stages its
pipe's table in shared memory when it fits).  Bound by bytes: 20 read and
4 written per packet, plus the table once.

The table is either shared by every pipe, ``(T,)``, or one row per pipe,
``(..., T)`` with the packets' leading shape (the engine's per-pipe
live-or-degraded choice under an LB fault); the kernel reads it with a
pipe stride of 0 or T.

``maglev_select_cuda`` launches the kernel and raises on CPU tensors;
``maglev_select`` is the ``auto`` entry, which takes the plain version
(``maglev_select_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.backend.ref import maglev_select as maglev_select_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_cuda, stream_handle)

COUNT = launch_counter("maglev")

__all__ = ["COUNT", "maglev_select", "maglev_select_cuda",
           "maglev_select_plain"]


def maglev_select_cuda(src_ip, dst_ip, src_port, dst_port, proto, table,
                       backend_ips) -> torch.Tensor:
    """Five (..., B) integer header fields on the card, a (T,) or (..., T)
    int32 lookup table of backend indices and (NB,) backend addresses ->
    (..., B) int32 backend address per packet."""
    fields = (src_ip, dst_ip, src_port, dst_port, proto)
    dev = require_cuda("maglev_select", *fields, table, backend_ips)
    shape = src_ip.shape
    if len(shape) == 0 or any(f.shape != shape for f in fields):
        raise ValueError(f"maglev_select: header fields must share one "
                         f"(..., B) shape, got {[f.shape for f in fields]}")
    if table.dim() == 1:
        stride = 0
    elif table.shape[:-1] == shape[:-1]:
        stride = table.shape[-1]
    else:
        raise ValueError(f"maglev_select: table {tuple(table.shape)} is "
                         f"neither (T,) nor one row per pipe of packets "
                         f"{tuple(shape)}")
    if backend_ips.dim() != 1 or table.shape[-1] == 0:
        raise ValueError(f"maglev_select: need a non-empty table and (NB,) "
                         f"backend_ips, got {tuple(table.shape)} and "
                         f"{tuple(backend_ips.shape)}")
    cols = [f.to(torch.int32).contiguous() for f in fields]
    tab = table.to(torch.int32).contiguous()
    bips = backend_ips.to(torch.int32).contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    b = shape[-1]
    rc = library().pp_maglev_select(
        *(c.data_ptr() for c in cols), tab.data_ptr(), stride,
        tab.shape[-1], bips.data_ptr(), out.data_ptr(), out.numel() // b, b,
        stream_handle(dev))
    check("maglev_select", rc)
    trace.count(COUNT)
    return out


def maglev_select(src_ip, dst_ip, src_port, dst_port, proto, table,
                  backend_ips) -> torch.Tensor:
    if src_ip.device.type == "cpu":
        return maglev_select_plain(src_ip, dst_ip, src_port, dst_port, proto,
                                   table, backend_ips)
    return maglev_select_cuda(src_ip, dst_ip, src_port, dst_port, proto,
                              table, backend_ips)
