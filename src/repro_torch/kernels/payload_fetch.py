"""payload_fetch on the card: CUDA kernel ``csrc/payload_fetch.cu``.

Replaces ``repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel``.
One block per pipe runs ``csrc/payload_fetch.cuh``: it copies every masked
row out, 16 bytes a thread, waits at a barrier and only then zeroes the
rows, so two masked packets naming one row both receive it, as in the
plain version; a masked-off packet (Merge hands those over with
``pp_ti = 0`` duplicates) writes a zero output row and leaves the table
alone.  ``merge_stage`` runs the same device code on Merge's path.  Bound
by bytes: one read and two writes per masked row, one write per
masked-off output row.

``payload_fetch_cuda`` launches the kernel and raises on CPU tensors;
``payload_fetch`` is the ``auto`` entry, which takes the plain version
(``payload_fetch_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.backend.ref import payload_fetch as payload_fetch_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("payload_fetch")

__all__ = ["COUNT", "payload_fetch", "payload_fetch_cuda",
           "payload_fetch_plain"]


def payload_fetch_cuda(table, idx, mask):
    """In place: table (..., M, W) uint8, idx (..., B) integer, mask
    (..., B) bool, W a multiple of 16.  Returns ``(gathered (..., B, W),
    table)``."""
    dev = require_cuda("payload_fetch", table, idx, mask)
    *lead, m, w = table.shape
    b = idx.shape[-1]
    if table.dtype != torch.uint8:
        raise TypeError("payload_fetch: table must be uint8")
    if tuple(idx.shape) != (*lead, b) or tuple(mask.shape) != (*lead, b):
        raise ValueError(
            f"payload_fetch: shapes table {tuple(table.shape)} idx "
            f"{tuple(idx.shape)} mask {tuple(mask.shape)} do not agree")
    if w % 16:
        raise ValueError(f"payload_fetch: row width {w} is not a multiple "
                         "of 16")
    out = torch.empty((*lead, b, w), dtype=torch.uint8, device=dev)
    require_aligned("payload_fetch", table, out)
    idx = idx.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous()
    pipes = table[..., 0, 0].numel()
    if pipes == 0 or b == 0:
        return out, table
    rc = library().pp_payload_fetch(table.data_ptr(), idx.data_ptr(),
                                    mask.data_ptr(), out.data_ptr(), pipes,
                                    b, m, w, stream_handle(dev))
    check("payload_fetch", rc)
    trace.count(COUNT)
    return out, table


def payload_fetch(table, idx, mask):
    if table.device.type == "cpu":
        return payload_fetch_plain(table, idx, mask)
    return payload_fetch_cuda(table, idx, mask)
