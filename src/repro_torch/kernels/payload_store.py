"""payload_store on the card: CUDA kernel ``csrc/payload_store.cu``.

Replaces ``repro/kernels/payload_store/kernel.py::payload_store_kernel``.
The TPU wrapper regroups the bytes into int32 words padded to 128 lanes; a
Hopper warp copies the uint8 rows directly, 16 bytes a thread, one warp
per packet, 8 packets per block and one grid row per pipe, in one launch.
Duplicate enabled rows resolve as the sequential TPU kernel does (last
writer wins): a packet's warp copies only if no later enabled packet of
its pipe names the same row, which it finds by scanning the later
packets' rows, staged in shared memory (4 bytes a packet, so a launch
takes at most ``MAX_PACKETS`` packets a pipe).  A larger batch runs as
consecutive launches over tiles of ``MAX_PACKETS`` packets, in arrival
order on one stream: a later tile writes after an earlier one, so the
last writer still wins.  Bound by bytes: one read and one write of each
enabled row.

``payload_store_cuda`` launches the kernel and raises on CPU tensors;
``payload_store`` is the ``auto`` entry, which takes the plain version
(``payload_store_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.backend.ref import payload_store as payload_store_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("payload_store")

MAX_PACKETS = 48 * 1024 // 4  # the rows a block stages, one int32 each

__all__ = ["COUNT", "MAX_PACKETS", "payload_store", "payload_store_cuda",
           "payload_store_plain"]


def payload_store_cuda(table, payload, idx, enb) -> torch.Tensor:
    """In place: table (..., M, W) uint8, payload (..., B, W) uint8,
    idx (..., B) integer, enb (..., B) bool, W a multiple of 16.
    Returns ``table``.  One launch per tile of at most ``MAX_PACKETS``
    packets a pipe."""
    *lead, m, w = table.shape
    b = idx.shape[-1]
    if table.dtype != torch.uint8 or payload.dtype != torch.uint8:
        raise TypeError("payload_store: table and payload must be uint8")
    if tuple(payload.shape) != (*lead, b, w) or tuple(enb.shape) != (*lead, b):
        raise ValueError(
            f"payload_store: shapes table {tuple(table.shape)} payload "
            f"{tuple(payload.shape)} idx {tuple(idx.shape)} enb "
            f"{tuple(enb.shape)} do not agree")
    if w % 16:
        raise ValueError(f"payload_store: row width {w} is not a multiple "
                         "of 16")
    if m >= 1 << 31:
        raise ValueError(f"payload_store: {m} table rows do not fit int32")
    dev = require_cuda("payload_store", table, payload, idx, enb)
    payload = payload.contiguous()
    require_aligned("payload_store", table, payload)
    idx = idx.to(torch.int32).contiguous()
    enb = enb.to(torch.bool).contiguous()
    pipes = table[..., 0, 0].numel()
    if pipes == 0 or b == 0:
        return table
    for lo in range(0, b, MAX_PACKETS):
        rc = library().pp_payload_store(
            table.data_ptr(), payload.data_ptr() + lo * w,
            idx.data_ptr() + lo * 4, enb.data_ptr() + lo, pipes,
            min(MAX_PACKETS, b - lo), b, m, w, stream_handle(dev))
        check("payload_store", rc)
        trace.count(COUNT)
    return table


def payload_store(table, payload, idx, enb) -> torch.Tensor:
    if table.device.type == "cpu":
        return payload_store_plain(table, payload, idx, enb)
    return payload_store_cuda(table, payload, idx, enb)
