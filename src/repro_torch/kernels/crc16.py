"""crc16_tag on the card: CUDA kernel ``csrc/crc16.cu``.

Replaces ``repro/kernels/crc16/kernel.py::crc16_kernel`` (the TPU kernel
tiles the tags to (N, 128) lanes; here one thread takes one packet).
Bound by bytes: 8 read and 4 written per packet; at the main path's 256 to
2560 tags a call is one or a few blocks and costs about a launch.

``crc16_tag_cuda`` launches the kernel and raises on CPU tensors;
``crc16_tag`` is the ``auto`` entry, which takes the plain version
(``crc16_tag_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.backend.ref import crc16_tag as crc16_tag_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_cuda, stream_handle)

COUNT = launch_counter("crc16")

__all__ = ["COUNT", "crc16_tag", "crc16_tag_cuda", "crc16_tag_plain"]


def crc16_tag_cuda(ti: torch.Tensor, clk: torch.Tensor) -> torch.Tensor:
    """ti, clk: (...,) integer tensors on the card -> (...,) int32 CRCs."""
    dev = require_cuda("crc16_tag", ti, clk)
    if ti.shape != clk.shape:
        raise ValueError(f"crc16_tag: shapes differ {ti.shape} {clk.shape}")
    ti = ti.to(torch.int32).contiguous()
    clk = clk.to(torch.int32).contiguous()
    out = torch.empty(ti.shape, dtype=torch.int32, device=dev)
    if ti.numel() == 0:
        return out
    rc = library().pp_crc16_tag(ti.data_ptr(), clk.data_ptr(),
                                out.data_ptr(), ti.numel(),
                                stream_handle(dev))
    check("crc16_tag", rc)
    trace.count(COUNT)
    return out


def crc16_tag(ti: torch.Tensor, clk: torch.Tensor) -> torch.Tensor:
    if ti.device.type == "cpu":
        return crc16_tag_plain(ti, clk)
    return crc16_tag_cuda(ti, clk)
