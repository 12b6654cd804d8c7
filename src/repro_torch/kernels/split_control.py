"""split_control on the card: CUDA kernel ``csrc/split_control.cu``.

Split's control pass in one launch, one block per pipe: the tagger's
running count of eligible packets by a block-wide scan, the metadata probe
in parallel (eligible packets claim distinct slots when they number at
most M; one thread walks them in order when they do not) and the tag CRC
of ``csrc/crc16.cuh``.  On Split's path it stands for the TPU kernel
``repro/kernels/crc16/kernel.py::crc16_kernel`` and for the reference's
``lax.scan`` control pass.  Bound by bytes: the metadata tables read and
written once, 5 bytes read and 24 written per packet.

``split_control_cuda`` launches the kernel and raises on CPU tensors;
``split_control`` is the ``auto`` entry, which takes the plain version
(``split_control_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.backend.ref import split_control as split_control_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_cuda, stream_handle)

COUNT = launch_counter("split_control")

# the decisions, in the order of the C interface's output pointers
DECISIONS = (("enb", torch.bool), ("ti", torch.int32), ("clk", torch.int32),
             ("evicted", torch.bool), ("skip_occupied", torch.bool),
             ("skip_small", torch.bool), ("park_len", torch.int32),
             ("crc", torch.int32))

__all__ = ["COUNT", "split_control", "split_control_cuda",
           "split_control_plain"]


def split_control_cuda(m, max_exp, max_clk, min_park_len, pass_bytes,
                       tbl_idx, clk, meta_exp, meta_clk, meta_len, alive,
                       payload_len):
    """Registers (...,), metadata (..., M) int32 and packets (..., B) on
    the card -> ``((tbl_idx, clk, meta_exp, meta_clk, meta_len), d)`` as
    ``split_control_plain`` returns them (new tensors)."""
    lead = tuple(tbl_idx.shape)
    b = alive.shape[-1]
    if (tuple(clk.shape) != lead
            or any(tuple(t.shape) != (*lead, m)
                   for t in (meta_exp, meta_clk, meta_len))
            or tuple(alive.shape) != (*lead, b)
            or tuple(payload_len.shape) != (*lead, b)):
        raise ValueError(
            f"split_control: shapes registers {lead} / {tuple(clk.shape)}, "
            f"metadata {tuple(meta_exp.shape)} (capacity {m}), packets "
            f"{tuple(alive.shape)} / {tuple(payload_len.shape)} do not agree")
    if m >= 1 << 31:
        raise ValueError(f"split_control: {m} table rows do not fit int32")
    dev = require_cuda("split_control", tbl_idx, clk, meta_exp, meta_clk,
                       meta_len, alive, payload_len)
    ins = [t.to(torch.int32).contiguous()
           for t in (tbl_idx, clk, meta_exp, meta_clk, meta_len)]
    alive = alive.to(torch.bool).contiguous()
    plen = payload_len.to(torch.int32).contiguous()
    regs = tuple(torch.empty(lead, dtype=torch.int32, device=dev)
                 for _ in range(2))
    meta = tuple(torch.empty((*lead, m), dtype=torch.int32, device=dev)
                 for _ in range(3))
    d = {k: torch.empty((*lead, b), dtype=dt, device=dev)
         for k, dt in DECISIONS}
    pipes = math.prod(lead)
    if pipes == 0 or b == 0:  # nothing to tag: registers and tables stand
        return tuple(ins), d
    rc = library().pp_split_control(
        *(t.data_ptr() for t in ins), alive.data_ptr(), plen.data_ptr(),
        *(t.data_ptr() for t in regs + meta),
        *(d[k].data_ptr() for k, _ in DECISIONS),
        pipes, b, m, max_clk, max_exp, min_park_len, pass_bytes,
        stream_handle(dev))
    check("split_control", rc)
    COUNT.launches += 1
    return regs + meta, d


def split_control(m, max_exp, max_clk, min_park_len, pass_bytes, tbl_idx,
                  *tensors):
    fn = split_control_plain if tbl_idx.device.type == "cpu" \
        else split_control_cuda
    return fn(m, max_exp, max_clk, min_park_len, pass_bytes, tbl_idx,
              *tensors)
