"""merge_stage on the card: CUDA kernel ``csrc/merge_stage.cu``.

Merge's whole control pass in one launch, one block per pipe: the tag CRC
check of ``csrc/crc16.cuh``, the metadata validate/free pass in arrival
order over rows staged in shared memory (in parallel for packets alone on
their slot, by one lane with a bitmap of freed slots for packets that
share one) and the gather-then-clear of ``csrc/payload_fetch.cuh``.  On
Merge's path it stands for the TPU kernels
``repro/kernels/crc16/kernel.py::crc16_kernel`` and
``repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel`` and for
the reference's ``lax.scan`` control pass.  Bound by bytes: the metadata
tables read and written once, the header fields read and the decisions
written once, each matched row read and cleared once and the output rows
written once.

The bitmaps and staged rows take ``shared_bytes(B, M)`` bytes a pipe.
Past ``MAX_SHARED`` they live in a device-memory scratch tensor of
``scratch_words(B, M)`` int32 words a pipe and the same kernel works
there, so every size the reference accepts runs in one launch.

``merge_stage_cuda`` launches the kernel and raises on CPU tensors;
``merge_stage`` is the ``auto`` entry, which takes the plain version
(``merge_stage_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.backend.ref import merge_stage as merge_stage_plain
from repro_torch.core.packet import OP_DROP
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("merge_stage")

MAX_SHARED = 227 * 1024  # dynamic shared memory a Hopper block may use

# the decisions, in the order of the C interface's output pointers
DECISIONS = (("matched", torch.bool), ("premature", torch.bool),
             ("crc_fail", torch.bool), ("disabled", torch.bool),
             ("is_drop_op", torch.bool), ("park_len", torch.int32))

__all__ = ["COUNT", "MAX_SHARED", "merge_stage", "merge_stage_cuda",
           "merge_stage_plain", "scratch_words", "shared_bytes"]


def shared_bytes(b: int, m: int) -> int:
    """A block's dynamic shared memory, as ``csrc/merge_stage.cu`` sizes
    it: three bitmaps of M bits and 17 bytes a packet."""
    return 12 * ((m + 31) // 32) + 17 * b


def scratch_words(b: int, m: int) -> int:
    """int32 words of one pipe's region of the device-memory scratch that
    takes the shared memory's place past ``MAX_SHARED`` (16-byte aligned)."""
    return -(-shared_bytes(b, m) // 16) * 4


def merge_stage_cuda(table, meta_exp, meta_clk, meta_len, alive, pp_valid,
                     pp_enb, pp_op, pp_ti, pp_clk, pp_crc):
    """table (..., M, W) uint8 with W a multiple of 16, updated in place;
    metadata (..., M) int32; header fields (..., B), on the card.  Returns
    ``((meta_exp, meta_clk, meta_len), d, parked (..., B, W), table)`` as
    ``merge_stage_plain`` does.  Past ``MAX_SHARED`` bytes of bitmaps and
    staged rows the kernel works in a device-memory scratch tensor."""
    *lead, m, w = table.shape
    b = alive.shape[-1]
    header = (alive, pp_valid, pp_enb, pp_op, pp_ti, pp_clk, pp_crc)
    if table.dtype != torch.uint8:
        raise TypeError("merge_stage: table must be uint8")
    if (any(tuple(t.shape) != (*lead, m)
            for t in (meta_exp, meta_clk, meta_len))
            or any(tuple(t.shape) != (*lead, b) for t in header)):
        raise ValueError(
            f"merge_stage: shapes table {tuple(table.shape)}, metadata "
            f"{tuple(meta_exp.shape)}, header "
            f"{[tuple(t.shape) for t in header]} do not agree")
    if w % 16:
        raise ValueError(f"merge_stage: row width {w} is not a multiple "
                         "of 16")
    if m >= 1 << 31:
        raise ValueError(f"merge_stage: {m} table rows do not fit int32")
    dev = require_cuda("merge_stage", table, meta_exp, meta_clk, meta_len,
                       *header)
    meta = [t.to(torch.int32).contiguous()
            for t in (meta_exp, meta_clk, meta_len)]
    flags = [t.to(torch.bool).contiguous() for t in (alive, pp_valid)]
    fields = [t.to(torch.int32).contiguous()
              for t in (pp_enb, pp_op, pp_ti, pp_clk, pp_crc)]
    new_meta = tuple(torch.empty((*lead, m), dtype=torch.int32, device=dev)
                     for _ in range(3))
    d = {k: torch.empty((*lead, b), dtype=dt, device=dev)
         for k, dt in DECISIONS}
    parked = torch.empty((*lead, b, w), dtype=torch.uint8, device=dev)
    require_aligned("merge_stage", table, parked)
    pipes = math.prod(lead)
    if pipes == 0 or b == 0:  # nothing returns: the tables stand
        return tuple(meta), d, parked, table
    scratch = None
    if shared_bytes(b, m) > MAX_SHARED:
        scratch = torch.empty((pipes, scratch_words(b, m)),
                              dtype=torch.int32, device=dev)
    rc = library().pp_merge_stage(
        table.data_ptr(), *(t.data_ptr() for t in meta + flags + fields),
        *(t.data_ptr() for t in new_meta),
        *(d[k].data_ptr() for k, _ in DECISIONS), parked.data_ptr(),
        pipes, b, m, w, OP_DROP,
        None if scratch is None else scratch.data_ptr(), stream_handle(dev))
    check("merge_stage", rc)
    COUNT.launches += 1
    return new_meta, d, parked, table


def merge_stage(table, *args):
    if table.device.type == "cpu":
        return merge_stage_plain(table, *args)
    return merge_stage_cuda(table, *args)
