"""merge_stage on the card: CUDA kernel ``csrc/merge_stage.cu``.

Merge's whole control pass in one launch of P x N blocks, block (p, r)
owning slots ``[r * span, (r + 1) * span)`` of pipe p (``slot_ranges``),
the checked packets whose clamped tag names one of them and a share of
the others (``packet_blocks``): the tag CRC check of
``csrc/crc16.cuh``, the metadata validate/free pass in arrival order over
the range's rows staged in shared memory (in parallel for packets alone on
their slot, in turns across a warp's lanes for packets that share one)
and the gather-then-clear of ``csrc/payload_fetch.cuh``.  On
Merge's path it stands for the TPU kernels
``repro/kernels/crc16/kernel.py::crc16_kernel`` and
``repro/kernels/payload_fetch/kernel.py::payload_fetch_kernel`` and for
the reference's ``lax.scan`` control pass.  Bound by bytes: the metadata
tables read and written once, the header fields read and the decisions
written once, each matched row read and cleared once and the output rows
written once.

The bitmaps and staged rows take ``shared_bytes(B, M)`` bytes a block.
Past ``MAX_SHARED`` (a batch past ~13,400 packets) they live in a
device-memory scratch tensor of ``scratch_words(B, M)`` int32 words a
block and the same kernel works there, so every size the reference
accepts runs in one launch.

``merge_stage_cuda`` launches the kernel and raises on CPU tensors;
``merge_stage`` is the ``auto`` entry, which takes the plain version
(``merge_stage_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch import trace
from repro_torch.backend.ref import merge_stage as merge_stage_plain
from repro_torch.core.packet import OP_DROP
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("merge_stage")

BLOCK_SHARED = 227 * 1024  # shared memory a Hopper block may use
# the dynamic part: the block's shared memory less the kernel's static
# warp counts and flag (48 B as the compiler lays them out)
MAX_SHARED = BLOCK_SHARED - 48
RANGES = 16              # blocks a pipe: 128 at 8 pipes fill the card
MAX_SPAN = 8192          # slots a block owns at most (more blocks past it)

# the decisions, in the order of the C interface's output pointers
DECISIONS = (("matched", torch.bool), ("premature", torch.bool),
             ("crc_fail", torch.bool), ("disabled", torch.bool),
             ("is_drop_op", torch.bool), ("park_len", torch.int32))

__all__ = ["BLOCK_SHARED", "COUNT", "MAX_SHARED", "merge_stage",
           "merge_stage_cuda", "merge_stage_plain", "packet_blocks",
           "scratch_words", "shared_bytes", "slot_ranges"]


def slot_ranges(m: int) -> tuple[int, int]:
    """``(n, span)``: the blocks a pipe of this kernel and of
    ``csrc/split_control.cu`` and the slots each owns, block r the slots
    ``[r * span, min(M, (r + 1) * span))``.  ``RANGES``
    blocks, more where a block would own over ``MAX_SPAN`` slots, fewer
    where M has fewer slots; a span of 32 slots or more is whole bitmap
    words, and the last range takes what is left of M."""
    m = max(m, 1)
    n = max(min(RANGES, m), -(-m // MAX_SPAN))
    span = -(-m // n)
    if span >= 32:
        span = -(-span // 32) * 32
    return -(-m // span), span


def packet_blocks(checked, pp_ti, m: int):
    """The block of its pipe that handles each packet, as the kernel
    assigns them: a checked packet (alive, pp_valid, ENB 1 and a good
    CRC: it may match and free a slot) the block that owns its clamped
    slot; any other packet, which touches no slot, block ``i mod N`` by its
    place i in the batch.  (..., B) tensors -> (..., B) int64."""
    n, span = slot_ranges(m)
    slot = pp_ti.to(torch.int64)
    slot = torch.where(slot < 0, slot + m, slot).clamp(0, max(m, 1) - 1)
    place = torch.arange(pp_ti.shape[-1], device=pp_ti.device) % n
    return torch.where(checked, slot // span, place)


def shared_bytes(b: int, m: int) -> int:
    """A block's dynamic shared memory, as ``csrc/merge_stage.cu`` sizes
    it: two bitmaps of its range's slots (an even number of words each),
    the expiry, generation and length of each of its slots, and 17 bytes
    a packet."""
    span = slot_ranges(m)[1]
    return 8 * 2 * -(-span // 64) + 12 * span + 17 * b


def scratch_words(b: int, m: int) -> int:
    """int32 words of one block's region of the device-memory scratch that
    takes the shared memory's place past ``MAX_SHARED`` (16-byte aligned)."""
    return -(-shared_bytes(b, m) // 16) * 4


def merge_stage_cuda(table, meta_exp, meta_clk, meta_len, alive, pp_valid,
                     pp_enb, pp_op, pp_ti, pp_clk, pp_crc):
    """table (..., M, W) uint8 with W a multiple of 16, updated in place;
    metadata (..., M) int32; header fields (..., B), on the card.  Returns
    ``((meta_exp, meta_clk, meta_len), d, parked (..., B, W), table)`` as
    ``merge_stage_plain`` does.  Past ``MAX_SHARED`` bytes of bitmaps and
    staged rows a block the kernel works in a device-memory scratch
    tensor."""
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
    blocks, span = slot_ranges(m)
    scratch = None
    if shared_bytes(b, m) > MAX_SHARED:
        scratch = torch.empty((pipes * blocks, scratch_words(b, m)),
                              dtype=torch.int32, device=dev)
    rc = library().pp_merge_stage(
        table.data_ptr(), *(t.data_ptr() for t in meta + flags + fields),
        *(t.data_ptr() for t in new_meta),
        *(d[k].data_ptr() for k, _ in DECISIONS), parked.data_ptr(),
        pipes, b, m, w, OP_DROP, blocks, span,
        None if scratch is None else scratch.data_ptr(), stream_handle(dev))
    check("merge_stage", rc)
    trace.count(COUNT)
    return new_meta, d, parked, table


def merge_stage(table, *args):
    if table.device.type == "cpu":
        return merge_stage_plain(table, *args)
    return merge_stage_cuda(table, *args)
