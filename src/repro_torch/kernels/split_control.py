"""split_control on the card: CUDA kernel ``csrc/split_control.cu``.

Split's control pass in one launch of P x N blocks, block (p, r) owning
slots ``[r * span, (r + 1) * span)`` of pipe p (``merge_stage.slot_ranges``,
the one definition of the ranges): every block stages its range of the
metadata tables and reads the pipe's packets in one trip and takes each
packet's running count k of eligible packets by a block-wide scan.  A
packet probes only slot (TI + k) mod M, so each slot's packets are
probed in order k, k + M, ... (``ref.split_rounds`` is the plain version
of this order): the block lists the eligible packets by k and one thread
a slot walks its slot's (a walk of at most one step when no more packets
are eligible than M).  Block ``i mod N`` stamps
packet i's tag and the CRC of ``csrc/crc16.cuh``.  Every store comes
after the block's last barrier.  On Split's path it stands for
the TPU kernel ``repro/kernels/crc16/kernel.py::crc16_kernel`` and for the
reference's ``lax.scan`` control pass.  Bound by bytes: the metadata tables
read and written once, 5 bytes read and 20 written per packet.

The staged rows and packet lists take ``shared_bytes(B, M)`` bytes a
block.  Past ``MAX_SHARED`` (a batch past ~17,600 packets at M 4096) they
live in a device-memory scratch tensor of ``scratch_words(B, M)`` int32
words a block and the same kernel works there, so every size the plain
version accepts runs in one launch.

``split_control_cuda`` launches the kernel and raises on CPU tensors;
``split_control`` is the ``auto`` entry, which takes the plain version
(``split_control_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch import trace
from repro_torch.backend.ref import split_control as split_control_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_cuda, stream_handle)
from repro_torch.kernels.merge_stage import BLOCK_SHARED
from repro_torch.kernels.merge_stage import slot_ranges

COUNT = launch_counter("split_control")

# the dynamic shared memory a block may use: Hopper's 227 KB less the
# scan's static warp sums (8 int32)
MAX_SHARED = BLOCK_SHARED - 32

# the decisions, in the order of the C interface's output pointers
DECISIONS = (("enb", torch.bool), ("ti", torch.int32), ("clk", torch.int32),
             ("evicted", torch.bool), ("skip_occupied", torch.bool),
             ("skip_small", torch.bool), ("park_len", torch.int32),
             ("crc", torch.int32))

__all__ = ["COUNT", "MAX_SHARED", "scratch_words", "shared_bytes",
           "split_control", "split_control_cuda", "split_control_plain"]


def shared_bytes(b: int, m: int) -> int:
    """A block's dynamic shared memory, as ``csrc/split_control.cu`` sizes
    it: the expiry, generation and length of each slot of its range, and
    13 bytes a packet (the eligible packets and their park lengths by k,
    each packet's park length and then its k, its flags)."""
    return 12 * slot_ranges(m)[1] + 13 * b


def scratch_words(b: int, m: int) -> int:
    """int32 words of one block's region of the device-memory scratch that
    takes the shared memory's place past ``MAX_SHARED`` (16-byte aligned)."""
    return -(-shared_bytes(b, m) // 16) * 4


def split_control_cuda(m, max_exp, max_clk, min_park_len, pass_bytes,
                       tbl_idx, clk, meta_exp, meta_clk, meta_len, alive,
                       payload_len):
    """Registers (...,), metadata (..., M) int32 and packets (..., B) on
    the card -> ``((tbl_idx, clk, meta_exp, meta_clk, meta_len), d)`` as
    ``split_control_plain`` returns them (new tensors).  Past
    ``MAX_SHARED`` bytes a block the kernel works in a device-memory
    scratch tensor."""
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
    if m >= 1 << 31 or b >= 1 << 31 or not 2 <= max_clk <= 1 << 31:
        raise ValueError(f"split_control: M {m}, B {b} and max_clk "
                         f"{max_clk} do not fit the kernel's 32-bit tagger")
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
    blocks, span = slot_ranges(m)
    scratch = None
    if shared_bytes(b, m) > MAX_SHARED:
        scratch = torch.empty((pipes * blocks, scratch_words(b, m)),
                              dtype=torch.int32, device=dev)
    rc = library().pp_split_control(
        *(t.data_ptr() for t in ins), alive.data_ptr(), plen.data_ptr(),
        *(t.data_ptr() for t in regs + meta),
        *(d[k].data_ptr() for k, _ in DECISIONS),
        pipes, b, m, max_clk, max_exp, min_park_len, pass_bytes, blocks,
        span, None if scratch is None else scratch.data_ptr(),
        stream_handle(dev))
    check("split_control", rc)
    trace.count(COUNT)
    return regs + meta, d


def split_control(m, max_exp, max_clk, min_park_len, pass_bytes, tbl_idx,
                  *tensors):
    fn = split_control_plain if tbl_idx.device.type == "cpu" \
        else split_control_cuda
    return fn(m, max_exp, max_clk, min_park_len, pass_bytes, tbl_idx,
              *tensors)
