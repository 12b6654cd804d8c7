"""merge_payload on the card: CUDA kernel ``csrc/merge_payload.cu``.

Merge's packet transformation in one launch, after ``merge_stage``'s
decisions: each returning packet's new payload (its parked prefix put back
in front of the carried remainder, zeros past the new length, or the row
as it came), its length and its header fields, written to new tensors
(the payload that returns may be the one the engine keeps as sent, so
nothing is written in place).  It replaces no TPU kernel: the reference
computes this step as jnp array code in ``repro/core/park.py::merge_fn``.
Bound by bytes: each output byte written once, each payload and restored
parked byte read once; the kernel cuts the flat output into 16-byte
chunks, a warp a row, and reads each chunk's runs of source bytes with
aligned 16-byte loads.

``merge_payload_cuda`` launches the kernel and raises on CPU tensors;
``merge_payload`` is the ``auto`` entry, which takes the plain version
(``merge_payload_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch import trace
from repro_torch.backend.ref import merge_payload as merge_payload_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("merge_payload")

# the dtype of each per-packet input, in argument order: the header fields
# of ``MERGE_PAYLOAD_FIELDS`` after the payload, then ``MERGE_DECISIONS``
HEADER_DTYPES = (torch.int32, torch.bool, torch.bool) + (torch.int32,) * 5
DECISION_DTYPES = (torch.bool,) * 5 + (torch.int32,)

__all__ = ["COUNT", "merge_payload", "merge_payload_cuda",
           "merge_payload_plain"]


def _rows(t: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """``t`` as (rows, width) with unit stride along a row: a view where
    its strides allow one, so the kernel reads it in place."""
    v = t.reshape(rows, width)
    return v if v.stride(1) == 1 or width <= 1 else v.contiguous()


def merge_payload_cuda(payload, payload_len, alive, pp_valid, pp_enb, pp_op,
                       pp_ti, pp_clk, pp_crc, parked, matched, premature,
                       crc_fail, disabled, is_drop_op, park_len):
    """payload (..., B, pmax) uint8, header fields (..., B) (``alive`` and
    ``pp_valid`` bool, the rest int32), parked (..., B, W) uint8 and
    ``merge_stage``'s decisions (..., B) (bool, ``park_len`` int32), on
    the card.  Returns new tensors of ``MERGE_PAYLOAD_FIELDS`` as
    ``merge_payload_plain`` does, in one launch (none when there is no
    packet)."""
    *lead, b, pmax = payload.shape
    w = parked.shape[-1]
    per_packet = (payload_len, alive, pp_valid, pp_enb, pp_op, pp_ti,
                  pp_clk, pp_crc, matched, premature, crc_fail, disabled,
                  is_drop_op, park_len)
    if payload.dtype != torch.uint8 or parked.dtype != torch.uint8:
        raise TypeError("merge_payload: payload and parked must be uint8")
    if tuple(parked.shape) != (*lead, b, w) or any(
            tuple(t.shape) != (*lead, b) for t in per_packet):
        raise ValueError(
            f"merge_payload: shapes payload {tuple(payload.shape)}, parked "
            f"{tuple(parked.shape)}, per packet "
            f"{[tuple(t.shape) for t in per_packet]} do not agree")
    wrong = [(k, t.dtype) for k, (t, want) in enumerate(
        zip(per_packet, HEADER_DTYPES + DECISION_DTYPES)) if t.dtype != want]
    if wrong:
        raise TypeError(f"merge_payload: per-packet inputs of the wrong "
                        f"dtype (argument, dtype): {wrong}")
    if max(pmax, w) >= 1 << 30:
        raise ValueError(f"merge_payload: rows of {pmax} and {w} bytes: "
                         "the kernel takes rows under 2**30 bytes")
    dev = require_cuda("merge_payload", payload, parked, *per_packet)
    rows = math.prod(lead) * b
    out = tuple(torch.empty(t.shape, dtype=t.dtype, device=dev)
                for t in (payload,) + per_packet[:8])
    if rows == 0:
        return out
    src = _rows(payload, rows, pmax)
    rest = _rows(parked, rows, w)
    flat = [t.contiguous() for t in per_packet]
    require_aligned("merge_payload", out[0])
    rc = library().pp_merge_payload(
        src.data_ptr(), *(t.data_ptr() for t in flat[:8]), rest.data_ptr(),
        *(t.data_ptr() for t in flat[8:]), *(t.data_ptr() for t in out),
        rows, pmax, src.stride(0), w, rest.stride(0), stream_handle(dev))
    check("merge_payload", rc)
    trace.count(COUNT)
    return out


def merge_payload(payload, *args):
    if payload.device.type == "cpu":
        return merge_payload_plain(payload, *args)
    return merge_payload_cuda(payload, *args)

