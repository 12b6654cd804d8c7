"""acl_match on the card: CUDA kernel ``csrc/acl_match.cu``.

Replaces ``repro/kernels/acl_match/kernel.py::acl_match_kernel`` (whose
``-1`` rule padding is a TPU tiling artifact the port does without).  One
thread per packet compares its source address against the rules, which
each block stages in shared memory.  Bound by bytes: 4 read and 1 written
per packet; R <= 20 compares are register work.

``acl_match_cuda`` launches the kernel and raises on CPU tensors;
``acl_match`` is the ``auto`` entry, which takes the plain version
(``acl_match_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.backend.ref import acl_match as acl_match_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_cuda, stream_handle)

COUNT = launch_counter("acl_match")

__all__ = ["COUNT", "acl_match", "acl_match_cuda", "acl_match_plain"]


def acl_match_cuda(src_ip: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
    """src_ip: (...,) int32 on the card; rules: (R,) int32 -> (...,) bool."""
    dev = require_cuda("acl_match", src_ip, rules)
    if rules.dim() != 1:
        raise ValueError(f"acl_match: rules must be (R,), got {rules.shape}")
    ip = src_ip.to(torch.int32).contiguous()
    rules = rules.to(torch.int32).contiguous()
    out = torch.empty(ip.shape, dtype=torch.bool, device=dev)
    if ip.numel() == 0:
        return out
    rc = library().pp_acl_match(ip.data_ptr(), rules.data_ptr(),
                                out.data_ptr(), ip.numel(), rules.numel(),
                                stream_handle(dev))
    check("acl_match", rc)
    trace.count(COUNT)
    return out


def acl_match(src_ip: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
    if src_ip.device.type == "cpu":
        return acl_match_plain(src_ip, rules)
    return acl_match_cuda(src_ip, rules)
