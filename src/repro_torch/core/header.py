"""PayloadPark header helpers: tag CRC computation and validation (port of
``repro.core.header``).

CRC-16/CCITT-FALSE over the 4 little-endian tag bytes (ti, clk), paper
§3.2.  Both entry points route through ``repro_torch.backend.dispatch`` so
Split and Merge stamp and check tags on the backend the caller chose.
"""
from __future__ import annotations

import torch

from repro_torch.backend.registry import dispatch


def crc16_tag(ti: torch.Tensor, clk: torch.Tensor, backend=None) -> torch.Tensor:
    """CRC over the PayloadPark tag on the selected backend."""
    return dispatch("crc16_tag", backend)(ti, clk)


def tag_valid(ti: torch.Tensor, clk: torch.Tensor, crc: torch.Tensor,
              backend=None) -> torch.Tensor:
    """Header validation performed by Merge before touching the tables."""
    return crc16_tag(ti, clk, backend=backend) == crc
