"""PayloadPark header helpers: tag CRC computation and validation (port of
``repro.core.header``).

CRC-16/CCITT-FALSE over the 4 little-endian tag bytes (ti, clk), paper
§3.2.  The math lives in the backend registry (``backend/ref.py`` holds the
plain version, ``kernels/crc16.py`` the CUDA kernel); both entry points
here route through ``repro_torch.backend.dispatch`` so a caller stamps and
checks tags on the backend it chose.  The constants are re-exported from
``backend/ref.py``, as the reference does.  The byte-level routines
``crc16_bytes`` and ``tag_bytes``, which the reference also re-exports
here, are imported from ``backend/ref.py`` itself: replint's RPL001 keeps
primitive functions out of dataplane modules, and the reference's
re-export stands only by a reviewed baseline entry.
"""
from __future__ import annotations

import torch

from repro_torch.backend.ref import CRC_INIT, CRC_POLY  # noqa: F401
from repro_torch.backend.registry import dispatch


def crc16_tag(ti: torch.Tensor, clk: torch.Tensor,
              backend=None) -> torch.Tensor:
    """CRC over the PayloadPark tag on the selected backend."""
    return dispatch("crc16_tag", backend)(ti, clk)


def tag_valid(ti: torch.Tensor, clk: torch.Tensor, crc: torch.Tensor,
              backend=None) -> torch.Tensor:
    """Header validation performed by Merge before touching the tables."""
    return crc16_tag(ti, clk, backend=backend) == crc
