"""Firewall NF: linear probe through a blocked-IP Access Control List (port
of ``repro.nf.firewall``, paper §6.1).

Header-only: reads ``src_ip`` exclusively.  The firewall is the ``fw``
stage of the ``nf_chain`` primitive, which matches each address against
the rules (plain version ``backend/ref.py::acl_match``; on the card the
device code of ``csrc/acl_match.cuh`` inside ``csrc/nf_chain.cu``).
Calling a ``Firewall`` runs a one-stage chain.  The rules are
configuration, not per-pipe state, so the state is one (R,) tensor shared
by every pipe.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.backend.ref import FwState, Stage
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import NF

CYCLES_PER_RULE = 6.0
CYCLES_BASE = 40.0


@dataclasses.dataclass(frozen=True)
class Firewall(NF):
    """Stateless ACL firewall; ``rules`` is a tuple of blocked src IPs."""

    rules: tuple[int, ...]

    def init_state(self, device=DEFAULT_DEVICE, pipes: int | None = None):
        return torch.tensor(list(self.rules), dtype=torch.int32,
                            device=resolve_device(device)).reshape(-1)

    def stage(self, state, ctx=None) -> Stage:
        return Stage("fw", FwState(rules=state))

    def cycles_of(self, state) -> float:
        return CYCLES_BASE + CYCLES_PER_RULE * state.shape[0]
