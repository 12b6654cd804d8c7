"""Firewall NF: linear probe through a blocked-IP Access Control List (port
of ``repro.nf.firewall``, paper §6.1).

Header-only: reads ``src_ip`` exclusively.  The rule match is the
``acl_match`` primitive of the backend registry.  The rules are
configuration, not per-pipe state, so the state is one (R,) tensor shared
by every pipe.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.backend.registry import dispatch
from repro_torch.core.packet import PacketBatch
from repro_torch.device import DEFAULT_DEVICE, resolve_device

CYCLES_PER_RULE = 6.0
CYCLES_BASE = 40.0


@dataclasses.dataclass(frozen=True)
class Firewall:
    """Stateless ACL firewall; ``rules`` is a tuple of blocked src IPs."""

    rules: tuple[int, ...]

    def init_state(self, device=DEFAULT_DEVICE, pipes: int | None = None):
        return torch.tensor(list(self.rules), dtype=torch.int32,
                            device=resolve_device(device)).reshape(-1)

    def __call__(self, state, pkts: PacketBatch, backend=None, ctx=None):
        rules = state  # (R,) int32
        blocked = dispatch("acl_match", backend)(pkts.src_ip, rules)
        drop = pkts.alive & blocked
        out = pkts.replace(alive=pkts.alive & ~blocked)
        cycles = CYCLES_BASE + CYCLES_PER_RULE * rules.shape[0]
        return state, out, drop, cycles
