"""MAC address swapper NF with a tunable busy-loop cost knob (port of
``repro.nf.macswap``).

Paper §6.1/§6.3.3: NF-Light/Medium/Heavy are a MAC swapper plus a busy
loop of ~50/300/570 average CPU cycles per packet.  The busy loop affects
only the analytic cycle cost, not the functional transform.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packet import PacketBatch
from repro_torch.device import DEFAULT_DEVICE

NF_LIGHT = 50.0
NF_MEDIUM = 300.0
NF_HEAVY = 570.0


@dataclasses.dataclass(frozen=True)
class MacSwap:
    cycles: float = NF_LIGHT

    def init_state(self, device=DEFAULT_DEVICE, pipes: int | None = None):
        return ()

    def __call__(self, state, pkts: PacketBatch, backend=None, ctx=None):
        out = pkts.replace(
            dst_mac=torch.where(pkts.alive, pkts.src_mac, pkts.dst_mac),
            src_mac=torch.where(pkts.alive, pkts.dst_mac, pkts.src_mac),
        )
        drop = torch.zeros_like(pkts.alive)
        return state, out, drop, self.cycles
