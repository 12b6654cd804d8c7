"""MAC address swapper NF with a tunable busy-loop cost knob (port of
``repro.nf.macswap``).

Paper §6.1/§6.3.3: NF-Light/Medium/Heavy are a MAC swapper plus a busy
loop of ~50/300/570 average CPU cycles per packet.  The busy loop affects
only the analytic cycle cost, not the functional transform.
"""
from __future__ import annotations

import dataclasses

from repro_torch.backend.ref import Stage
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.nf.chain import NF

NF_LIGHT = 50.0
NF_MEDIUM = 300.0
NF_HEAVY = 570.0


@dataclasses.dataclass(frozen=True)
class MacSwap(NF):
    cycles: float = NF_LIGHT

    def init_state(self, device=DEFAULT_DEVICE, pipes: int | None = None):
        return ()

    def stage(self, state, ctx=None) -> Stage:
        return Stage("macswap")

    def cycles_of(self, state) -> float:
        return self.cycles
