"""NAT NF, modelled on MazuNAT (port of ``repro.nf.nat``, paper §6.1).

Stateful source-NAT with bounded resources: the first packet of a flow
(src_ip, src_port) claims a slot in a linear-probed hash table and maps to
the external port owned by that slot (``base_port + slot``).  Mappings
expire EXP-style; a flow that finds neither its mapping nor a free slot
ages every slot of its probe window (CLOCK).  A flow that returns after
its slot aged out is counted ``nat_stale_hits``, dropped, and its binding
torn down.

The insert walk runs packet by packet in arrival order (two packets of one
flow in one batch must get the same mapping).  NAT is one stage of the
``nf_chain`` primitive: ``Chain.run`` hands it, with the chain's other NFs,
to one dispatch, whose plain version (``backend/ref.py``: ``nat_insert``,
then the rewrite) runs on CPU tensors and whose CUDA kernel
(``csrc/nf_chain.cu``: one block per pipe, the table in shared memory, one
warp walking the packets) runs on the card.  Calling a ``Nat`` runs a
one-stage chain.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.backend.ref import NAT_PROBE_DEPTH as PROBE_DEPTH
from repro_torch.backend.ref import NatConsts, NatState, Stage
from repro_torch.backend.ref import nat_hash as _hash  # noqa: F401
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import NF

CYCLES = 80.0


@dataclasses.dataclass(frozen=True)
class Nat(NF):
    nat_ip: int = 0x0A000001  # 10.0.0.1
    capacity: int = 1 << 14   # flow-table slots
    base_port: int = 10000
    max_exp: int = 2          # EXP-style flow expiry

    def __post_init__(self):
        if self.capacity < PROBE_DEPTH:
            raise ValueError(
                f"capacity ({self.capacity}) must be >= PROBE_DEPTH "
                f"({PROBE_DEPTH})")
        if self.max_exp < 1:
            raise ValueError(f"max_exp must be >= 1, got {self.max_exp}")
        top = self.base_port + self.capacity - 1
        if not (0 < self.base_port and top <= 65535):
            raise ValueError(
                f"port space [{self.base_port}, {top}] exceeds the valid "
                f"uint16 range; shrink capacity or lower base_port")

    def init_state(self, device=DEFAULT_DEVICE, pipes: int | None = None):
        dev = resolve_device(device)
        lead = () if pipes is None else (pipes,)
        cap = (self.capacity,)
        return dict(
            key_ip=torch.full(lead + cap, -1, dtype=torch.int32, device=dev),
            key_port=torch.full(lead + cap, -1, dtype=torch.int32, device=dev),
            exp=torch.zeros(lead + cap, dtype=torch.int32, device=dev),
            stale_hits=torch.zeros(lead, dtype=torch.int32, device=dev),
        )

    def state_counters(self, state) -> dict:
        """NF-private counters surfaced through Chain.state_counters."""
        return {"nat_stale_hits": state["stale_hits"]}

    def stage(self, state, ctx=None) -> Stage:
        return Stage("nat",
                     NatState(**{k: state[k] for k in NatState._fields}),
                     NatConsts(nat_ip=self.nat_ip, capacity=self.capacity,
                               base_port=self.base_port,
                               max_exp=self.max_exp))

    def next_state(self, state, new: NatState) -> dict:
        return new._asdict()

    def cycles_of(self, state) -> float:
        return CYCLES
