"""NAT NF, modelled on MazuNAT (port of ``repro.nf.nat``, paper §6.1).

Stateful source-NAT with bounded resources: the first packet of a flow
(src_ip, src_port) claims a slot in a linear-probed hash table and maps to
the external port owned by that slot (``base_port + slot``).  Mappings
expire EXP-style; a flow that finds neither its mapping nor a free slot
ages every slot of its probe window (CLOCK).  A flow that returns after
its slot aged out is counted ``nat_stale_hits``, dropped, and its binding
torn down.

Inserts run packet by packet in arrival order (two packets of one flow in
one batch must get the same mapping), as a Python loop of tensor ops over
all pipes at once.  Each packet reads and writes only its ``PROBE_DEPTH``
probe slots, which are distinct (capacity >= PROBE_DEPTH), so one gather
and one scatter of the packed (key_ip, key_port, exp) rows cover it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.packet import PacketBatch
from repro_torch.device import DEFAULT_DEVICE, resolve_device

PROBE_DEPTH = 8
CYCLES = 80.0


def _hash(ip: torch.Tensor, port: torch.Tensor, capacity: int) -> torch.Tensor:
    """int32 avalanche mix of the flow key; multiplies wrap like uint32,
    ``>>`` is arithmetic.  Constants are the murmur3 finalizer multipliers
    as signed int32 (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)."""
    h = ip.to(torch.int32) ^ -1640531527
    h = (h * -2048144789) ^ port.to(torch.int32)
    h = h ^ (h >> 13)
    h = h * -1028477379
    return torch.remainder(h & 0x7FFFFFFF, capacity)


@dataclasses.dataclass(frozen=True)
class Nat:
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

    def __call__(self, state, pkts: PacketBatch, backend=None, ctx=None):
        # header-only table logic; no registry primitive applies, but the
        # chain threads ``backend``/``ctx`` uniformly through every NF
        cap, depth = self.capacity, PROBE_DEPTH
        dev = pkts.device
        ar = torch.arange(depth, device=dev)
        h = _hash(pkts.src_ip, pkts.src_port, cap)
        probe = torch.remainder(h[..., None] + ar, cap).to(torch.int64)
        table = torch.stack(
            [state["key_ip"], state["key_port"], state["exp"]], dim=-1)

        def first(cond):
            """Probe position of the first True, ``depth`` if none."""
            return torch.where(cond, ar, depth).amin(dim=-1)

        mapped_l, stale_l = [], []
        for i in range(pkts.batch_size):
            pidx = probe[..., i, :]
            gi = pidx[..., None].expand(pidx.shape + (3,))
            kip, kport, ex = torch.gather(table, -2, gi).unbind(-1)
            ip = pkts.src_ip[..., i, None]
            port = pkts.src_port[..., i, None]
            alive = pkts.alive[..., i]
            live = ex > 0
            match = (kip == ip) & (kport == port)
            p_slot, p_stale, p_free = (first(live & match),
                                       first(~live & match), first(~live))
            found = p_slot < depth
            hit = alive & found
            # the flow's mapping aged out while it was still sending: the
            # slot's port may be re-issued already, so count, drop and
            # tear the dead binding down
            stale_hit = alive & ~found & (p_stale < depth)
            can_insert = alive & ~found & ~stale_hit & (p_free < depth)
            exhausted = alive & ~found & (p_free >= depth)
            p_w = torch.where(hit, p_slot,
                              torch.where(stale_hit, p_stale, p_free))
            at_w = (ar == p_w[..., None]) & \
                (hit | stale_hit | can_insert)[..., None]
            ci, sh = can_insert[..., None], stale_hit[..., None]
            new_ip = torch.where(at_w, torch.where(
                ci, ip, torch.where(sh, -1, kip)), kip)
            new_port = torch.where(at_w, torch.where(
                ci, port, torch.where(sh, -1, kport)), kport)
            # use refreshes the expiry; CLOCK ages the whole window when a
            # flow found neither its mapping nor a free slot
            new_ex = torch.where(at_w & ~sh, self.max_exp, ex)
            new_ex = torch.where(exhausted[..., None],
                                 torch.clamp(ex - 1, min=0), new_ex)
            table.scatter_(-2, gi, torch.stack(
                [new_ip, new_port, new_ex], dim=-1).to(torch.int32))
            slot = torch.gather(pidx, -1,
                                p_w.clamp(max=depth - 1)[..., None])[..., 0]
            mapped_l.append(torch.where(hit | can_insert,
                                        self.base_port + slot, -1))
            stale_l.append(stale_hit)

        if mapped_l:
            mapped = torch.stack(mapped_l, dim=-1).to(torch.int32)
            stale_hit = torch.stack(stale_l, dim=-1)
        else:
            mapped = torch.full_like(pkts.src_port, -1)
            stale_hit = torch.zeros_like(pkts.alive)
        ok = pkts.alive & (mapped >= 0)
        drop = pkts.alive & (mapped < 0)
        out = pkts.replace(
            src_ip=torch.where(ok, self.nat_ip, pkts.src_ip).to(torch.int32),
            src_port=torch.where(ok, mapped, pkts.src_port),
            alive=pkts.alive & ~drop,
        )
        key_ip, key_port, exp = table.unbind(-1)
        new_state = dict(
            key_ip=key_ip, key_port=key_port, exp=exp,
            stale_hits=(state["stale_hits"]
                        + stale_hit.sum(-1)).to(torch.int32))
        return new_state, out, drop, CYCLES
