"""Per-link byte/packet telemetry for the switch<->server wire.

A copy of ``repro.switchsim.telemetry`` (pure Python, no arrays), kept in
the port so the port imports nothing of the reference.  ``LinkTelemetry``
holds exact int totals for every link a packet can traverse in one pipe:
``wire`` (generator -> switch), ``to_server`` (post-Split), ``from_server``
(returning NF-chain survivors), ``recirc`` (the recirculation port) and
``merged`` (switch egress).  The engine tallies them per step on the
device; ``simulate_loop`` mirrors the same accumulation points.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkTelemetry:
    """Exact per-link totals for one pipe (or the cross-pipe sum).

    All fields are plain ints; ``bytes`` count on-wire bytes of alive
    packets (42B header + optional 7B PP header + payload), ``pkts`` count
    alive packets, at the same accumulation point.
    """

    wire_pkts: int = 0
    wire_bytes: int = 0
    to_server_pkts: int = 0
    to_server_bytes: int = 0
    from_server_pkts: int = 0
    from_server_bytes: int = 0
    recirc_pkts: int = 0
    recirc_bytes: int = 0
    merged_pkts: int = 0
    merged_bytes: int = 0

    @property
    def srv_bytes(self) -> int:
        """Server-link bytes, both directions (the goodput denominator)."""
        return self.to_server_bytes + self.from_server_bytes

    @property
    def srv_pkts(self) -> int:
        return self.to_server_pkts + self.from_server_pkts

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)

    def __add__(self, other: "LinkTelemetry") -> "LinkTelemetry":
        if not isinstance(other, LinkTelemetry):
            return NotImplemented
        return LinkTelemetry(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(LinkTelemetry)})


# Field names in declaration order — the single source of truth for the
# engine's ys keys and the loop mirrors' accumulator keys.
TEL_FIELDS = tuple(f.name for f in dataclasses.fields(LinkTelemetry))


def sum_telemetry(parts) -> LinkTelemetry:
    """Cross-pipe aggregation: the ToR-level totals of per-server links."""
    total = LinkTelemetry()
    for p in parts:
        total = total + p
    return total
