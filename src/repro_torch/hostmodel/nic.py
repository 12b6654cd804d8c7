"""Copy of ``repro.hostmodel.nic``, reading the port's ``LinkTelemetry``.

NIC/DMA stage: what the NF server's NIC actually moves over PCIe
(DESIGN.md §7).

The input is the switch-side per-link telemetry
(``switchsim.telemetry.LinkTelemetry``, per pipe = per server under
§6.3.2 steering); the output is exact DMA byte/packet accounting for both
bus directions:

  * **RX** (switch -> server): every packet the switch forwards is DMA'd
    into host memory — *header-only* (42 B + 7 B PP header + un-parked
    tail) for parked packets, the *full packet* (+7 B) for ENB=0 traffic.
    That is exactly ``telemetry.to_server_*``: the post-Split wire bytes.
  * **TX** (server -> switch): what the NF chain sends back
    (``telemetry.from_server_*`` — chain survivors, still header-only
    when parked).

The no-parking **baseline** for the same offered traffic DMAs the full
packet both ways: RX = every offered packet whole (``wire_*``), TX = the
chain survivors at full size (``merged_*`` — the same drop-aware
convention as ``engine.goodput_gain``; a baseline deployment drops the
same packets server-side and never returns them).

``pcie_reduction`` is the headline: 1 - parked/baseline bus bytes,
TLP + descriptor overheads included.  Because the per-packet overheads do
NOT shrink (the same number of packets crosses the bus), the reduction is
strictly below the raw link-byte saving — which is what keeps it inside
the paper's 2-58% band instead of the ~60% byte saving at 256 B.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hostmodel.pcie import PcieLink
from repro_torch.switchsim.telemetry import LinkTelemetry


@dataclasses.dataclass(frozen=True)
class DmaLoad:
    """Exact DMA accounting for one server's PCIe bus, both directions.

    ``*_bytes`` are packet data bytes DMA'd; ``*_bus_bytes`` add the
    per-TLP and per-descriptor overheads of ``PcieLink``.
    """

    rx_pkts: int
    rx_bytes: int
    rx_bus_bytes: int
    tx_pkts: int
    tx_bytes: int
    tx_bus_bytes: int

    @property
    def data_bytes(self) -> int:
        return self.rx_bytes + self.tx_bytes

    @property
    def bus_bytes(self) -> int:
        """Total bus bytes, both directions summed — the paper's 'PCIe
        bus load' unit (Fig. 9 reports utilization of the whole bus)."""
        return self.rx_bus_bytes + self.tx_bus_bytes

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)


def _load(link: PcieLink, rx_pkts: int, rx_bytes: int,
          tx_pkts: int, tx_bytes: int) -> DmaLoad:
    return DmaLoad(
        rx_pkts=rx_pkts, rx_bytes=rx_bytes,
        rx_bus_bytes=link.bus_bytes(rx_pkts, rx_bytes),
        tx_pkts=tx_pkts, tx_bytes=tx_bytes,
        tx_bus_bytes=link.bus_bytes(tx_pkts, tx_bytes),
    )


def parked_dma(link: PcieLink, tel: LinkTelemetry) -> DmaLoad:
    """DMA load with PayloadPark: header-only for parked packets, full
    packet for ENB=0 — the telemetry's server-link directions verbatim."""
    return _load(link, tel.to_server_pkts, tel.to_server_bytes,
                 tel.from_server_pkts, tel.from_server_bytes)


def baseline_dma(link: PcieLink, tel: LinkTelemetry) -> DmaLoad:
    """DMA load of a no-parking deployment of the same chain on the same
    offered traffic: full packets in, full-size survivors out."""
    return _load(link, tel.wire_pkts, tel.wire_bytes,
                 tel.merged_pkts, tel.merged_bytes)


def pcie_reduction(link: PcieLink, tel: LinkTelemetry) -> float:
    """Fractional PCIe bus-load reduction vs the no-parking baseline
    (the abstract's 2-58% claim; positive = PayloadPark relieves the bus)."""
    base = baseline_dma(link, tel).bus_bytes
    if base == 0:
        return 0.0
    return 1.0 - parked_dma(link, tel).bus_bytes / base
