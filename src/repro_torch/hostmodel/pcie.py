"""Copy of ``repro.hostmodel.pcie`` (pure Python), kept in the port so the
port imports nothing of the reference.

PCIe link model: generation/width -> effective GB/s, with per-packet
TLP and DMA-descriptor overheads (DESIGN.md §7).

The paper measures PCIe relief indirectly ("PayloadPark reduces PCIe bus
load by 2-58%", abstract; §6.2.2 quotes NIC limits) but never models the
bus.  This module does, following pcie-bench (Neugebauer et al.,
SIGCOMM'18 — the paper's own reference for NIC/DMA limits):

  * **Raw rate** = per-lane transfer rate x lane count
    (Gen3 8 GT/s, Gen4 16 GT/s, ...).
  * **Encoding** takes its cut first: 8b/10b for Gen1/2 (80%),
    128b/130b from Gen3 on (~98.5%).  Gen3 x8 lands at ~63 Gbps — the
    *byte-rate ceiling* per direction (PCIe is full duplex).
  * **TLP overhead**: DMA engines move data in Transaction Layer Packets
    of at most ``max_payload`` bytes (MPS, typically 256 B); every TLP
    pays ~24 B of framing + header + LCRC.  A 1492 B packet takes 6 TLPs
    (144 B overhead); a 103 B PayloadPark header packet takes 1.
  * **Descriptor overhead**: each packet additionally costs a DMA
    descriptor fetch (read request + completion carrying the descriptor)
    and a completion/writeback — modelled as two ``desc_bytes`` transfers
    with their own TLP headers.

This is why small packets hurt: at 103 B the bus moves ~2x the packet's
bytes, which reproduces the paper's §6.2.2 observation that "a modern NIC
with DPDK driver cannot operate at 40 Gbps for packets smaller than ~170
bytes" without any fitted constant.
"""
from __future__ import annotations

import dataclasses
import math

# Per-lane transfer rate (GT/s) and encoding efficiency per generation.
_GEN_GTPS = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0}
_GEN_ENCODING = {1: 0.8, 2: 0.8, 3: 128 / 130, 4: 128 / 130, 5: 128 / 130}
_VALID_LANES = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class PcieLink:
    """One PCIe endpoint link (the NF server's NIC slot).

    Defaults model the paper's testbed class: Gen3 x8 (~63 Gbps effective
    byte rate per direction), 256 B Max_Payload_Size, 24 B per-TLP
    overhead (framing 2+2 B, 3-DW header with 64-bit addressing 12-16 B,
    LCRC 4 B), 16 B DMA descriptors.
    """

    gen: int = 3
    lanes: int = 8
    max_payload: int = 256   # TLP Max_Payload_Size (bytes)
    tlp_overhead: int = 24   # framing + header + LCRC per TLP (bytes)
    desc_bytes: int = 16     # one DMA descriptor (bytes)

    def __post_init__(self):
        if self.gen not in _GEN_GTPS:
            raise ValueError(
                f"gen must be one of {sorted(_GEN_GTPS)}, got {self.gen}")
        if self.lanes not in _VALID_LANES:
            raise ValueError(
                f"lanes must be one of {_VALID_LANES}, got {self.lanes}")
        if self.max_payload < 64:
            raise ValueError(
                f"max_payload must be >= 64, got {self.max_payload}")
        if self.tlp_overhead < 0 or self.desc_bytes < 0:
            raise ValueError("overheads must be non-negative")

    @property
    def raw_gbps(self) -> float:
        """Signalling rate x lanes, before encoding."""
        return _GEN_GTPS[self.gen] * self.lanes

    @property
    def effective_gbps(self) -> float:
        """Byte-rate ceiling per direction, after line encoding."""
        return self.raw_gbps * _GEN_ENCODING[self.gen]

    def data_tlps(self, nbytes: int) -> int:
        """TLPs needed to move ``nbytes`` of packet data (0 for none)."""
        if nbytes <= 0:
            return 0
        return math.ceil(nbytes / self.max_payload)

    def pkt_overhead_bytes(self, nbytes: int) -> int:
        """Bus overhead one ``nbytes`` packet pays beyond its own bytes:
        TLP headers for the data transfer plus descriptor fetch +
        completion writeback (each a ``desc_bytes`` transfer with its own
        TLP header)."""
        if nbytes <= 0:
            return 0
        return (self.data_tlps(nbytes) * self.tlp_overhead
                + 2 * (self.desc_bytes + self.tlp_overhead))

    def dma_bus_bytes(self, nbytes: int) -> int:
        """Total bus bytes one packet of ``nbytes`` costs in its direction."""
        if nbytes <= 0:
            return 0
        return nbytes + self.pkt_overhead_bytes(nbytes)

    def bus_bytes(self, pkts: int, data_bytes: int) -> int:
        """Aggregate bus bytes for ``pkts`` packets totalling ``data_bytes``.

        Per-packet overheads are charged at the *mean* packet size
        (``ceil(mean / max_payload)`` TLPs each) — exact for fixed-size
        workloads, a recorded approximation for mixed ones (DESIGN.md §7
        deviations): the switch-side telemetry carries totals, not the
        server NIC's TLP segmentation.
        """
        if pkts <= 0 or data_bytes <= 0:
            return 0
        mean = data_bytes / pkts
        return data_bytes + pkts * self.pkt_overhead_bytes(math.ceil(mean))

    def mean_bus_bytes(self, mean_pkt_bytes: float) -> float:
        """Bus bytes per packet at a (possibly fractional) mean size."""
        if mean_pkt_bytes <= 0:
            return 0.0
        return mean_pkt_bytes + self.pkt_overhead_bytes(
            math.ceil(mean_pkt_bytes))

    def data_gbps_at(self, pkt_bytes: int) -> float:
        """Packet-data throughput ceiling at a fixed packet size — the
        pcie-bench 'effective bandwidth' curve."""
        bus = self.dma_bus_bytes(pkt_bytes)
        if bus == 0:
            return 0.0
        return self.effective_gbps * pkt_bytes / bus
