"""Copy of ``repro.hostmodel.server``, reading the port's ``LinkTelemetry``
and resource model.

Per-server cycle budget: NF compute + data movement bound server pps
(DESIGN.md §7).

NFSlicer and "Benchmarking NFV Software Dataplanes" (PAPERS.md) both show
that for shallow NFs the *per-packet host cost* — DMA, descriptor
handling, cache fills — bounds throughput at least as often as NF cycles
do.  ``HostModel`` therefore charges each packet:

    cycles = slowest-NF cycles (OpenNetVM pins one NF per core, §6.1)
           + fixed DPDK/framework overhead
           + cycles_per_byte x bytes touched (RX + TX DMA'd bytes)

and bounds server-side pps by the minimum of four capacities: CPU,
PCIe RX byte rate, PCIe TX byte rate (full duplex, each direction owns
``PcieLink.effective_gbps``), and the NIC's DMA transaction rate.

Parking helps through the ``cycles_per_byte`` and PCIe terms: header-only
packets touch ~103 B instead of e.g. 512 B, so the same core budget
yields more pps — the end-host half of the paper's goodput story.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.hostmodel.nic import (baseline_dma, parked_dma,
                                       pcie_reduction)
from repro_torch.hostmodel.pcie import PcieLink
from repro_torch.switchsim.telemetry import LinkTelemetry


@dataclasses.dataclass(frozen=True)
class HostModel:
    """One NF server behind one switch pipe (§6.3.2: pipe == server)."""

    link: PcieLink = PcieLink()
    cpu_ghz: float = 2.3           # Xeon E7-4870 v2 (§6.1)
    cores_per_nf: int = 1          # OpenNetVM pins each NF to one core
    overhead_cycles: float = 60.0  # DPDK rx/tx + framework per packet
    cycles_per_byte: float = 0.2   # data-movement cost (DMA/LLC, NFSlicer)
    dma_txn_mpps: float = 31.5     # NIC DMA transaction cap (§6.2.2)

    def __post_init__(self):
        if self.cpu_ghz <= 0 or self.cores_per_nf < 1:
            raise ValueError("cpu_ghz must be > 0 and cores_per_nf >= 1")
        if min(self.overhead_cycles, self.cycles_per_byte,
               self.dma_txn_mpps) < 0:
            raise ValueError("per-packet costs must be non-negative")


def _slowest_nf(nf_cycles) -> float:
    if isinstance(nf_cycles, (int, float)):
        return float(nf_cycles)
    return max(float(c) for c in nf_cycles)


def cycles_per_packet(hm: HostModel, nf_cycles,
                      touched_bytes: float) -> float:
    """Per-packet cycle budget: slowest NF + framework + data movement."""
    return (_slowest_nf(nf_cycles) + hm.overhead_cycles
            + hm.cycles_per_byte * max(touched_bytes, 0.0))


@dataclasses.dataclass(frozen=True)
class ServerBound:
    """Server-side pps bound and the resource that sets it."""

    pps: float
    bottleneck: str              # 'cpu' | 'pcie_rx' | 'pcie_tx' | 'dma_txn'
    cycles_per_pkt: float
    caps: dict = dataclasses.field(default_factory=dict)


def server_bound_pps(hm: HostModel, nf_cycles,
                     rx_bytes_per_pkt: float,
                     tx_bytes_per_pkt: float) -> ServerBound:
    """Max packets/s one server sustains at the given per-packet DMA sizes.

    ``rx_bytes_per_pkt``/``tx_bytes_per_pkt`` are mean *data* bytes per
    packet per direction (e.g. ``DmaLoad.rx_bytes / rx_pkts``); the PCIe
    terms add TLP/descriptor overheads via ``PcieLink.mean_bus_bytes``.
    """
    cyc = cycles_per_packet(hm, nf_cycles,
                            rx_bytes_per_pkt + tx_bytes_per_pkt)
    byte_rate = hm.link.effective_gbps * 1e9 / 8  # bytes/s per direction
    caps = {"cpu": hm.cores_per_nf * hm.cpu_ghz * 1e9 / cyc,
            "dma_txn": hm.dma_txn_mpps * 1e6}
    rx_bus = hm.link.mean_bus_bytes(rx_bytes_per_pkt)
    tx_bus = hm.link.mean_bus_bytes(tx_bytes_per_pkt)
    if rx_bus > 0:
        caps["pcie_rx"] = byte_rate / rx_bus
    if tx_bus > 0:
        caps["pcie_tx"] = byte_rate / tx_bus
    bottleneck = min(caps, key=caps.get)
    return ServerBound(pps=caps[bottleneck], bottleneck=bottleneck,
                       cycles_per_pkt=cyc, caps=caps)


def server_report(hm: HostModel, tel: LinkTelemetry, nf_cycles) -> dict:
    """Full host-side accounting for one server's measured telemetry.

    Combines the NIC/DMA byte accounting (parked vs drop-aware baseline)
    with the cycle-budget pps bounds of both deployments.  ``nf_cycles``
    is ``Chain.cycle_costs()`` (or any scalar/sequence of per-NF costs).
    """
    parked = parked_dma(hm.link, tel)
    base = baseline_dma(hm.link, tel)

    def mean(nbytes, pkts):
        return nbytes / pkts if pkts else 0.0

    bound_park = server_bound_pps(
        hm, nf_cycles,
        mean(parked.rx_bytes, parked.rx_pkts),
        mean(parked.tx_bytes, parked.tx_pkts))
    bound_base = server_bound_pps(
        hm, nf_cycles,
        mean(base.rx_bytes, base.rx_pkts),
        mean(base.tx_bytes, base.tx_pkts))
    return dict(
        pcie_reduction=pcie_reduction(hm.link, tel),
        parked_bus_bytes=parked.bus_bytes,
        baseline_bus_bytes=base.bus_bytes,
        parked=parked.as_dict(),
        baseline=base.as_dict(),
        server_pps_parked=bound_park.pps,
        server_pps_baseline=bound_base.pps,
        server_pps_gain=(bound_park.pps / bound_base.pps - 1.0
                         if bound_base.pps else 0.0),
        bottleneck_parked=bound_park.bottleneck,
        bottleneck_baseline=bound_base.bottleneck,
    )


# -------------------------------------------------------------------------
# Multi-server table slicing (§6.2.3 / §6.3.2)
# -------------------------------------------------------------------------

PIPES_PER_CHIP = 4  # Tofino-generation pipe count (resources.py, Table 1)


def servers_per_pipe(n_servers: int) -> int:
    """How many NF servers share one pipe's MAU when ``n_servers`` hang
    off one chip: servers fill the chip's pipes round-robin (§6.3.2 —
    8 servers on 4 pipes means 2 per pipe, Table 1's second row)."""
    if n_servers < 1:
        raise ValueError(f"n_servers must be >= 1, got {n_servers}")
    return math.ceil(n_servers / PIPES_PER_CHIP)


def per_server_capacity(frac: float, cfg, n_servers: int) -> int:
    """Lookup-table slots each of ``n_servers`` gets from ``frac`` of a
    pipe's SRAM — the §6.2.3 static slicing, delegated to the placement
    model (``resources._placement`` via ``capacity_for_memory_fraction``)
    so block rounding and per-slice replication match Table 1 exactly."""
    from repro_torch.switchsim import resources
    return resources.capacity_for_memory_fraction(
        frac, cfg, nf_servers=servers_per_pipe(n_servers))
