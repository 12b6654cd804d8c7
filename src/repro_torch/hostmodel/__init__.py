"""Port of ``repro.hostmodel`` (pure Python copies).

NF-server host model: PCIe link + NIC/DMA + per-server cycle budget.

Closes the loop on the abstract's end-host claim ("reduces PCIe bus load
by 2-58%"): the switch-side engine produces per-link telemetry
(``switchsim.telemetry``), this package turns it into PCIe bus load, DMA
byte accounting and server-bound throughput (DESIGN.md §7).
"""
from repro_torch.hostmodel.nic import (DmaLoad, baseline_dma, parked_dma,
                                       pcie_reduction)
from repro_torch.hostmodel.pcie import PcieLink
from repro_torch.hostmodel.server import (HostModel, ServerBound,
                                          cycles_per_packet,
                                          per_server_capacity,
                                          server_bound_pps, server_report,
                                          servers_per_pipe)

__all__ = [
    "DmaLoad", "baseline_dma", "parked_dma", "pcie_reduction",
    "PcieLink", "HostModel", "ServerBound", "cycles_per_packet",
    "per_server_capacity", "server_bound_pps", "server_report",
    "servers_per_pipe",
]
