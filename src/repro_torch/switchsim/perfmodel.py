"""Analytic link / PCIe / NF-server performance model (a copy of
``repro.switchsim.perfmodel``, pure Python, kept in the port so the port
imports nothing of the reference).

Calibrated against the paper's own measurements so the benchmark suite can
reproduce its figures quantitatively:

  * Goodput is measured "from the RMT switch's perspective ... the packet
    header as the unit of useful information" (§6.1): 42 bytes per delivered
    packet.  10 Mpps == 3.36 Gbps goodput.
  * PCIe/NIC model (from §6.2.2 + Neugebauer et al. pcie-bench): the NF
    server's NIC is limited by BOTH an effective byte rate (~50 Gbps on
    PCIe Gen3 x8) AND a DMA transaction rate of ~31.5 Mpps — the paper's own
    numbers: "26 Gbps accommodates 31 million 103 byte packets" and "a modern
    NIC with DPDK driver cannot operate at 40 Gbps for packets smaller than
    170 bytes".
  * NF server compute: pps_max = cores * freq / cycles_per_packet, with the
    per-chain cycle costs from nf/*.py (§6.3.3 NF-Light/Medium/Heavy = 50/
    300/570 cycles).
  * Latency: fixed base (wire + switch + DPDK) plus an M/D/1 queueing term on
    the bottleneck resource; the paper's Fig. 7 latency cliff at link
    saturation emerges from the queueing term.
  * Healthy operation = drop rate < 0.1 % (§6.1); peak goodput is the largest
    send rate that stays healthy AND premature-eviction free (§6.3.1).

All rates are bits/second; sizes are bytes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.packet import HDR_BYTES, PP_HDR_BYTES

GOODPUT_BYTES = HDR_BYTES  # 42-byte header = useful information (§6.1)


@dataclasses.dataclass(frozen=True)
class ServerModel:
    link_gbps: float = 40.0          # switch <-> NF server NIC
    pcie_gbps: float = 50.0          # effective PCIe Gen3 x8 byte rate
    pcie_mpps: float = 31.5          # DMA transaction rate cap
    cpu_ghz: float = 2.3             # Xeon E7-4870 v2 (§6.1)
    cores_per_nf: int = 1            # OpenNetVM pins each NF to one core
    overhead_cycles: float = 60.0    # DPDK rx/tx + framework per packet
    framework_mpps: float = 17.5     # ONVM manager rx/tx core packet cap
    base_latency_us: float = 28.0    # wire + switch + DPDK baseline (Fig. 7)
    recirc_latency_us: float = 0.05  # one extra pipeline traversal (§6.2.5)


@dataclasses.dataclass(frozen=True)
class TrafficDigest:
    """Per-workload aggregates the analytic model needs.

    ``mean_wire_bytes``: average bytes/packet on the generator->switch link.
    ``mean_srv_bytes``:  average bytes/packet on the switch->server link
                          (equals wire bytes in baseline; reduced by parking).
    ``park_fraction``:   fraction of packets parked (ENB=1).
    ``recirc_per_pkt``:  expected recirculation passes per packet (§6.2.5);
                          0 without recirculation.  Feeds the per-packet
                          expected-passes latency term in ``evaluate``.
    """

    mean_wire_bytes: float
    mean_srv_bytes: float
    park_fraction: float
    recirc_per_pkt: float = 0.0


def digest(sizes, probs, park_bytes: int, min_park_len: int,
           parking: bool, pass_bytes: int | None = None) -> TrafficDigest:
    """Compute the per-packet byte averages for a size distribution.

    ``pass_bytes`` models recirculation (§6.2.5): one pipeline traversal
    parks at most ``pass_bytes``; a packet whose parked share exceeds it
    takes one recirculation pass to fill the remaining row width (the
    engine's single-recirculation model, DESIGN.md §6)."""
    mean_wire = float(sum(s * p for s, p in zip(sizes, probs)))
    if not parking:
        return TrafficDigest(mean_wire, mean_wire, 0.0)
    srv = 0.0
    park_frac = 0.0
    recirc = 0.0
    for s, p in zip(sizes, probs):
        payload = s - HDR_BYTES
        if payload >= min_park_len:
            parked = min(payload, park_bytes)
            srv += p * (s - parked + PP_HDR_BYTES)
            park_frac += p
            if pass_bytes is not None and parked > pass_bytes:
                recirc += p
        else:
            srv += p * (s + PP_HDR_BYTES)
    return TrafficDigest(mean_wire, srv, park_frac, recirc)


def measured_digest(n_pkts: int, wire_bytes: int, srv_fwd_bytes: int,
                    park_fraction: float,
                    recirc_per_pkt: float = 0.0) -> TrafficDigest:
    """TrafficDigest from the scanned engine's measured byte totals.

    ``srv_fwd_bytes`` is the engine's switch->server direction alone
    (``EngineResult.srv_fwd_bytes``).  That is the bottleneck direction:
    every offered packet crosses it, while the return direction carries only
    NF-chain survivors — averaging both directions would understate the
    forward load whenever the chain drops packets.  This closes the loop
    between the stateful simulation and the analytic model: feed the
    measured digest to ``evaluate``/``peak_goodput`` to predict rates for
    the traffic actually simulated, hash skew, eviction losses and all.
    ``recirc_per_pkt`` is the measured rate ``counters['recirculations'] /
    packets`` when the engine ran with the recirculation lane.
    """
    n = max(n_pkts, 1)
    return TrafficDigest(
        mean_wire_bytes=wire_bytes / n,
        mean_srv_bytes=srv_fwd_bytes / n,
        park_fraction=park_fraction,
        recirc_per_pkt=recirc_per_pkt,
    )


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    send_gbps: float
    pps: float
    goodput_gbps: float
    latency_us: float
    drop_rate: float
    pcie_gbps_used: float
    bottleneck: str
    util: float


def evaluate(m: ServerModel, d: TrafficDigest, nf_cycles,
             send_gbps: float) -> OperatingPoint:
    """Evaluate one send rate; drops appear when any resource saturates.

    ``nf_cycles``: per-NF per-packet CPU cycle costs.  OpenNetVM pins each NF
    to a core, so the chain's CPU cap is the slowest single NF (§6.1)."""
    if isinstance(nf_cycles, (int, float)):
        nf_cycles = [float(nf_cycles)]
    pps_offered = send_gbps * 1e9 / (d.mean_wire_bytes * 8)

    # Resource capacities in packets/second.
    slowest_nf = max(nf_cycles) + m.overhead_cycles
    cap = {
        "link": m.link_gbps * 1e9 / (d.mean_srv_bytes * 8),
        "pcie_bytes": m.pcie_gbps * 1e9 / (d.mean_srv_bytes * 8),
        "pcie_txn": m.pcie_mpps * 1e6,
        "cpu": m.cores_per_nf * m.cpu_ghz * 1e9 / slowest_nf,
        "framework": m.framework_mpps * 1e6,
    }
    bottleneck = min(cap, key=cap.get)
    pps_cap = cap[bottleneck]

    pps_delivered = min(pps_offered, pps_cap)
    drop_rate = max(0.0, 1.0 - pps_delivered / max(pps_offered, 1e-9))
    goodput = pps_delivered * GOODPUT_BYTES * 8 / 1e9

    # M/D/1 queueing on the bottleneck; saturate gracefully near rho=1.
    rho = min(pps_offered / pps_cap, 0.999999)
    service_us = 1e6 / pps_cap
    queue_us = rho / (2.0 * (1.0 - rho)) * service_us
    queue_us = min(queue_us, 2000.0)  # queue bound ~ buffer-limited
    latency = m.base_latency_us + queue_us
    # Recirculation: each pass is one extra traversal of the ingress
    # pipeline.  Expected-passes term (analytic from digest(), or measured
    # from the engine's recirculations counter) replaces the old flat
    # constant that charged every workload the same penalty.
    latency += m.recirc_latency_us * d.recirc_per_pkt

    pcie_used = pps_delivered * d.mean_srv_bytes * 8 / 1e9
    return OperatingPoint(send_gbps, pps_delivered, goodput, latency,
                          drop_rate, pcie_used, bottleneck, rho)


def peak_goodput(m: ServerModel, d: TrafficDigest, nf_cycles,
                 table_capacity: int = 0, max_exp: int = 1,
                 nf_latency_us: float = 30.0, parking: bool = False,
                 healthy_drop: float = 0.001) -> OperatingPoint:
    """Largest send rate with drop rate < 0.1 % and no premature evictions.

    The premature-eviction constraint (§4, §6.3.1): a parked payload survives
    ``max_exp`` full wraps of the circular table index, i.e. for
    ``max_exp * M / pps_parked`` seconds; it must exceed the split->merge
    time-delta (~NF latency):  M * EXP >= pps_parked * T_delta.
    """
    lo, hi = 0.01, 200.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        op = evaluate(m, d, nf_cycles, mid)
        healthy = op.drop_rate <= healthy_drop
        if parking and table_capacity > 0 and d.park_fraction > 0:
            pps_parked = op.pps * d.park_fraction
            survive_us = max_exp * table_capacity / pps_parked * 1e6
            healthy &= survive_us >= nf_latency_us
        if healthy:
            lo = mid
        else:
            hi = mid
    return evaluate(m, d, nf_cycles, lo)


@dataclasses.dataclass(frozen=True)
class HostOperatingPoint:
    """An ``OperatingPoint`` augmented with the host model's view
    (DESIGN.md §7): predicted PCIe load per direction with TLP/descriptor
    overheads, bus utilization, and the server-side pps bound from the
    per-server cycle budget."""

    op: OperatingPoint
    pcie_rx_gbps: float     # switch->server bus load incl. DMA overheads
    pcie_tx_gbps: float     # server->switch bus load incl. DMA overheads
    pcie_util: float        # busiest direction / effective link rate
    server_pps_cap: float   # cycle-budget + PCIe + DMA-txn bound
    server_bottleneck: str  # 'cpu' | 'pcie_rx' | 'pcie_tx' | 'dma_txn'


def evaluate_host(m: ServerModel, d: TrafficDigest, nf_cycles,
                  send_gbps: float, host=None) -> HostOperatingPoint:
    """``evaluate`` plus the host model: PCIe bus load and server-bound
    throughput for the same digest (DESIGN.md §7).

    The analytic digest carries one server-link mean (``mean_srv_bytes``),
    used for both directions — exact without chain drops, an upper bound
    on the return direction with them.  The delivered pps is additionally
    clamped by the host model's cycle-budget bound, which may be tighter
    than ``ServerModel``'s flat caps for byte-heavy traffic.
    """
    from repro_torch.hostmodel.server import HostModel, server_bound_pps
    host = host if host is not None else HostModel()
    op = evaluate(m, d, nf_cycles, send_gbps)
    bound = server_bound_pps(host, nf_cycles,
                             d.mean_srv_bytes, d.mean_srv_bytes)
    pps = min(op.pps, bound.pps)
    bus_per_pkt = host.link.mean_bus_bytes(d.mean_srv_bytes)
    rx_gbps = pps * bus_per_pkt * 8 / 1e9
    tx_gbps = rx_gbps  # symmetric under the one-mean digest
    util = max(rx_gbps, tx_gbps) / host.link.effective_gbps
    return HostOperatingPoint(
        op=op, pcie_rx_gbps=rx_gbps, pcie_tx_gbps=tx_gbps, pcie_util=util,
        server_pps_cap=bound.pps, server_bottleneck=bound.bottleneck)


def scale_pipes(op: OperatingPoint, pipes: int) -> OperatingPoint:
    """Aggregate operating point for ``pipes`` independent per-port pipes.

    The paper services up to 8 NF servers from one ToR switch, one pipe per
    server-facing port (§6.3.2); pipes share no switch state and each feeds
    its own server/link, so throughput-like quantities scale linearly while
    per-packet latency, drop rate and utilization are unchanged.
    """
    return dataclasses.replace(
        op,
        send_gbps=op.send_gbps * pipes,
        pps=op.pps * pipes,
        goodput_gbps=op.goodput_gbps * pipes,
        pcie_gbps_used=op.pcie_gbps_used * pipes,
    )
