"""Declarative scenario specs and the grid expander (port of
``repro.scenarios.spec``; DESIGN.md §8).

A ``ScenarioSpec`` names one point of the evaluation matrix: workload x
NF chain x recirculation mode x pipes x table occupancy x trace geometry.
It is a frozen, hashable value, so specs can be grouped, deduplicated and
used as batching keys.  Everything runnable (packets, chains, ParkConfigs)
is derived from the spec by the pure functions of this module; the runner
(``repro_torch.scenarios.runner``) is the only place that executes
anything.

Workloads are named tuples (``("fixed", 512)``, ``("enterprise",)``,
``("datacenter",)``) resolved by ``resolve_workload``; chains are tuples of
NF names (``("fw", "nat", "lb")``) resolved by ``build_chain``.  With
``flows > 0`` the firewall's blocked list comes from the deterministic
flow pool, so the chain is the same across workload axes and those points
batch into one ``run_pipes`` call.

Traffic is drawn from ``torch.Generator``s on the CPU, so one seed gives
the same packets whatever device the run then uses (and not the
reference's ``jax.random`` packets).
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.backend.config import BackendConfig, as_config
from repro_torch.core.packet import PacketBatch, map_fields, to_time_major
from repro_torch.core.park import ParkConfig
from repro_torch.nf.chain import Chain
from repro_torch.nf.firewall import Firewall
from repro_torch.nf.macswap import MacSwap
from repro_torch.nf.maglev import MaglevLB
from repro_torch.nf.nat import Nat
from repro_torch.switchsim.engine import recirc_slots
from repro_torch.switchsim.faults import NO_FAULT, FaultSpec
from repro_torch.traffic import generator as T

# ("fixed", size) | ("enterprise",) | ("datacenter",)
# | ("adversarial", base, attack_fraction, burst)   (DESIGN.md §10)
# | ("churn", pool, rotate)
WorkloadSpec = tuple
ChainSpec = tuple     # e.g. ("fw", "nat", "lb"); names below

_NF_NAMES = ("fw", "nat", "lb", "macswap")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative point of the evaluation matrix.

    ``name`` is the point's identity inside its family.  ``flows`` > 0
    constrains (src_ip, src_port) to a deterministic ``flows``-entry pool
    (flow structure for NAT/LB and a workload-independent firewall rule
    set); 0 keeps random addresses with rules drawn from the traffic.
    ``backend`` is one of the port's backends (``ref | cuda | auto``).
    ``fault`` injects one fault event (``switchsim.faults.FaultSpec``);
    ``nat_capacity`` overrides the NAT table size (0 = the NF's default).
    ``devices`` shards the point's flat pipe axis over that many logical
    devices (``switchsim.fabric``, DESIGN.md §12) — a grid axis and part
    of the compile key, since a sharded group must stay one run whose
    concatenated pipe axis shards as a whole.  Results are device-count
    invariant (bit-identical counters/telemetry/occupancy), so scaling
    sweeps vary only the wall clock.
    """

    name: str
    workload: WorkloadSpec = ("enterprise",)
    chain: ChainSpec = ("fw", "nat")
    pipes: int = 1
    recirc: bool = False
    recirc_frac: float = 0.25
    capacity: int = 4096
    max_exp: int = 2
    packets: int = 16384
    chunk: int = 256
    window: int = 2
    pmax: int = 2048
    explicit_drops: bool = False
    seed: int = 0
    flows: int = 0
    fw_rules: int = 20
    backend: str = "auto"
    fault: FaultSpec = NO_FAULT
    nat_capacity: int = 0
    devices: int = 1

    def __post_init__(self):
        as_config(self.backend)  # validates the backend name eagerly
        if self.packets % self.chunk:
            raise ValueError(
                f"{self.name}: packets ({self.packets}) must be a multiple "
                f"of chunk ({self.chunk})")
        if self.pipes < 1:
            raise ValueError(f"{self.name}: pipes must be >= 1")
        if self.devices < 1:
            raise ValueError(f"{self.name}: devices must be >= 1")
        resolve_workload(self.workload)  # validates the name eagerly
        if self.flows and self.workload[0] in ("adversarial", "churn"):
            raise ValueError(
                f"{self.name}: workload {self.workload[0]!r} owns the "
                f"source identity (spoofed/churning flows); flows must be 0")
        for nf in self.chain:
            if nf not in _NF_NAMES:
                raise ValueError(
                    f"{self.name}: unknown NF {nf!r} (have {_NF_NAMES})")
        if self.flows and "fw" in self.chain and self.fw_rules >= self.flows:
            raise ValueError(
                f"{self.name}: fw_rules ({self.fw_rules}) must be < flows "
                f"({self.flows}) — blocking the whole pool drops 100% of "
                f"the traffic")
        if self.nat_capacity and "nat" not in self.chain:
            raise ValueError(
                f"{self.name}: nat_capacity set but no 'nat' in chain")
        f = self.fault
        if f.active:
            steps = T.pipe_trace_steps(self.packets, self.pipes, self.chunk)
            if f.end > steps:
                raise ValueError(
                    f"{self.name}: fault window [{f.start}, {f.end}) "
                    f"exceeds the {steps}-step per-pipe trace — faults "
                    f"must live within the offered traffic")
            if f.kind == "server" and f.pipe >= self.pipes:
                raise ValueError(
                    f"{self.name}: fault pipe {f.pipe} >= pipes "
                    f"({self.pipes})")
            if f.kind == "lb" and "lb" not in self.chain:
                raise ValueError(
                    f"{self.name}: lb fault but no 'lb' in chain")

    def park_config(self) -> ParkConfig:
        return ParkConfig(capacity=self.capacity, max_exp=self.max_exp,
                          pmax=self.pmax, recirculation=self.recirc,
                          recirc_frac=self.recirc_frac)

    def backend_config(self) -> BackendConfig:
        """The point's backend selection (``auto`` resolves per call from
        the tensors' device, so it needs no platform step here)."""
        return as_config(self.backend)

    def as_dict(self) -> dict:
        """JSON-ready form of the spec."""
        d = dataclasses.asdict(self)
        d["workload"] = list(self.workload)
        d["chain"] = list(self.chain)
        return d


def resolve_workload(ws: WorkloadSpec) -> T.Workload:
    """Workload-spec tuple -> traffic.generator.Workload."""
    kind = ws[0]
    if kind == "fixed":
        return T.fixed(int(ws[1]))
    if kind == "enterprise":
        return T.enterprise()
    if kind == "datacenter":
        return T.datacenter()
    if kind == "adversarial":
        return T.adversarial(base=ws[1], attack_fraction=float(ws[2]),
                             burst=int(ws[3]))
    if kind == "churn":
        return T.churn(pool=int(ws[1]), rotate=int(ws[2]))
    raise ValueError(f"unknown workload spec {ws!r}")


def make_packets(spec: ScenarioSpec) -> PacketBatch:
    """Deterministic traffic for one scenario point, on the CPU (the
    engine moves the traces to its device).

    Drawn from generators seeded only by ``spec.seed`` (the flow-pool draw
    from a second one, as the reference folds a second key in), so two
    specs with equal (workload, packets, pmax, flows, seed) get identical
    traffic however the rest of the grid differs, and recirc on/off pairs
    compare the same packets.
    """
    wl = resolve_workload(spec.workload)
    pkts = wl.make_batch(torch.Generator().manual_seed(spec.seed),
                         spec.packets, pmax=spec.pmax, device="cpu")
    if spec.flows:
        ips, ports = T.flow_pool(spec.flows, device="cpu")
        fold = torch.Generator().manual_seed(spec.seed * 1000003 + 1)
        idx = torch.randint(0, spec.flows, (spec.packets,), generator=fold)
        # both halves of the NAT flow key come from the pool, so repeat
        # flows really repeat at the NF chain
        pkts = pkts.replace(src_ip=ips[idx], src_port=ports[idx])
    return pkts


def firewall_rules(spec: ScenarioSpec, pkts: PacketBatch) -> tuple[int, ...]:
    """Blocked-IP list: the pool's first ``fw_rules`` addresses when flows
    are constrained (the same for every workload), otherwise the first
    ``fw_rules`` distinct source addresses of the traffic."""
    if spec.flows:
        ips, _ = T.flow_pool(spec.flows, device="cpu")
        return tuple(int(ip) for ip in ips[:spec.fw_rules].tolist())
    return tuple(int(ip) for ip in
                 torch.unique(pkts.src_ip.cpu())[:spec.fw_rules].tolist())


def build_chain(spec: ScenarioSpec, pkts: PacketBatch) -> Chain:
    """Chain-spec tuple -> runnable (and hashable) nf.chain.Chain."""
    nfs = []
    for nf in spec.chain:
        if nf == "fw":
            nfs.append(Firewall(rules=firewall_rules(spec, pkts)))
        elif nf == "nat":
            nfs.append(Nat(capacity=spec.nat_capacity) if spec.nat_capacity
                       else Nat())
        elif nf == "lb":
            nfs.append(MaglevLB(fault_target=spec.fault.backend
                                if spec.fault.kind == "lb" else -1))
        elif nf == "macswap":
            nfs.append(MacSwap())
    return Chain(tuple(nfs))


def steer(spec: ScenarioSpec, pkts: PacketBatch):
    """Shard a scenario's traffic into its (P, T, chunk, ...) traces.

    One pipe takes the packets in order (tail padding only); several go
    through the §6.3.2 flow steering.  Returns ``(traces, steer_stats)``.
    """
    if spec.pipes == 1:
        trace = to_time_major(pkts, spec.chunk)
        stats = dict(per_pipe_arrivals=[spec.packets], overflow=0,
                     pipe_capacity=spec.packets)
        return map_fields(lambda n, a: a[None], trace), stats
    shards, stats = T.steer_pipes(pkts, spec.pipes, chunk=spec.chunk)
    traces = map_fields(
        lambda n, a: a.reshape((spec.pipes, a.shape[1] // spec.chunk,
                                spec.chunk) + a.shape[2:]), shards)
    return traces, stats


def grid(base: ScenarioSpec, name_fmt: str, **axes) -> list[ScenarioSpec]:
    """Expand a cartesian grid of spec fields around ``base``.

    ``axes`` maps field names to value lists; ``name_fmt`` is formatted
    with each point's axis values.  Axis order follows keyword order.
    """
    for field in axes:
        if field not in {f.name for f in dataclasses.fields(ScenarioSpec)}:
            raise ValueError(f"unknown grid axis {field!r}")
    specs = []
    names = list(axes.keys())
    for values in itertools.product(*axes.values()):
        kw = dict(zip(names, values))
        specs.append(dataclasses.replace(
            base, name=name_fmt.format(**kw), **kw))
    if len({s.name for s in specs}) != len(specs):
        raise ValueError(f"name_fmt {name_fmt!r} does not separate the grid")
    return specs


def compile_key(spec: ScenarioSpec, chain: Chain, steps: int):
    """The batching key: points with equal keys run as ONE ``run_pipes``
    call on their concatenated pipe axes.

    Equal ParkConfig (state shapes, lane width), equal chain, equal trace
    geometry (``steps`` from the point's steered traces) and the same
    backend selection.  Points that differ only in workload, seed or flow
    structure share a key; shape-changing axes run as separate calls.
    ``devices`` is part of the key: a group spanning devices stays one
    run whose concatenated pipe axis shards as a whole.
    """
    cfg = spec.park_config()
    lane = recirc_slots(cfg, spec.chunk)
    return (cfg, chain, spec.window, spec.chunk, steps, spec.pmax,
            spec.explicit_drops, lane, spec.backend_config(), spec.devices)
