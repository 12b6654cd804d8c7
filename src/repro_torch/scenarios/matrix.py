"""The paper's evaluation grid as first-class scenario families (port of
``repro.scenarios.matrix``: the same families, points and parameters).

Registered families:

  * ``pipeline``          — FW->NAT on enterprise traffic across 1/2/4/8
                            per-port pipes (§6.3.2);
  * ``recirc``            — table-occupancy sweep, recirculation lane
                            off vs on (§6.2.5 / Fig. 13 direction);
  * ``hostmodel_sizes``   — MacSwap on fixed 256..1492 B + enterprise
                            (PCIe band, abstract's 2-58 %);
  * ``hostmodel_servers`` — FW->NAT on 1..8 NF servers with §6.2.3
                            lookup-table slicing;
  * ``chain``             — the §7 headline: FW->NAT->LB (Maglev) on
                            datacenter-characteristic traffic, parking
                            vs parking+recirculation (13 % -> 28 % shape),
                            with the enterprise mix alongside for contrast.

Every factory takes ``tiny`` and derives its trace geometry from
``repro_torch.configs.sweeps``, so the small and the full matrix are the
same scenarios at two sizes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import sweeps
from repro_torch.scenarios.registry import register
from repro_torch.scenarios.spec import ScenarioSpec, grid

# §7 chain scenarios constrain src IPs to a deterministic flow pool: the
# firewall's blocked list comes from the pool (not from the traffic), so
# datacenter and enterprise points batch into one run_pipes call per mode.
CHAIN_FLOWS = dict(full=1024, tiny=256)


def _base(tiny: bool, **kw) -> ScenarioSpec:
    sh = sweeps.shape(tiny)
    kw.setdefault("packets", sh.packets)
    kw.setdefault("chunk", sh.chunk)
    kw.setdefault("window", sh.window)
    kw.setdefault("pmax", sh.pmax)
    return ScenarioSpec(**kw)


def pipeline_grid(pipes_list, *, packets, chunk, window, pmax, capacity,
                  explicit_drops: bool = False,
                  backends=("auto",), devices=(1,)) -> list[ScenarioSpec]:
    """The pipes sweep at explicit geometry — the one definition of the
    §6.3.2 grid, which ``pipeline_family`` delegates to.

    ``backends`` adds the dataplane-backend axis (the port's ``ref |
    cuda | auto``; the reference's default is its ``ref``, the port's
    ``auto`` runs the kernels on the card) and ``devices`` the
    fabric-sharding axis (``switchsim.fabric``).  Single-valued
    axes keep the plain point names (``pipes2``); multi-valued axes
    separate the points by name (``pipes2_cuda``, ``pipes2_dev4``)."""
    base = ScenarioSpec(
        name="", workload=("enterprise",), chain=("fw", "nat"),
        capacity=capacity, max_exp=2, packets=packets, chunk=chunk,
        window=window, pmax=pmax, explicit_drops=explicit_drops)
    backends = list(backends)
    devices = list(devices)
    name, axes = "pipes{pipes}", dict(pipes=list(pipes_list))
    if len(backends) == 1:
        base = dataclasses.replace(base, backend=backends[0])
    else:
        name, axes["backend"] = name + "_{backend}", backends
    if len(devices) == 1:
        base = dataclasses.replace(base, devices=devices[0])
    else:
        name, axes["devices"] = name + "_dev{devices}", devices
    return grid(base, name, **axes)


@register("pipeline")
def pipeline_family(tiny: bool) -> list[ScenarioSpec]:
    sh = sweeps.shape(tiny)
    return pipeline_grid([1, 2] if tiny else [1, 2, 4, 8],
                         packets=sh.packets, chunk=sh.chunk,
                         window=sh.window, pmax=sh.pmax,
                         capacity=256 if tiny else 4096)


def recirc_grid(*, packets, chunk, window, pmax,
                recirc_frac: float = 0.25) -> list[ScenarioSpec]:
    """The §6.2.5 occupancy x lane-mode sweep at explicit geometry — the
    one definition of the grid (capacity points are multiples of the
    in-flight window), which ``recirc_family`` delegates to.

    max_exp=4 keeps the full table out of the premature-eviction regime
    (occupancy pressure, not eviction losses, is the §6.2.5 experiment).
    """
    inflight = max(window, 1) * chunk
    base = ScenarioSpec(
        name="", workload=("enterprise",), chain=("fw", "nat", "lb"),
        max_exp=4, packets=packets, chunk=chunk, window=window, pmax=pmax,
        recirc_frac=recirc_frac)
    specs = []
    for label, capacity in (("low", 8 * inflight), ("mid", inflight),
                            ("high", inflight // 2)):
        for mode, on in (("off", False), ("on", True)):
            specs.append(dataclasses.replace(
                base, name=f"occ_{label}_{mode}", capacity=capacity,
                recirc=on))
    return specs


@register("recirc")
def recirc_family(tiny: bool) -> list[ScenarioSpec]:
    sh = sweeps.shape(tiny)
    return recirc_grid(packets=sh.packets, chunk=sh.chunk,
                       window=sh.window, pmax=sh.pmax)


@register("hostmodel_sizes")
def hostmodel_sizes_family(tiny: bool) -> list[ScenarioSpec]:
    sizes = [256, 1492] if tiny else [256, 384, 512, 1024, 1492]
    # pmax=2048 even in tiny mode: the size sweep reaches 1492 B packets
    base = _base(tiny, name="", chain=("macswap",), pmax=2048,
                 capacity=512 if tiny else 4096, max_exp=2)
    specs = [dataclasses.replace(base, name=f"fixed{s}",
                                 workload=("fixed", s), seed=i)
             for i, s in enumerate(sizes)]
    specs.append(dataclasses.replace(base, name="enterprise",
                                     workload=("enterprise",),
                                     seed=len(sizes)))
    return specs


@register("hostmodel_servers")
def hostmodel_servers_family(tiny: bool, mem_frac: float = 0.40,
                             ) -> list[ScenarioSpec]:
    from repro_torch.core.park import ParkConfig
    from repro_torch.hostmodel import per_server_capacity
    base = _base(tiny, name="", workload=("enterprise",),
                 chain=("fw", "nat"), pmax=2048, max_exp=2, seed=99)
    specs = []
    for n in [1, 2] if tiny else [1, 2, 4, 8]:
        capacity = per_server_capacity(
            mem_frac, ParkConfig(pmax=base.pmax), n)
        specs.append(dataclasses.replace(
            base, name=f"servers{n}", pipes=n, capacity=capacity))
    return specs


@register("chain")
def chain_family(tiny: bool) -> list[ScenarioSpec]:
    flows = CHAIN_FLOWS["tiny" if tiny else "full"]
    # max_exp=4 for the same reason as the recirc family: the §7 claim is
    # about parked-byte savings, not eviction-loss dynamics
    base = _base(tiny, name="", chain=("fw", "nat", "lb"),
                 capacity=256 if tiny else 4096, max_exp=4,
                 flows=flows, fw_rules=20)
    specs = []
    for wl in ("datacenter", "enterprise"):
        for mode, on in (("base", False), ("recirc", True)):
            specs.append(dataclasses.replace(
                base, name=f"{wl}_{mode}", workload=(wl,), recirc=on))
    return specs
