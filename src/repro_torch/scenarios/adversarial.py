"""Adversarial and failure scenario families (port of
``repro.scenarios.adversarial``; DESIGN.md §10).

Four sub-families registered together as the ``adversarial`` family, and
the graceful-degradation gates computed over their results:

  * ``exhaust_*``       — parking-table exhaustion under a SYN-flood-style
                          storm of 208-byte packets (``traffic.adversarial``),
                          each claiming a slot for a 166-byte payload, over
                          attack fraction x burst length against a
                          half-in-flight table; the gate bounds the
                          wire-level drop rate.
  * ``churn_*``         — NAT CLOCK aging under sustained flow churn
                          (``traffic.churn``): a half-overlapping sliding
                          window twice the NAT table, so bindings age out
                          while their flows still send; the gate requires
                          ``nat_stale_hits`` to fire and bounds the drops.
  * ``lb_kill_recover`` — Maglev backend 3 dies for a quarter of the trace
                          and comes back (``FaultSpec(kind="lb")``); no
                          packet may be lost beyond the firewall's share
                          and the table must end clean.
  * ``failover_*``      — the NF server behind pipe 0 dies for a quarter of
                          its trace (``FaultSpec(kind="server")``) in the
                          ``drain`` mode (OP=drop notifications free the
                          lost packets' slots: zero leaked slots) and the
                          ``drop`` mode (slots leak until ring eviction:
                          the leak is bounded by the killed packets).

``degradation_block`` gives the artifact's ``degradation`` block: every
gate with its value and verdict, and ``ok`` as their AND.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import sweeps
from repro_torch.scenarios.registry import register
from repro_torch.scenarios.runner import ScenarioResult
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.switchsim.faults import FaultSpec
from repro_torch.traffic.generator import pipe_trace_steps

__all__ = ["EXHAUST_FRACS", "adversarial_family", "bounds_for",
           "degradation_block", "degradation_metrics"]

EXHAUST_FRACS = (0.0, 0.25, 0.75)


@register("adversarial")
def adversarial_family(tiny: bool) -> list[ScenarioSpec]:
    sh = sweeps.shape(tiny)
    inflight = sh.window * sh.chunk
    specs: list[ScenarioSpec] = []

    # (a) parking-table exhaustion: storm vs a half-in-flight table.
    # MacSwap never drops at the NF, so every lost packet is a premature
    # eviction — the drop rate isolates the parking table's degradation.
    # max_exp=2: one expiry grace period — the healthy baseline stays
    # under ~6% loss while the storm degrades to ~35% (graceful, bounded),
    # instead of the whole mix thrashing at max_exp=1
    exhaust = ScenarioSpec(
        name="", chain=("macswap",), capacity=inflight // 2, max_exp=2,
        packets=sh.packets, chunk=sh.chunk, window=sh.window, pmax=sh.pmax)
    for burst in (8,) if tiny else (8, 64):
        for frac in EXHAUST_FRACS:
            specs.append(dataclasses.replace(
                exhaust, name=f"exhaust_f{int(frac * 100):02d}_b{burst}",
                workload=("adversarial", "enterprise", frac, burst)))

    # (b) NAT CLOCK-aging churn: live-flow window = 2x the NAT table.
    # explicit_drops frees the parked slots of NAT-dropped packets
    # (exhausted inserts + stale hits), so a clean end-of-trace table is
    # part of the gate here too.
    nat_cap = 64 if tiny else 256
    churn = ScenarioSpec(
        name="", chain=("nat",), capacity=2 * inflight, max_exp=2,
        packets=sh.packets, chunk=sh.chunk, window=sh.window, pmax=sh.pmax,
        nat_capacity=nat_cap, explicit_drops=True)
    for label, div in (("slow", 4), ("fast", 16)):
        specs.append(dataclasses.replace(
            churn, name=f"churn_{label}",
            workload=("churn", 2 * nat_cap, sh.packets // div)))

    # (c) Maglev backend kill -> recover mid-trace (global LB fault).
    steps = sh.steps
    # explicit_drops: firewall/NAT-dropped packets free their parked slots
    # (§6.2.4), so the clean-table gate isolates what the LB fault leaks
    specs.append(ScenarioSpec(
        name="lb_kill_recover", chain=("fw", "nat", "lb"),
        capacity=4 * inflight, max_exp=4, packets=sh.packets,
        chunk=sh.chunk, window=sh.window, pmax=sh.pmax,
        flows=256 if tiny else 1024, fw_rules=20, explicit_drops=True,
        fault=FaultSpec(kind="lb", start=steps // 4,
                        duration=steps // 4, backend=3)))

    # (d) NF-server failover on pipe 0 of 2, drain vs drop semantics.
    # capacity = 2x in-flight leaves headroom so the fault's slot bump is
    # visible in the occupancy series (the recovery gate's signal).
    psteps = pipe_trace_steps(sh.packets, 2, sh.chunk)
    failover = ScenarioSpec(
        name="", chain=("fw", "nat"), pipes=2, capacity=2 * inflight,
        max_exp=1, packets=sh.packets, chunk=sh.chunk, window=sh.window,
        pmax=sh.pmax, explicit_drops=True)
    for mode, drain in (("drain", True), ("drop", False)):
        specs.append(dataclasses.replace(
            failover, name=f"failover_{mode}",
            fault=FaultSpec(kind="server", start=psteps // 4,
                            duration=psteps // 4, pipe=0, drain=drain)))
    return specs


# ---------------------------------------------------------------------------
# Graceful-degradation metrics and gates (DESIGN.md §10).


def degradation_metrics(result: ScenarioResult) -> dict:
    """The §10 degradation quantities for one executed scenario point.

    * ``drop_rate``      — wire-level packet loss, 1 - merged/offered
                           (premature evictions + NF drops + fault drops);
    * ``occ_peak``       — peak parked-slot occupancy across pipes;
    * ``occ_final``      — parked slots still live after the drain window
                           (leaked slots: nothing in flight can free them);
    * ``fault_drops``    — packets lost at a down NF server;
    * ``nat_stale_hits`` — stale-mapping hits (NAT chains only);
    * ``recovery_steps`` — server faults only: steps after the fault ends
                           until the victim pipe's occupancy returns to
                           its pre-fault level (-1 = never recovered).
    """
    tel, c = result.telemetry, result.counters
    occ = np.asarray(result.per_pipe_occ_series)
    m = dict(
        drop_rate=round(1.0 - tel.merged_pkts / max(tel.wire_pkts, 1), 6),
        occ_peak=int(result.peak_occupancy),
        occ_final=int(occ[:, -1].sum()),
        fault_drops=int(c["fault_drops"]),
    )
    if "nat_stale_hits" in result.nf_counters:
        m["nat_stale_hits"] = int(result.nf_counters["nat_stale_hits"])
    fault = result.spec.fault
    if fault.active and fault.kind == "server":
        series = occ[fault.pipe]
        baseline = int(series[fault.start - 1]) if fault.start else 0
        after = series[fault.end:]
        hits = np.nonzero(after <= baseline)[0]
        m["recovery_steps"] = int(hits[0]) if hits.size else -1
    return m


# Per-sub-family gate tables: metric -> (op, bound).  A bound may also be
# the *name* of another metric (e.g. the drop-mode leak gate ``occ_final
# <= fault_drops``: leaked slots must be attributable to killed packets).
# Bounds are the reference's: loose envelopes that catch a family falling
# off a cliff (leaks, unbounded loss, no recovery), not 1% noise.
_OPS = {
    "<=": lambda v, b: v <= b,
    ">=": lambda v, b: v >= b,
    "==": lambda v, b: v == b,
}


def bounds_for(spec: ScenarioSpec) -> dict[str, tuple[str, object]]:
    """Graceful-degradation gate for one scenario point."""
    name = spec.name
    if name.startswith("exhaust_"):
        frac = float(spec.workload[2])
        # losses are premature evictions only; the healthy baseline loses
        # ~5-6% at both geometries, the storm adds at most ~0.4x its
        # attack share on top (the reference's tiny and full sweeps)
        return {"drop_rate": ("<=", round(0.12 + 0.5 * frac, 4)),
                "occ_peak": ("<=", spec.capacity),
                "occ_final": ("==", 0)}
    if name.startswith("churn_"):
        return {"drop_rate": ("<=", 0.60),
                "nat_stale_hits": (">=", 1),
                "occ_peak": ("<=", spec.capacity),
                "occ_final": ("==", 0)}
    if name == "lb_kill_recover":
        # the firewall blocks fw_rules of the flow pool by design; the LB
        # fault itself must not add packet loss beyond that floor
        fw_floor = spec.fw_rules / max(spec.flows, 1)
        return {"drop_rate": ("<=", round(fw_floor + 0.06, 4)),
                "fault_drops": ("==", 0),
                "occ_peak": ("<=", spec.capacity),
                "occ_final": ("==", 0)}
    if name.startswith("failover_"):
        gates = {
            # one pipe dark for a quarter of its trace loses at most that
            # share of the offered load (plus steering imbalance slack)
            "drop_rate": ("<=", 0.25),
            "occ_peak": ("<=", spec.pipes * spec.capacity),
        }
        if spec.fault.drain:
            # THE drain invariant: OP=drop notifications free every
            # parked slot a killed packet left behind, and the victim
            # pipe's occupancy settles back to its pre-fault level within
            # a couple of in-flight windows (measured: 3 tiny, 6 full)
            gates["occ_final"] = ("==", 0)
            gates["recovery_steps"] = ("<=", 2 * spec.window + 4)
        else:
            # drop mode leaks until ring eviction reclaims the slots —
            # bounded leak: every leaked slot belongs to a killed packet
            gates["occ_final"] = ("<=", "fault_drops")
        return gates
    raise ValueError(f"no degradation gate defined for {name!r}")


def degradation_block(results: list[ScenarioResult]) -> dict:
    """Artifact ``degradation`` block: per-scenario metrics + gate verdicts.
    ``ok`` at the top level is the AND of every gate."""
    scenarios = {}
    all_ok = True
    for r in results:
        metrics = degradation_metrics(r)
        gates = []
        for metric, (op, bound) in bounds_for(r.spec).items():
            if metric not in metrics:
                raise ValueError(
                    f"{r.spec.name}: gated metric {metric!r} not computed")
            limit = metrics[bound] if isinstance(bound, str) else bound
            ok = bool(_OPS[op](metrics[metric], limit))
            all_ok &= ok
            gates.append(dict(metric=metric, op=op, bound=bound,
                              value=metrics[metric], ok=ok))
        scenarios[r.spec.name] = dict(metrics=metrics, gates=gates)
    return dict(ok=all_ok, scenarios=scenarios)
