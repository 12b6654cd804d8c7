"""Sweep runner: one ``run_pipes`` call per batchable group of points (port
of ``repro.scenarios.runner``; DESIGN.md §8).

  1. ``prepare`` expands each scenario point to its traffic, chain,
     (P_i, T, chunk, ...) traces and fault masks, on the CPU;
  2. ``run_prepared`` batches points whose ``compile_key`` matches: their
     pipe axes are concatenated into one (sum P_i, T, chunk, ...) trace
     and run by ONE ``engine.run_pipes`` call on the chosen device — pipes
     share nothing, so the flat pipe axis is indifferent to which point
     each pipe belongs to;
  3. per-point results are regrouped from the per-pipe counters,
     telemetry, NF counters and occupancy.

``run_matrix`` is ``prepare`` then ``run_prepared``; a caller may also
hand ``run_prepared`` points prepared elsewhere (the parity tests feed it
the reference runner's points, carried across by ``repro_torch.convert``).

``verify_oracle`` re-runs a point through the host-loop reference
(``simulate_loop``) pipe by pipe and asserts counters, telemetry and NF
counters equal — the engine≡loop invariant.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import counters as C
from repro_torch.core.packet import PacketBatch, from_time_major, map_fields
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.scenarios.spec import (ScenarioSpec, build_chain,
                                        compile_key, make_packets, steer)
from repro_torch.switchsim import engine as E
from repro_torch.switchsim import faults as F
from repro_torch.switchsim.results import flat_summary
from repro_torch.switchsim.simulate import simulate_loop
from repro_torch.switchsim.telemetry import LinkTelemetry, sum_telemetry


@dataclasses.dataclass
class Prepared:
    """One scenario point made runnable: its traffic, chain, steered
    (P, T, chunk, ...) traces, steering stats and per-pipe fault masks."""

    spec: ScenarioSpec
    pkts: PacketBatch
    chain: object
    traces: PacketBatch
    steer_stats: dict
    n_pipes: int
    faults: F.FaultArrays = None

    @property
    def steps(self) -> int:
        return self.traces.src_ip.shape[1]


@dataclasses.dataclass
class ScenarioResult:
    """One executed scenario point (cross-pipe aggregates and per-pipe
    breakdowns), with its goodput-gain dict, chain cycle costs and
    steering stats."""

    spec: ScenarioSpec
    counters: dict
    telemetry: LinkTelemetry
    per_pipe_counters: list[dict]
    per_pipe_telemetry: list[LinkTelemetry]
    per_pipe_peak_occupancy: list[int]
    nf_counters: dict
    per_pipe_nf_counters: list[dict]
    per_pipe_occ_series: object   # (P, steps) parked-slot occupancy
    gain: dict
    steer_stats: dict
    nf_cycles: tuple[float, ...]
    wall_s: float       # this point's share of its group's wall time
    group_size: int     # points that shared the run_pipes call
    group_wall_s: float
    # the prepared point this result was computed from; verify_oracle
    # reuses it instead of regenerating
    prepared: Prepared = dataclasses.field(default=None, repr=False)

    @property
    def peak_occupancy(self) -> int:
        return max(self.per_pipe_peak_occupancy)

    @property
    def alive_offered(self) -> int:
        """Offered packets that reached a pipe (steering overflow excluded)."""
        return (sum(self.steer_stats["per_pipe_arrivals"])
                - self.steer_stats["overflow"])

    def summary(self) -> dict:
        return flat_summary(self.counters, self.telemetry,
                            peak_occupancy=self.peak_occupancy,
                            nf_counters=self.nf_counters)


def prepare(spec: ScenarioSpec) -> Prepared:
    """Traffic, chain, traces and fault masks of one point, on the CPU."""
    pkts = make_packets(spec)
    chain = build_chain(spec, pkts)
    traces, stats = steer(spec, pkts)
    fa = F.resolve(spec.fault, pipes=spec.pipes,
                   steps=traces.src_ip.shape[1])
    return Prepared(spec, pkts, chain, traces, stats, spec.pipes, fa)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_prepared(prepared: list[Prepared], time_runs: bool = False,
                 time_repeats: int = 1,
                 device=DEFAULT_DEVICE) -> list[ScenarioResult]:
    """Run prepared points on ``device``, batching those with equal
    ``compile_key`` into one ``run_pipes`` call; results in input order.

    ``time_runs`` re-runs each group ``time_repeats`` times after the
    first run and attributes the mean group wall time (host clock, ended
    by a device synchronize) evenly across its points.
    """
    dev = resolve_device(device)
    groups: dict = {}
    for i, p in enumerate(prepared):
        groups.setdefault(compile_key(p.spec, p.chain, p.steps),
                          []).append(i)

    results: list = [None] * len(prepared)
    for key, members in groups.items():
        (cfg, chain, window, _chunk, _steps, _pmax, explicit_drops,
         _lane, backend, devices) = key
        stacked = map_fields(lambda n, *xs: torch.cat(xs, dim=0),
                             *(prepared[i].traces for i in members))
        # fault masks ride the same stacked pipe axis as the traces
        stacked_faults = F.concat([prepared[i].faults for i in members])

        # ``devices`` shards the group's *concatenated* pipe axis
        # (switchsim.fabric): the group stays one run whose shards may
        # straddle scenario boundaries; the per-scenario regrouping below
        # reads across shard boundaries
        def run():
            return E.run_pipes(cfg, chain, stacked, window=window,
                               explicit_drops=explicit_drops,
                               backend=backend, faults=stacked_faults,
                               devices=devices, device=dev)

        res = run()
        group_wall = 0.0
        if time_runs:
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(max(time_repeats, 1)):
                run()
            _sync(dev)
            group_wall = (time.perf_counter() - t0) / max(time_repeats, 1)
        nf_cycles = chain.cycle_costs(backend=backend, device=dev)
        offset = 0
        for i in members:
            p = prepared[i]
            lo, hi = offset, offset + p.n_pipes
            offset = hi
            per_ctr = res.per_pipe_counters[lo:hi]
            per_tel = res.per_pipe_telemetry[lo:hi]
            per_nf = res.per_pipe_nf_counters[lo:hi]
            tel = sum_telemetry(per_tel)
            results[i] = ScenarioResult(
                spec=p.spec,
                counters={name: sum(c[name] for c in per_ctr)
                          for name in C.NAMES},
                telemetry=tel,
                per_pipe_counters=per_ctr,
                per_pipe_telemetry=per_tel,
                per_pipe_peak_occupancy=res.per_pipe_peak_occupancy[lo:hi],
                nf_counters={name: sum(c[name] for c in per_nf)
                             for name in (per_nf[0] if per_nf else {})},
                per_pipe_nf_counters=per_nf,
                per_pipe_occ_series=res.per_pipe_occ_series[lo:hi],
                gain=E.goodput_gain_from_telemetry(tel),
                steer_stats=p.steer_stats,
                nf_cycles=nf_cycles,
                wall_s=group_wall / len(members),
                group_size=len(members),
                group_wall_s=group_wall,
                prepared=p,
            )
        assert offset == len(res.per_pipe_counters)
    return results


def run_matrix(specs, time_runs: bool = False, time_repeats: int = 1,
               device=DEFAULT_DEVICE) -> list[ScenarioResult]:
    """Execute scenario points on ``device``, batching the ones that share
    a ``compile_key``; results in the order of ``specs``."""
    return run_prepared([prepare(s) for s in specs], time_runs=time_runs,
                        time_repeats=time_repeats, device=device)


class OracleMismatch(AssertionError):
    """Engine diverged from the host-loop reference on a scenario point."""


def verify_oracle(result: ScenarioResult, faults=True,
                  device=DEFAULT_DEVICE) -> None:
    """Assert engine ≡ host loop (counters, telemetry, NF counters) for one
    point, re-running ``simulate_loop`` pipe by pipe on ``device`` with the
    point's backend.  ``faults=False`` re-runs the loop healthy.  Raises
    ``OracleMismatch`` on any difference.

    **Per-shard semantics** (``spec.devices`` > 1, DESIGN.md §12): the
    fabric shards the pipe axis contiguously, so the per-pipe check below
    *is* the per-shard check — each device's pipe slice is verified
    independently against its own host-loop re-run, with no cross-shard
    state to reconcile.  Mismatch messages name the shard the diverging
    pipe ran on, so multi-device failures localize to a device."""
    spec = result.spec
    p = result.prepared if result.prepared is not None else prepare(spec)
    cfg = spec.park_config()
    # contiguous shard of each pipe index, for mismatch localization
    # (devices that didn't divide the pipe axis ran replicated on shard 0)
    per_shard = (spec.pipes // spec.devices
                 if spec.pipes % spec.devices == 0 else spec.pipes)
    for pipe in range(spec.pipes):
        shard = pipe // max(per_shard, 1)
        where = (f"{spec.name} pipe {pipe} (shard {shard}/{spec.devices})"
                 if spec.devices > 1 else f"{spec.name} pipe {pipe}")
        flat = from_time_major(map_fields(lambda n, a: a[pipe], p.traces))
        loop = simulate_loop(cfg, p.chain, flat, window=spec.window,
                             chunk=spec.chunk,
                             explicit_drops=spec.explicit_drops,
                             backend=spec.backend_config(),
                             faults=spec.fault if faults else None,
                             fault_pipe=pipe, device=device)
        if loop.counters != result.per_pipe_counters[pipe]:
            raise OracleMismatch(
                f"{where}: counters diverged\n"
                f"  engine: {result.per_pipe_counters[pipe]}\n"
                f"  loop:   {loop.counters}")
        if loop.telemetry != result.per_pipe_telemetry[pipe]:
            raise OracleMismatch(
                f"{where}: telemetry diverged\n"
                f"  engine: {result.per_pipe_telemetry[pipe]}\n"
                f"  loop:   {loop.telemetry}")
        if loop.nf_counters != result.per_pipe_nf_counters[pipe]:
            raise OracleMismatch(
                f"{where}: NF counters diverged\n"
                f"  engine: {result.per_pipe_nf_counters[pipe]}\n"
                f"  loop:   {loop.nf_counters}")


def default_rows(result: ScenarioResult, family: str) -> list[tuple]:
    """Generic rows for one point: the goodput headline plus the counters
    that have historically caught regressions, as
    ``(name, value, derived, scenario)`` tuples."""
    s, sm = result.spec, result.summary()
    derived = (f"wire_bytes={sm['wire_bytes']};srv_bytes={sm['srv_bytes']};"
               f"ret_bytes={sm['ret_bytes']};splits={sm['splits']};"
               f"merges={sm['merges']};"
               f"premature={sm['premature_evictions']};"
               f"peak_occ={sm['peak_occupancy']};"
               f"overflow={result.steer_stats['overflow']}")
    rows = [
        (f"{family}/{s.name}/goodput_gain",
         round(result.gain["goodput_gain"], 4), derived, s.name),
        (f"{family}/{s.name}/link_byte_saving",
         round(result.gain["link_byte_saving"], 4),
         f"naive={result.gain['link_byte_saving_naive']:.4f}", s.name),
    ]
    if s.recirc:
        rows.append((
            f"{family}/{s.name}/recirculations", sm["recirculations"],
            f"budget_drops={sm['recirc_budget_drops']};"
            f"recirc_bytes={sm['tel_recirc_bytes']}", s.name))
    return rows
