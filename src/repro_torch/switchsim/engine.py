"""Multi-pipe PayloadPark simulation engine (port of
``repro.switchsim.engine``).

The reference compiles the split -> NF chain -> merge timeline into one
``lax.scan`` over time steps and ``vmap``s it over pipes.  The port runs the
same step body in a Python loop over time steps, with the pipe axis as a
leading batch dimension of every state and packet tensor: one step
advances all pipes together, and each per-packet control loop inside it
runs once per packet position for every pipe at once.

  * The in-flight window — the paper's split -> merge time delta (~30 us,
    §4) — is a ``window``-deep ring of packet chunks: chunk ``t`` is split
    at step ``t`` and its NF output merges at step ``t + window``.
  * The recirculation lane (``cfg.recirculation``, paper §6.2.5): Split
    outputs that want another pass detour into a ``recirc_slots``-wide
    lane, re-enter through ``core.park.recirc_fn`` at the next step and
    only then travel to the NF server.  Candidates beyond the lane width
    forward as-is and count ``recirc_budget_drops``.
  * Fault masks (``switchsim.faults``) are read column by column; all-True
    masks are exact no-ops.

Per-step per-link tallies stay on the device as (P,) tensors and come to
the host once, at the end of the run, summed in int64.  The step index is
a Python int, so nothing in the loop waits for the device.

The recorder (``repro_torch.trace``) sees a ``run_pipes`` call as a root
span holding ``setup`` (entry to the first step: the fault masks and the
fresh carry on the device), one ``step`` span a step (``scan_step``) and
``finish`` (the tallies and counters to the host, the per-pipe results);
every wait for the card on the way counts one ``host_syncs``.

Results are bit-identical to ``simulate.simulate_loop`` on the same trace
and to the reference engine on the same numpy inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import trace
from repro_torch.backend.config import as_config
from repro_torch.core import counters as C
from repro_torch.core.packet import (FIELDS, PacketBatch, dead_batch,
                                     gather_rows, map_fields)
from repro_torch.core.park import (ParkConfig, ParkState, init_state,
                                   merge_fn, occupancy, recirc_fn, split_fn)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import Chain, to_explicit_drops
from repro_torch.switchsim import fabric
from repro_torch.switchsim import faults as F
from repro_torch.switchsim.results import EngineResult, PipesResult
from repro_torch.switchsim.telemetry import (TEL_FIELDS, LinkTelemetry,
                                             sum_telemetry)
from repro_torch.traffic import stream as stream_mod

__all__ = [
    "EngineResult", "PipesResult", "run_engine", "run_pipes",
    "goodput_gain", "goodput_gain_from_telemetry", "recirc_slots",
    "recirc_select", "scan_step", "init_carry",
]


def _alive_bytes(p: PacketBatch) -> torch.Tensor:
    return torch.where(p.alive, p.pkt_len(), 0).sum(-1)


def _alive_pkts(p: PacketBatch) -> torch.Tensor:
    return p.alive.sum(-1)


def recirc_slots(cfg: ParkConfig, chunk: int) -> int:
    """Recirculation-lane width: ``floor(recirc_frac * chunk)``, 0 when
    recirculation is off (or the share is below one packet)."""
    if not cfg.recirculation:
        return 0
    # epsilon guards binary-representation error (0.29 * 100 == 28.999...)
    return math.floor(cfg.recirc_frac * chunk + 1e-9)


def recirc_select(cfg: ParkConfig, out: PacketBatch, budget: int):
    """Admit up to ``budget`` recirculation candidates of a Split output, in
    arrival order: continuations (parked with payload remaining) and
    retries (occupied-slot skips with an eligible payload).

    Returns ``(forwarded, lane, n_denied)``; ``lane`` is a ``budget``-row
    PacketBatch with dead rows beyond the admitted count.
    """
    cont = out.alive & out.pp_valid & (out.pp_enb == 1) & \
        (out.payload_len > 0)
    retry = out.alive & out.pp_valid & (out.pp_enb == 0) & \
        (out.payload_len >= cfg.min_park_len)
    cand = cont | retry
    pos = torch.cumsum(cand.to(torch.int64), dim=-1) - 1
    admit = cand & (pos < budget)
    lead, b = out.alive.shape[:-1], out.alive.shape[-1]
    # Invert: lane_src[pos] = row; column ``budget`` is the sink for rows
    # not admitted, and empty lane slots gather the dead row ``b``.
    dest = torch.where(admit, pos, budget)
    lane_src = torch.full(lead + (budget + 1,), b, dtype=torch.int64,
                          device=pos.device)
    rows = torch.arange(b, device=pos.device).expand(lead + (b,))
    lane_src.scatter_(-1, dest, rows)
    lane = gather_rows(out, lane_src[..., :budget])
    forwarded = out.replace(alive=out.alive & ~admit)
    return forwarded, lane, (cand & ~admit).sum(-1)


def _cat_rows(a: PacketBatch, b: PacketBatch) -> PacketBatch:
    return map_fields(
        lambda n, x, y: torch.cat([x, y], dim=-2 if n == "payload" else -1),
        a, b)


def init_carry(cfg: ParkConfig, chain: Chain, pipes: int, chunk: int,
               window: int, recirc: int, device):
    """Fresh carry (ParkState, NF-chain states, in-flight ring, recirc
    lane, step index) for ``pipes`` pipes of ``chunk``-packet steps.  The
    ring holds dead chunks ``recirc`` rows wider than a step."""
    lead = (pipes,)
    ring = [dead_batch(chunk + recirc, cfg.pmax, device, lead)
            for _ in range(max(window, 1))]
    lane0 = dead_batch(recirc, cfg.pmax, device, lead) if recirc else None
    return (init_state(cfg, device, pipes), chain.init_state(device, pipes),
            ring, lane0, 0)


def scan_step(cfg: ParkConfig, chain: Chain, window: int,
              explicit_drops: bool, backend, collect_sent: bool,
              recirc: int):
    """The per-step body: (carry, (chunk, server_up, lb_up), drain) ->
    (carry, per-step ys).  ``recirc`` is the lane width (0 = lane off).

    A step is a ``step`` span of the recorder (``repro_torch.trace``)
    holding one ``split``, ``nf_chain`` and ``merge`` span, and with the
    lane two ``recirc`` spans: the second pass before Split, the lane's
    admission after it."""

    def body(carry, xs, drain):
        state, cstates, ring, lane, t = carry
        cin, s_up, l_up = xs
        wire_b = _alive_bytes(cin)
        wire_p = _alive_pkts(cin)
        if recirc:
            with trace.span("recirc"):
                # second pass for packets re-injected at the previous step
                state, rout = recirc_fn(cfg, state, lane, backend=backend)
        with trace.span("split"):
            state, out = split_fn(cfg, state, cin, backend=backend)
        if recirc:
            with trace.span("recirc"):
                out, lane, n_denied = recirc_select(cfg, out, recirc)
                state = dataclasses.replace(
                    state, counters=C.bump(state.counters,
                                           "recirc_budget_drops", n_denied))
                rec_b, rec_p = _alive_bytes(lane), _alive_pkts(lane)
                nf_in = _cat_rows(rout, out)
        else:
            rec_b = rec_p = torch.zeros_like(wire_b)
            nf_in = out
        # the switch still transmits to a dead server: tally before the kill
        to_srv_p, to_srv_b = _alive_pkts(nf_in), _alive_bytes(nf_in)
        with trace.span("nf_chain"):
            killed = nf_in.alive & ~s_up[..., None]
            state = dataclasses.replace(
                state, counters=C.bump(state.counters, "fault_drops",
                                       killed.sum(-1)))
            srv_in = nf_in.replace(alive=nf_in.alive & s_up[..., None])
            cstates, nf_out, dropped, _cycles = chain.run(
                cstates, srv_in, backend=backend, ctx={"lb_up": l_up})
            if explicit_drops:
                nf_out = to_explicit_drops(nf_out, dropped)
            # drain-vs-drop: with drain, killed parked packets come back as
            # OP=drop notifications that free their slots at Merge
            nf_out = to_explicit_drops(nf_out, killed & drain[..., None])
        if window == 0:
            returning = nf_out
        else:
            slot = t % window
            returning = ring[slot]
            ring = ring[:slot] + [nf_out] + ring[slot + 1:]
        with trace.span("merge"):
            state, m = merge_fn(cfg, state, returning, backend=backend)
        ys = dict(
            merged=m, occ=occupancy(state),
            wire_pkts=wire_p, wire_bytes=wire_b,
            to_server_pkts=to_srv_p,
            to_server_bytes=to_srv_b,
            from_server_pkts=_alive_pkts(returning),
            from_server_bytes=_alive_bytes(returning),
            recirc_pkts=rec_p, recirc_bytes=rec_b,
            merged_pkts=_alive_pkts(m), merged_bytes=_alive_bytes(m),
        )
        if collect_sent:
            ys["sent"] = nf_in
        return (state, cstates, ring, lane, t + 1), ys

    def step(carry, xs, drain):
        with trace.span("step"):
            return body(carry, xs, drain)

    return step


def _stack_time(batches: list[PacketBatch]) -> PacketBatch:
    """Per-step (P, chunk, ...) batches -> (P, T, chunk, ...)."""
    return PacketBatch(**{n: torch.stack([getattr(b, n) for b in batches],
                                         dim=1) for n in FIELDS})


def _on(dev: torch.device):
    """Make ``dev`` the current card while a shard's step is issued (the
    kernels launch on the current device's stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


class _ShardRun:
    """One shard's run in progress: its inputs on its device, the step
    body, the carry, and what the steps have produced so far."""

    def __init__(self, cfg, chain, traces: PacketBatch, fa: F.FaultArrays,
                 window, explicit_drops, backend, collect_sent):
        self.dev = dev = traces.device
        self.traces = traces
        pipes, self.steps, chunk = traces.src_ip.shape
        lane = recirc_slots(cfg, chunk)
        self.pad = window + (1 if lane else 0)
        ones = np.ones((pipes, self.pad), bool)
        with _on(dev):
            self.s_up = torch.from_numpy(
                np.concatenate([fa.server_up, ones], 1)).to(dev)
            self.l_up = torch.from_numpy(
                np.concatenate([fa.lb_up, ones], 1)).to(dev)
            self.drain = torch.from_numpy(np.asarray(fa.drain, bool)).to(dev)
            self.dead_in = dead_batch(chunk, cfg.pmax, dev, (pipes,))
            self.carry = init_carry(cfg, chain, pipes, chunk, window, lane,
                                    dev)
        self.step_fn = scan_step(cfg, chain, window, explicit_drops, backend,
                                 collect_sent, lane)
        self.window, self.collect_sent = window, collect_sent
        self.merged, self.sent = [], []
        self.tallies: dict[str, list] = {k: [] for k in TEL_FIELDS + ("occ",)}

    def step(self, t: int) -> None:
        with _on(self.dev):
            cin = (map_fields(lambda n, a: a[:, t], self.traces)
                   if t < self.steps else self.dead_in)
            self.carry, ys = self.step_fn(
                self.carry, (cin, self.s_up[:, t], self.l_up[:, t]),
                self.drain)
        if t >= self.window:
            self.merged.append(ys["merged"])
        if self.collect_sent and t < self.steps + self.pad - self.window:
            self.sent.append(ys["sent"])
        for k in self.tallies:
            self.tallies[k].append(ys[k])

    def finish(self, chain):
        """(state, per-pipe NF counters, merged, sent, host ys)."""
        host = {k: _to_host(torch.stack(v, dim=1)).numpy().astype(np.int64)
                for k, v in self.tallies.items()}
        state, cstates = self.carry[0], self.carry[1]
        return (state,
                _per_pipe_nf_counters(chain, cstates, state.counters.shape[0]),
                _stack_time(self.merged),
                _stack_time(self.sent) if self.collect_sent else None, host)


def _execute(runs: list[_ShardRun]) -> None:
    """Issue every step of each shard's (P_i, T, chunk, ...) trace plus the
    drain padding.  The shards run in lockstep: step t of every shard is
    issued before step t + 1 of any, and nothing waits for a device until
    the tallies come to the host at the end."""
    for t in range(runs[0].steps + runs[0].pad):
        for run in runs:
            run.step(t)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a wait for the card, counted as ``host_syncs``."""
    trace.count("host_syncs")
    return t.cpu()


def _per_pipe_telemetry(ys: dict) -> list[LinkTelemetry]:
    sums = {name: ys[name].sum(axis=-1) for name in TEL_FIELDS}
    pipes = next(iter(sums.values())).shape[0]
    return [LinkTelemetry(**{name: int(sums[name][p]) for name in TEL_FIELDS})
            for p in range(pipes)]


def _per_pipe_nf_counters(chain: Chain, cstates,
                          pipes: int) -> list[dict[str, int]]:
    """One dict of NF-private counters per pipe (empty dicts for a chain
    that keeps none)."""
    host = {k: _to_host(v).tolist()
            for k, v in chain.state_counters(cstates).items()}
    return [{k: int(v[p]) for k, v in host.items()} for p in range(pipes)]


def _as_pipe_traces(traces) -> PacketBatch:
    """Coerce ``run_pipes``'s accepted trace spellings to (P, T, chunk,
    ...): a pre-stacked PacketBatch passes through; a TraceSource becomes
    one pipe; a sequence of per-pipe sources is materialized and stacked."""
    if isinstance(traces, PacketBatch):
        if traces.src_ip.dim() != 3:
            raise ValueError(f"traces must have 3 leading axes (P, T, "
                             f"chunk), got {tuple(traces.src_ip.shape)}")
        return traces
    if isinstance(traces, stream_mod.TraceSource):
        traces = [traces]
    if isinstance(traces, (list, tuple)):
        mats = [stream_mod.as_source(t).materialize() for t in traces]
        return map_fields(lambda n, *xs: torch.stack(xs), *mats)
    raise TypeError(
        f"traces must be a PacketBatch, a TraceSource or a sequence of "
        f"TraceSources; got {type(traces).__name__}")


def run_pipes(cfg: ParkConfig, chain: Chain, traces, window: int = 1,
              explicit_drops: bool = False, backend=None,
              collect_sent: bool = False, faults=None, devices: int = 1,
              device=DEFAULT_DEVICE) -> PipesResult:
    """Run P independent pipes over per-pipe trace sources.

    ``traces`` is a sequence of per-pipe ``traffic.stream.TraceSource``s
    (equal geometry, stacked after materialization), a single source (one
    pipe), or the pre-stacked (P, T, chunk, ...) ``PacketBatch`` the
    sources materialize to.  Each pipe owns a fresh ParkState and NF-chain
    state (the paper's per-port pipes share nothing, §6.3.2); all pipes
    advance together along the leading pipe axis.  ``faults`` is a
    ``FaultSpec`` or ``FaultArrays``.

    ``devices`` > 1 shards the pipe axis over that many logical devices
    via ``switchsim.fabric`` (DESIGN.md §12).  Results are bit-identical
    for any device count (shard-count invariance); the request falls back
    to 1 with a warning when the pipe count does not divide it or fewer
    logical devices are visible.
    """
    with trace.span(trace.ROOT):
        with trace.span("setup"):
            backend = as_config(backend)
            dev = resolve_device(device)
            traces = _as_pipe_traces(traces)
            pipes, steps, _ = traces.src_ip.shape
            fa = F.resolve(faults, pipes=pipes, steps=steps)
            if devices != 1:
                devices = fabric.resolve_devices(pipes, devices, dev)
            runs = [_ShardRun(cfg, chain, shard, shard_fa, window,
                              explicit_drops, backend, collect_sent)
                    for shard, shard_fa in fabric.shard_over_switch(
                        traces, fa, devices, dev)]
        _execute(runs)
        with trace.span("finish"):
            return _pipes_result(chain, runs, pipes, dev)


def _pipes_result(chain: Chain, runs: list[_ShardRun], pipes: int,
                  dev: torch.device) -> PipesResult:
    """The shards' outputs on the host and on ``dev``, in pipe order."""
    state, per_nf, merged, sent, ys = (
        fabric.gather(list(part), dev)
        for part in zip(*(run.finish(chain) for run in runs)))
    per_tel = _per_pipe_telemetry(ys)
    tel = sum_telemetry(per_tel)
    occ_pp = ys["occ"]
    per_occ = [int(v) for v in occ_pp.max(axis=-1)]
    ctr = _to_host(state.counters).numpy().astype(np.int64)
    agg = dict(zip(C.NAMES, (int(v) for v in ctr.sum(axis=0))))
    per_pipe = [dict(zip(C.NAMES, (int(v) for v in ctr[p])))
                for p in range(pipes)]
    nf_agg = {k: sum(d[k] for d in per_nf) for k in (per_nf[0] if per_nf
                                                      else {})}
    return PipesResult(
        merged=merged, sent=sent, state=state,
        counters=agg, srv_bytes=tel.srv_bytes,
        srv_fwd_bytes=tel.to_server_bytes, wire_bytes=tel.wire_bytes,
        ret_bytes=tel.merged_bytes, peak_occupancy=int(occ_pp.max()),
        telemetry=tel, occ_series=occ_pp, nf_counters=nf_agg,
        per_pipe_counters=per_pipe,
        per_pipe_srv_bytes=[t.srv_bytes for t in per_tel],
        per_pipe_wire_bytes=[t.wire_bytes for t in per_tel],
        per_pipe_telemetry=per_tel,
        per_pipe_peak_occupancy=per_occ,
        per_pipe_occ_series=occ_pp,
        per_pipe_nf_counters=per_nf,
    )


def run_engine(cfg: ParkConfig, chain: Chain, trace, window: int = 1,
               explicit_drops: bool = False, backend=None,
               collect_sent: bool = False, faults=None,
               device=DEFAULT_DEVICE) -> EngineResult:
    """Run one pipe over a trace source, materialized.

    ``trace`` is a ``traffic.stream.TraceSource`` or a time-major (T,
    chunk, ...) ``PacketBatch`` (the trivial ``MaterializedSource``);
    ``switchsim.stream.run_stream`` is the constant-memory path for
    sources too long to materialize.  The same step body as ``run_pipes``,
    with a pipe axis of one.  With ``cfg.recirculation`` the run takes one
    extra drain step and NF-bound chunks gain ``recirc_slots`` leading
    lane rows.
    """
    trace = stream_mod.as_source(trace).materialize()
    res = run_pipes(cfg, chain, map_fields(lambda n, a: a[None], trace),
                    window=window, explicit_drops=explicit_drops,
                    backend=backend, collect_sent=collect_sent,
                    faults=faults, device=device)

    def first(n, a):
        return a[0]

    return EngineResult(
        merged=map_fields(first, res.merged),
        sent=map_fields(first, res.sent) if collect_sent else None,
        state=ParkState(**{f.name: getattr(res.state, f.name)[0]
                           for f in dataclasses.fields(ParkState)}),
        counters=res.counters, srv_bytes=res.srv_bytes,
        srv_fwd_bytes=res.srv_fwd_bytes, wire_bytes=res.wire_bytes,
        ret_bytes=res.ret_bytes, peak_occupancy=res.peak_occupancy,
        telemetry=res.telemetry, occ_series=res.occ_series[0],
        nf_counters=res.nf_counters,
    )


def goodput_gain(res: EngineResult) -> dict[str, Any]:
    """Server-link byte saving vs the non-parking baseline.

    The drop-aware baseline (headline ``goodput_gain``) carries every
    offered packet whole on the forward trip (``wire_bytes``) and only the
    chain's survivors on the return trip (``ret_bytes``); the naive one
    (``*_naive``) counts ``2 * wire_bytes``.  Parking carries
    ``srv_bytes``, both directions as measured.
    """
    return _gain_from_bytes(res.wire_bytes, res.srv_bytes, res.ret_bytes)


def goodput_gain_from_telemetry(tel: LinkTelemetry) -> dict[str, Any]:
    """``goodput_gain`` straight from a LinkTelemetry (per pipe/server)."""
    return _gain_from_bytes(tel.wire_bytes, tel.srv_bytes, tel.merged_bytes)


def _gain_from_bytes(wire_bytes: int, srv_bytes: int,
                     ret_bytes: int) -> dict[str, Any]:
    naive = 2 * wire_bytes
    baseline = wire_bytes + ret_bytes
    srv = srv_bytes
    return dict(
        baseline_link_bytes=baseline,
        baseline_naive_link_bytes=naive,
        parked_link_bytes=srv,
        link_byte_saving=1.0 - srv / baseline if baseline else 0.0,
        link_byte_saving_naive=1.0 - srv / naive if naive else 0.0,
        goodput_gain=(baseline / srv - 1.0) if srv else 0.0,
        goodput_gain_naive=(naive / srv - 1.0) if srv else 0.0,
    )
