"""Chunk-loop pipeline simulation running the real Split/Merge state
machine (port of ``repro.switchsim.simulate``).

Timeline: chunk ``t`` is split at step ``t`` and its NF-chain output
returns for merging at step ``t + window`` — ``window * chunk`` packets are
in flight, the quantity that pressures the lookup table (§4).

  * ``simulate()`` — the list-of-chunks API over ``engine.run_engine``.
  * ``simulate_loop()`` — the step-by-step host loop, one pipe, kept as
    the executable reference the engine must reproduce bit for bit; with
    recirculation on, ``_simulate_loop_recirc`` mirrors the lane.
  * ``baseline_roundtrip()`` — packets travel whole through the chain.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend.config import as_config
from repro_torch.core import counters as C
from repro_torch.core.packet import (PacketBatch, dead_batch, map_fields,
                                     to_time_major)
from repro_torch.core.park import (ParkConfig, init_state, merge_fn,
                                   recirc_fn, split_fn)
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import Chain, to_explicit_drops
from repro_torch.switchsim import engine as engine_mod
from repro_torch.switchsim import faults as F
from repro_torch.switchsim.results import SimResult
from repro_torch.switchsim.telemetry import TEL_FIELDS, LinkTelemetry

__all__ = ["SimResult", "simulate", "simulate_loop", "baseline_roundtrip"]


def _chunks(pkts: PacketBatch, chunk: int) -> list[PacketBatch]:
    n = pkts.batch_size
    if n % chunk:
        raise ValueError(f"batch {n} is not a multiple of chunk {chunk}")
    return [map_fields(lambda name, a: a[i: i + chunk], pkts)
            for i in range(0, n, chunk)]


def _alive_stats(p: PacketBatch) -> tuple[int, int]:
    """(alive packets, alive on-wire bytes), fetched in one host sync."""
    pair = torch.stack([p.alive.sum(),
                        torch.where(p.alive, p.pkt_len(), 0).sum()]).cpu()
    return int(pair[0]), int(pair[1])


def _fault_cut(alive: torch.Tensor, up: bool):
    """(killed, surviving) alive masks at a server that is up or down."""
    none = torch.zeros_like(alive)
    return (none, alive) if up else (alive, none)


def simulate(cfg: ParkConfig, chain: Chain, pkts: PacketBatch,
             window: int = 1, chunk: int = 256, explicit_drops: bool = False,
             backend=None, faults=None, device=DEFAULT_DEVICE) -> SimResult:
    """Stream ``pkts`` through split -> NF chain -> merge with ``window``
    chunks in flight, through the engine; returns the list-of-chunks view.
    """
    trace = to_time_major(pkts, chunk)
    res = engine_mod.run_engine(
        cfg, chain, trace, window=window, explicit_drops=explicit_drops,
        backend=backend, collect_sent=True, faults=faults, device=device)
    t = res.merged.src_ip.shape[0]
    merged = [map_fields(lambda n, a: a[i], res.merged) for i in range(t)]
    sent = [map_fields(lambda n, a: a[i], res.sent) for i in range(t)]
    return SimResult(
        merged=merged, state=res.state, sent_to_server=sent,
        counters=res.counters, srv_bytes=res.srv_bytes,
        wire_bytes=res.wire_bytes, ret_bytes=res.ret_bytes,
        telemetry=res.telemetry, nf_counters=res.nf_counters)


def _result(state, chain, chain_states, merged, sent, tel) -> SimResult:
    telemetry = LinkTelemetry(**tel)
    return SimResult(
        merged=merged, state=state, sent_to_server=sent,
        counters=C.as_dict(state.counters),
        srv_bytes=telemetry.srv_bytes, wire_bytes=telemetry.wire_bytes,
        ret_bytes=telemetry.merged_bytes, telemetry=telemetry,
        nf_counters={k: int(v) for k, v in
                     chain.state_counters(chain_states).items()})


def simulate_loop(cfg: ParkConfig, chain: Chain, pkts: PacketBatch,
                  window: int = 1, chunk: int = 256,
                  explicit_drops: bool = False, backend=None, faults=None,
                  fault_pipe: int = 0, device=DEFAULT_DEVICE) -> SimResult:
    """The host-side chunk loop (reference implementation of one pipe).

    One call per chunk per operation plus a host sync for every byte
    tally.  ``faults`` mirrors the engine's fault masks for pipe
    ``fault_pipe``; with ``cfg.recirculation`` the loop mirrors the
    recirculation lane (``_simulate_loop_recirc``).
    """
    backend = as_config(backend)
    dev = resolve_device(device)
    pkts = pkts.to(dev)
    if engine_mod.recirc_slots(cfg, chunk) > 0:
        return _simulate_loop_recirc(cfg, chain, pkts, window, chunk,
                                     explicit_drops, backend, faults,
                                     fault_pipe)
    state = init_state(cfg, dev)
    chain_states = chain.init_state(dev)
    inflight: list = []
    merged: list = []
    sent: list = []
    tel = dict.fromkeys(TEL_FIELDS, 0)  # recirc_* stay 0: lane off

    todo = _chunks(pkts, chunk)
    s_up, l_up, drain = F.pipe_masks(faults, fault_pipe, len(todo))
    for t in range(len(todo) + window):
        if t < len(todo):
            cin = todo[t]
            p, b = _alive_stats(cin)
            tel["wire_pkts"] += p
            tel["wire_bytes"] += b
            state, out = split_fn(cfg, state, cin, backend=backend)
            sent.append(out)
            p, b = _alive_stats(out)
            tel["to_server_pkts"] += p
            tel["to_server_bytes"] += b
            killed, alive = _fault_cut(out.alive, bool(s_up[t]))
            state = dataclasses.replace(
                state, counters=C.bump(state.counters, "fault_drops",
                                       killed.sum()))
            chain_states, nf_out, dropped, _cycles = chain.run(
                chain_states, out.replace(alive=alive), backend=backend,
                ctx={"lb_up": torch.tensor(bool(l_up[t]), device=dev)})
            if explicit_drops:
                nf_out = to_explicit_drops(nf_out, dropped)
            nf_out = to_explicit_drops(nf_out, killed & drain)
            inflight.append(nf_out)
        if t >= window and (t - window) < len(inflight):
            returning = inflight[t - window]
            p, b = _alive_stats(returning)
            tel["from_server_pkts"] += p
            tel["from_server_bytes"] += b
            state, m = merge_fn(cfg, state, returning, backend=backend)
            merged.append(m)
            p, b = _alive_stats(m)
            tel["merged_pkts"] += p
            tel["merged_bytes"] += b
    return _result(state, chain, chain_states, merged, sent, tel)


def _simulate_loop_recirc(cfg, chain, pkts, window, chunk, explicit_drops,
                          backend, faults=None, fault_pipe: int = 0):
    """Host-side mirror of the engine's recirculation timeline: the same op
    order (recirc pass, Split, lane admission, NF, ring, Merge), lane width
    and one drain step.  Padding steps run healthy; lane re-injections
    still traverse the server link on them."""
    dev = pkts.device
    state = init_state(cfg, dev)
    chain_states = chain.init_state(dev)
    lane_w = engine_mod.recirc_slots(cfg, chunk)
    lane = dead_batch(lane_w, cfg.pmax, dev)
    todo = _chunks(pkts, chunk)
    n_real = len(todo)
    s_up_r, l_up_r, drain = F.pipe_masks(faults, fault_pipe, n_real)
    pad_ones = np.ones(window + 1, bool)
    s_up = np.concatenate([s_up_r, pad_ones])
    l_up = np.concatenate([l_up_r, pad_ones])
    dead_in = dead_batch(chunk, cfg.pmax, dev)
    ring = [dead_batch(chunk + lane_w, cfg.pmax, dev)
            for _ in range(max(window, 1))]
    merged: list = []
    sent: list = []
    tel = dict.fromkeys(TEL_FIELDS, 0)

    for t in range(n_real + window + 1):
        cin = todo[t] if t < n_real else dead_in
        p, b = _alive_stats(cin)
        tel["wire_pkts"] += p
        tel["wire_bytes"] += b
        state, rout = recirc_fn(cfg, state, lane, backend=backend)
        state, out = split_fn(cfg, state, cin, backend=backend)
        out, lane, n_denied = engine_mod.recirc_select(cfg, out, lane_w)
        state = dataclasses.replace(
            state, counters=C.bump(state.counters, "recirc_budget_drops",
                                   n_denied))
        p, b = _alive_stats(lane)
        tel["recirc_pkts"] += p
        tel["recirc_bytes"] += b
        nf_in = map_fields(lambda n, x, y: torch.cat([x, y]), rout, out)
        if t <= n_real:
            sent.append(nf_in)
        p, b = _alive_stats(nf_in)
        tel["to_server_pkts"] += p
        tel["to_server_bytes"] += b
        killed, alive = _fault_cut(nf_in.alive, bool(s_up[t]))
        state = dataclasses.replace(
            state, counters=C.bump(state.counters, "fault_drops",
                                   killed.sum()))
        chain_states, nf_out, dropped, _cycles = chain.run(
            chain_states, nf_in.replace(alive=alive), backend=backend,
            ctx={"lb_up": torch.tensor(bool(l_up[t]), device=dev)})
        if explicit_drops:
            nf_out = to_explicit_drops(nf_out, dropped)
        nf_out = to_explicit_drops(nf_out, killed & drain)
        if window == 0:
            returning = nf_out
        else:
            slot = t % window
            returning = ring[slot]
            ring[slot] = nf_out
        p, b = _alive_stats(returning)
        tel["from_server_pkts"] += p
        tel["from_server_bytes"] += b
        state, m = merge_fn(cfg, state, returning, backend=backend)
        if t >= window:
            merged.append(m)
        p, b = _alive_stats(m)
        tel["merged_pkts"] += p
        tel["merged_bytes"] += b
    return _result(state, chain, chain_states, merged, sent, tel)


def baseline_roundtrip(chain: Chain, pkts: PacketBatch, backend=None,
                       device=DEFAULT_DEVICE):
    """Non-PayloadPark reference: packets travel whole through the chain
    (on the same backend as the parking run it is compared against)."""
    dev = resolve_device(device)
    _, out, dropped, cycles = chain.run(chain.init_state(dev), pkts.to(dev),
                                        backend=backend)
    return out, dropped, cycles
