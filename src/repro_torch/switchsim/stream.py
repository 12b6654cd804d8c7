"""Streaming steady-state driver: constant-memory runs over chunked sources
(port of ``repro.switchsim.stream``; DESIGN.md §13).

The materialized engine keeps the whole trace, its merged output and every
per-step tally, which caps a run at what fits in memory.  ``run_stream``
is the long-haul path:

  * The trace arrives as a ``traffic.stream.TraceSource``; one
    ``segment_len``-step slice of packets is on the device at a time.
  * The per-step body is ``engine.scan_step``, the same function the
    materialized engine runs, and the whole carry (switch state, NF-chain
    states, in-flight ring with its Python step index, recirculation lane)
    passes from segment to segment untouched, so a streamed run equals the
    materialized run over the same steps (``replay_oracle``).
  * What survives a step stays on the device: a ``reservoir``-slot sample
    of sojourn times (int32) and its sample count, and the step's
    telemetry tallies and occupancy.  Once per segment the
    (len(TEL_FIELDS),) telemetry sums and the segment's occupancy series
    come to the host, where the sums accumulate in int64 and the series
    shrinks to min/mean/max/last.

Latency model (as the reference records it): the simulator is
step-quantized, so a packet's sojourn is reconstructed.  A packet split at
step ``t`` merges at ``t + window``; the paper puts the split -> merge
dwell at ~30 us (§4), so one step is ``30 us / window`` and a merged row
spends ``window`` steps, ``window + 1`` for the rows that took the
recirculation lane (lane rows lead each merged chunk).  Serialization adds
0.8 ns/byte (10 Gbps).  All integer ns.

The reservoir is Algorithm R with a counter-based splitmix32 coin: sample
number ``m`` lands in slot ``m`` while filling, then in slot
``splitmix32(seed ^ m * phi) % (m + 1)`` (kept only if ``< K``).  Within a
step, slot conflicts resolve to the last row (a scatter-max over row
indices, which is order-independent and so the same on every device):
exactly sequential Algorithm R under that coin.

Faults are not supported on this path (healthy masks only); use
``run_engine``/``run_pipes`` for fault studies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend.config import as_config
from repro_torch.core import counters as C
from repro_torch.core.packet import dead_batch, map_fields
from repro_torch.core.park import ParkConfig, ParkState
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import Chain
from repro_torch.switchsim.engine import (_per_pipe_nf_counters, _to_host,
                                          init_carry, recirc_slots, run_pipes,
                                          scan_step)
from repro_torch.switchsim.results import StreamResult
from repro_torch.switchsim.telemetry import TEL_FIELDS, LinkTelemetry
from repro_torch.traffic.stream import (MASK32, MaterializedSource,
                                        SyntheticSource, TraceSource,
                                        as_source, mul32, splitmix32)

__all__ = ["run_stream", "replay_oracle", "StreamOracleMismatch",
           "sojourn_ns", "step_ns_for", "SPLIT_MERGE_NS"]

# Paper §4: the split -> merge dwell of a parked payload, ~30 us end to
# end; the engine spreads it over ``window`` steps.
SPLIT_MERGE_NS = 30_000
_PHI32 = 0x9E3779B9


def step_ns_for(window: int) -> int:
    """Integer ns one engine step stands for under the §4 dwell model."""
    return max(1, round(SPLIT_MERGE_NS / max(window, 1)))


def sojourn_ns(pkt_len, recirculated, window: int,
               step_ns: int) -> torch.Tensor:
    """Reconstructed per-packet sojourn in integer ns (int32): dwell steps
    (``window``, + 1 for a recirculation-lane pass) plus 0.8 ns/byte."""
    steps = window + torch.as_tensor(recirculated).to(torch.int32)
    plen = torch.as_tensor(pkt_len).to(torch.int32)
    return steps * step_ns + torch.div(plen * 4, 5, rounding_mode="floor")


def _reservoir_insert(vals: torch.Tensor, n: torch.Tensor,
                      sample: torch.Tensor, alive: torch.Tensor, seed: int):
    """One step's samples through Algorithm R, sequential semantics.

    ``vals`` is the (K,) int32 reservoir and ``n`` the (int64, 0-d) count
    of samples seen so far, ``sample``/``alive`` the step's (rows,)
    candidates.  Sample number ``m`` goes to slot ``m`` while ``m < K``,
    else to ``splitmix32(seed ^ m * phi) % (m + 1)``, kept if below K; the
    last row wins a slot, as if the rows went in one at a time.  The
    uint32 arithmetic runs in int64 under explicit masks.
    """
    k = vals.shape[0]
    rows = alive.shape[0]
    pos = torch.cumsum(alive.to(torch.int64), 0) - 1
    m = n + pos  # global sample number of each alive row
    h = splitmix32((seed & MASK32) ^ mul32(m & MASK32, _PHI32))
    j = torch.where(m < k, m, torch.remainder(h, torch.clamp(m + 1, min=1)))
    dest = torch.where(alive & (j < k), j, k)
    winner = torch.full((k + 1,), -1, dtype=torch.int64, device=vals.device)
    winner.scatter_reduce_(0, dest, torch.arange(rows, device=vals.device),
                           "amax")
    winner = winner[:k]
    take = winner >= 0
    vals = torch.where(take, sample[winner.clamp(min=0)], vals)
    return vals, n + alive.sum()


def _occ_summary(start: int, occ: np.ndarray) -> dict:
    return dict(start=int(start), steps=int(occ.shape[0]),
                min=int(occ.min()), mean=float(occ.mean()),
                max=int(occ.max()), last=int(occ[-1]))


def _quantiles_us(vals: np.ndarray, n: int) -> dict:
    """Tail-latency block from the reservoir: nearest-rank quantiles of the
    valid prefix (slots fill in order while n < K), in µs."""
    k = vals.shape[0]
    out = dict(samples=int(n), reservoir=int(k))
    valid = np.sort(vals[:min(n, k)].astype(np.int64))
    if valid.size:
        for name, q in (("p50_us", 0.50), ("p99_us", 0.99),
                        ("p999_us", 0.999)):
            out[name] = float(np.quantile(valid, q, method="nearest")) / 1e3
    return out


@dataclasses.dataclass
class _Segments:
    """The step body and the device-resident state of one stream: the
    engine carry, the reservoir and its sample count."""

    step: object
    carry: tuple
    vals: torch.Tensor
    n: torch.Tensor
    up: torch.Tensor        # (1,) True: healthy server and LB masks
    drain: torch.Tensor     # (1,) False
    lane_rows: torch.Tensor  # (rows,) bool: the recirculation lane's rows
    window: int
    step_ns: int
    res_seed: int

    def run(self, chunks) -> np.ndarray:
        """Run a (count, chunk, ...) slice on the device; returns the
        slice's telemetry sums followed by its occupancy series (int64),
        the one transfer to the host per segment."""
        tels, occs = [], []
        for i in range(chunks.src_ip.shape[0]):
            cin = map_fields(lambda _n, a: a[i][None], chunks)
            self.carry, ys = self.step(self.carry, (cin, self.up, self.up),
                                       self.drain)
            m = ys["merged"]
            sample = sojourn_ns(m.pkt_len()[0], self.lane_rows, self.window,
                                self.step_ns)
            self.vals, self.n = _reservoir_insert(
                self.vals, self.n, sample, m.alive[0], self.res_seed)
            tels.append(torch.cat([ys[f] for f in TEL_FIELDS]))
            occs.append(ys["occ"])
        tel = torch.stack(tels).sum(0)
        occ = torch.cat(occs).to(torch.int64)
        return _to_host(torch.cat([tel, occ])).numpy()


def run_stream(
    cfg: ParkConfig,
    chain: Chain,
    source,
    window: int = 1,
    segment_len: int = 256,
    explicit_drops: bool = False,
    backend=None,
    reservoir: int = 4096,
    reservoir_seed: int = 0x5EED,
    device=DEFAULT_DEVICE,
) -> StreamResult:
    """Run one pipe over a ``TraceSource`` at constant memory.

    The source is consumed ``segment_len`` steps at a time, each segment
    moved to ``device`` and run through ``engine.scan_step`` with the carry
    handed on; after the last segment a drain pad of dead chunks flushes
    the in-flight window (and the recirculation lane) as the materialized
    engine's padding does.  Counters, telemetry, nf_counters and peak
    occupancy equal ``run_engine(cfg, chain, source.materialize(), ...)``
    (``replay_oracle``).  On top, the result keeps a ``reservoir``-slot
    sample of sojourn times (p50/p99/p999 in ``latency``) and one
    occupancy summary per segment (``occ_segments``).
    """
    backend = as_config(backend)
    dev = resolve_device(device)
    source = as_source(source)
    if source.steps < 1:
        raise ValueError("streaming needs a source with >= 1 step")
    if segment_len < 1:
        raise ValueError(f"segment_len must be >= 1, got {segment_len}")
    if reservoir < 1:
        raise ValueError(f"reservoir must be >= 1, got {reservoir}")
    chunk = source.chunk
    # The reference keeps per-segment telemetry sums in int32 and bounds
    # the worst-case byte sum (every row alive at max frame size) under
    # 2^31; the same arguments are refused here.
    if segment_len * chunk * (source.pmax + 64) >= 2**31:
        raise ValueError(
            f"segment_len {segment_len} overflows int32 telemetry "
            f"(chunk={chunk}, pmax={source.pmax}); use shorter segments")
    lane = recirc_slots(cfg, chunk)
    pad = window + (1 if lane else 0)
    rows = chunk + lane
    seg = _Segments(
        step=scan_step(cfg, chain, window, explicit_drops, backend,
                       collect_sent=False, recirc=lane),
        carry=init_carry(cfg, chain, 1, chunk, window, lane, dev),
        vals=torch.zeros((reservoir,), dtype=torch.int32, device=dev),
        n=torch.zeros((), dtype=torch.int64, device=dev),
        up=torch.ones((1,), dtype=torch.bool, device=dev),
        drain=torch.zeros((1,), dtype=torch.bool, device=dev),
        lane_rows=torch.arange(rows, device=dev) < lane,
        window=window, step_ns=step_ns_for(window),
        res_seed=reservoir_seed)
    nt = len(TEL_FIELDS)
    tel_total = np.zeros((nt,), np.int64)
    occ_segments: list[dict] = []
    peak = 0
    n_segments = 0
    starts = list(range(0, source.steps, segment_len))
    for start in starts + [source.steps]:
        if start < source.steps:
            count = min(segment_len, source.steps - start)
            chunks = source.segment(start, count).to(dev)
            n_segments += 1
        elif pad:
            chunks = dead_batch(chunk, cfg.pmax, dev, (pad,))
        else:
            break
        host = seg.run(chunks)
        del chunks  # one segment of packets on the device at a time
        tel_total += host[:nt]
        occ = host[nt:]
        occ_segments.append(_occ_summary(start, occ))
        peak = max(peak, int(occ.max()))
    state, cstates = seg.carry[0], seg.carry[1]
    state = ParkState(**{f.name: getattr(state, f.name)[0]
                         for f in dataclasses.fields(ParkState)})
    tel = LinkTelemetry(**{f: int(v) for f, v in zip(TEL_FIELDS, tel_total)})
    return StreamResult(
        state=state,
        counters=C.as_dict(state.counters),
        telemetry=tel,
        nf_counters=_per_pipe_nf_counters(chain, cstates, 1)[0],
        peak_occupancy=peak,
        latency=_quantiles_us(_to_host(seg.vals).numpy(),
                              int(_to_host(seg.n))),
        occ_segments=occ_segments,
        steps=source.steps,
        segments=n_segments,
        segment_len=segment_len,
    )


class StreamOracleMismatch(AssertionError):
    """Streaming and materialized engines disagreed on exact facts."""


def _prefix_source(source: TraceSource, steps: int) -> TraceSource:
    """The same source truncated to its first ``steps`` steps, without
    materializing when the source can re-scope itself."""
    if steps == source.steps:
        return source
    if not 0 < steps <= source.steps:
        raise ValueError(f"prefix {steps} outside (0, {source.steps}]")
    if isinstance(source, SyntheticSource):
        # chunk t is a pure function of (seed, t): a shorter source keeps
        # the steps that remain
        return dataclasses.replace(source, steps=steps)
    return MaterializedSource(source.segment(0, steps))


def replay_oracle(
    cfg: ParkConfig,
    chain: Chain,
    source,
    window: int = 1,
    segment_len: int = 64,
    segments: int = 4,
    explicit_drops: bool = False,
    backend=None,
    device=DEFAULT_DEVICE,
) -> dict:
    """The segment-replay gate: stream the first ``segments`` segments of
    ``source`` and run the materialized engine (``run_pipes``, one pipe)
    over the same steps; counters, per-link telemetry, NF counters and
    peak occupancy must match exactly.  Raises ``StreamOracleMismatch``
    naming every differing fact; returns a small report when clean."""
    source = as_source(source)
    steps = min(source.steps, segment_len * segments)
    prefix = _prefix_source(source, steps)
    sres = run_stream(cfg, chain, prefix, window=window,
                      segment_len=segment_len, explicit_drops=explicit_drops,
                      backend=backend, device=device)
    mres = run_pipes(cfg, chain, prefix, window=window,
                     explicit_drops=explicit_drops, backend=backend,
                     device=device)
    diffs = []
    for name, a, b in (("counters", sres.counters, mres.counters),
                       ("telemetry", sres.telemetry.as_dict(),
                        mres.telemetry.as_dict()),
                       ("nf_counters", sres.nf_counters, mres.nf_counters)):
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                diffs.append(f"{name}.{k}: stream={a.get(k)} "
                             f"materialized={b.get(k)}")
    if sres.peak_occupancy != mres.peak_occupancy:
        diffs.append(f"peak_occupancy: stream={sres.peak_occupancy} "
                     f"materialized={mres.peak_occupancy}")
    if diffs:
        raise StreamOracleMismatch(
            f"segment replay diverged over {steps} steps "
            f"({len(diffs)} facts):\n  " + "\n  ".join(diffs))
    return dict(steps=steps, packets=steps * source.chunk,
                segments=min(segments, -(-steps // segment_len)),
                wire_bytes=sres.wire_bytes)
