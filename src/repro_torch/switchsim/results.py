"""Result dataclasses of the simulation entry points (port of
``repro.switchsim.results``): ``run_engine``, ``run_pipes``, the host loop
and the streaming driver.  ``flat_summary`` is the shared flat view every
``summary()`` returns."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.packet import PacketBatch
from repro_torch.core.park import ParkState
from repro_torch.switchsim.telemetry import LinkTelemetry

__all__ = ["EngineResult", "PipesResult", "SimResult", "StreamResult",
           "flat_summary"]


def flat_summary(counters: dict, telemetry: LinkTelemetry | None, *,
                 peak_occupancy: int | None = None,
                 nf_counters: dict | None = None,
                 latency: dict | None = None) -> dict:
    """Counters by name, byte totals, ``tel_<field>`` telemetry, peak
    occupancy, NF-private counters and the streaming tail-latency block
    (``p50_us``/``p99_us``/``p999_us``/``latency_samples``), as one flat
    dict."""
    out = {k: int(v) for k, v in counters.items()}
    if telemetry is not None:
        out["wire_bytes"] = telemetry.wire_bytes
        out["srv_bytes"] = telemetry.srv_bytes
        out["srv_fwd_bytes"] = telemetry.to_server_bytes
        out["ret_bytes"] = telemetry.merged_bytes
        out.update({f"tel_{k}": int(v)
                    for k, v in telemetry.as_dict().items()})
    if peak_occupancy is not None:
        out["peak_occupancy"] = int(peak_occupancy)
    if nf_counters:
        out.update({k: int(v) for k, v in nf_counters.items()})
    if latency:
        out.update({k: latency[k] for k in
                    ("p50_us", "p99_us", "p999_us") if k in latency})
        if "samples" in latency:
            out["latency_samples"] = int(latency["samples"])
    return out


@dataclasses.dataclass
class EngineResult:
    """Result of one engine run (single pipe unless noted).

    ``merged``: (T, chunk, ...) time-major merged output in arrival order.
    ``sent``: (T, chunk, ...) NF-bound traffic, or None if not collected.
    ``state``: final ParkState (leading pipe axis when multi-pipe).
    Byte totals are exact Python ints; ``srv_bytes`` covers both server
    link directions, ``srv_fwd_bytes`` switch -> server alone,
    ``ret_bytes`` what Merge put back on the wire.  ``occ_series`` holds
    the live parked slots after each step's Merge; ``nf_counters`` the
    NF-private counters of the final chain state.
    """

    merged: PacketBatch
    sent: PacketBatch | None
    state: ParkState
    counters: dict
    srv_bytes: int
    srv_fwd_bytes: int
    wire_bytes: int
    ret_bytes: int
    peak_occupancy: int
    telemetry: LinkTelemetry
    occ_series: np.ndarray = None
    nf_counters: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        return flat_summary(self.counters, self.telemetry,
                            peak_occupancy=self.peak_occupancy,
                            nf_counters=self.nf_counters)


@dataclasses.dataclass
class PipesResult(EngineResult):
    """Aggregated multi-pipe result with per-pipe breakdowns.
    ``merged``/``sent`` keep the leading pipe axis: (P, T, chunk, ...)."""

    per_pipe_counters: list[dict] = dataclasses.field(default_factory=list)
    per_pipe_srv_bytes: list[int] = dataclasses.field(default_factory=list)
    per_pipe_wire_bytes: list[int] = dataclasses.field(default_factory=list)
    per_pipe_telemetry: list[LinkTelemetry] = dataclasses.field(
        default_factory=list)
    per_pipe_peak_occupancy: list[int] = dataclasses.field(
        default_factory=list)
    per_pipe_occ_series: np.ndarray = None
    per_pipe_nf_counters: list[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimResult:
    """The list-of-chunks view (``simulate`` / ``simulate_loop``)."""

    merged: list            # list[PacketBatch] in arrival order
    state: ParkState
    sent_to_server: list    # list[PacketBatch] (post-split, pre-NF)
    counters: dict
    srv_bytes: int
    wire_bytes: int
    ret_bytes: int
    telemetry: LinkTelemetry
    nf_counters: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        return flat_summary(self.counters, self.telemetry,
                            nf_counters=self.nf_counters)


@dataclasses.dataclass
class StreamResult:
    """Result of a streaming run (``switchsim.stream.run_stream``).

    No merged or sent traffic is kept: the final switch state, the exact
    counters, telemetry and NF counters (equal to the materialized
    engine's over the same steps), the reservoir-sampled sojourn times
    (``latency``: p50/p99/p999 in µs and the sample counts) and one
    occupancy summary per segment (``occ_segments``: ``start``, ``steps``,
    ``min``, ``mean``, ``max``, ``last``).
    """

    state: ParkState
    counters: dict
    telemetry: LinkTelemetry
    nf_counters: dict
    peak_occupancy: int
    latency: dict
    occ_segments: list[dict]
    steps: int
    segments: int
    segment_len: int

    @property
    def wire_bytes(self) -> int:
        return self.telemetry.wire_bytes

    @property
    def srv_bytes(self) -> int:
        return self.telemetry.srv_bytes

    @property
    def srv_fwd_bytes(self) -> int:
        return self.telemetry.to_server_bytes

    @property
    def ret_bytes(self) -> int:
        return self.telemetry.merged_bytes

    def summary(self) -> dict:
        return flat_summary(self.counters, self.telemetry,
                            peak_occupancy=self.peak_occupancy,
                            nf_counters=self.nf_counters,
                            latency=self.latency)
