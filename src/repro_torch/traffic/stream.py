"""Chunked trace sources for the streaming driver (port of
``repro.traffic.stream``; DESIGN.md §13).

A ``TraceSource`` is a recipe for a fixed-geometry time-major trace: it
produces any step range ``[start, start + count)`` on demand, so the
streaming driver (``switchsim.stream``) feeds a long run through one
segment of packets at a time.

  * ``MaterializedSource`` wraps an existing (T, chunk, ...) trace; the
    array entry points coerce through it (``as_source``).
  * ``SyntheticSource`` builds chunk ``t`` as a pure function of
    ``(seed, t)``: each step draws from its own CPU ``torch.Generator``
    seeded by a counter hash of ``(seed, t)``, so any segment can be
    regenerated alone and streaming a prefix equals materializing it.
    Flow identity comes from a ``FlowPool`` (a splitmix32 hash of the flow
    index, no per-flow state, sized for millions of flows), and
    ``DiurnalLoad`` sets how many rows of each chunk are offered (the rest
    are all-zero dead rows).

Segments come back on the CPU; the driver moves them to its device, so a
card run and a CPU run see the same packets.  The draws cannot reproduce
the reference's ``jax.random`` streams: parity with the reference goes
through ``MaterializedSource`` on arrays passed in.  The integer hashes
(``splitmix32``, ``FlowPool.identity``) and the load schedule
(``DiurnalLoad.offered``, float32 on the CPU as the reference spells it)
match the reference bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import torch

from repro_torch.core.packet import (FIELDS, PacketBatch, map_fields,
                                     to_time_major)
from repro_torch.traffic.generator import Workload, enterprise

__all__ = [
    "TraceSource", "MaterializedSource", "SyntheticSource", "FlowPool",
    "DiurnalLoad", "as_source", "splitmix32", "mul32", "derived_seed",
]

MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c`` modulo 2**32 for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, from 16-bit halves so no product leaves int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    c_lo, c_hi = c & 0xFFFF, c >> 16
    mid = (a_hi * c_lo + a_lo * c_hi) & 0xFFFF
    return (a_lo * c_lo + (mid << 16)) & MASK32


def splitmix32(x) -> torch.Tensor:
    """The reference's counter-based splitmix mix, uint32 -> uint32, on
    int64 tensors holding the uint32 values (any integer input is taken
    modulo 2**32, as ``astype(uint32)`` takes it)."""
    z = (torch.as_tensor(x).to(torch.int64) & MASK32)
    z = (z + 0x9E3779B9) & MASK32
    z = mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def derived_seed(*words: int) -> int:
    """A generator seed that is a pure function of ``words`` (the
    counterpart of folding data into a ``jax.random`` key)."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h >> 1  # manual_seed takes it as a non-negative int64


@dataclasses.dataclass(frozen=True)
class FlowPool:
    """``n_flows`` deterministic (src_ip, src_port) identities computed
    from the flow index.  Distinct indices may collide on IP with
    probability ~n^2/2^32 (birthday bound); a collision merges two flows'
    NF state and never corrupts parking."""

    n_flows: int
    seed: int = 7

    def __post_init__(self):
        if self.n_flows < 1:
            raise ValueError(f"n_flows must be >= 1, got {self.n_flows}")

    def identity(self, flow: torch.Tensor) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
        """Flow indices -> (src_ip, src_port), int32 each."""
        h = splitmix32((torch.as_tensor(flow).to(torch.int64) & MASK32)
                       ^ splitmix32(self.seed))
        h2 = splitmix32(h)
        ip = ((h & 0x7FFFFFFF) | 1).to(torch.int32)
        port = (1024 + (h2 & 0x7FFF)).to(torch.int32)
        return ip, port


@dataclasses.dataclass(frozen=True)
class DiurnalLoad:
    """Offered load ``load(t)`` in [base - amplitude, base + amplitude]
    following one sinusoidal "day" of ``period`` steps.  Per step the
    first ``round(load * chunk)`` rows of a chunk are offered and the rest
    are dead.  A pure function of ``t``, computed in float32 on the CPU
    with the reference's operations in the reference's order (half-to-even
    rounding), so the schedule is the same on every device."""

    period: int = 4096
    base: float = 0.75
    amplitude: float = 0.25
    phase: float = 0.0

    def __post_init__(self):
        if self.period < 1:
            raise ValueError(f"period must be >= 1, got {self.period}")
        if not 0.0 <= self.base - self.amplitude:
            raise ValueError("load floor (base - amplitude) must be >= 0")
        if self.base + self.amplitude > 1.0 + 1e-9:
            raise ValueError("load peak (base + amplitude) must be <= 1")

    def load(self, t) -> torch.Tensor:
        tf = torch.as_tensor(t).cpu().to(torch.float32)
        ang = 2.0 * math.pi * (tf / self.period) + self.phase
        return self.base + self.amplitude * torch.sin(ang)

    def offered(self, t, chunk: int) -> torch.Tensor:
        return torch.round(self.load(t) * chunk).to(torch.int32)


class TraceSource:
    """A deterministic recipe for a fixed-geometry time-major trace.

    ``chunk``/``pmax`` fix the per-step geometry and ``steps`` its length;
    ``segment(start, count)`` returns the (count, chunk, ...) PacketBatch
    of steps ``[start, start + count)`` and is a pure function of the
    source's fields, so any prefix replays bit for bit."""

    chunk: int
    pmax: int
    steps: int

    @property
    def packets(self) -> int:
        return self.steps * self.chunk

    def segment(self, start: int, count: int) -> PacketBatch:
        raise NotImplementedError

    def __iter__(self) -> Iterator[PacketBatch]:
        for t in range(self.steps):
            yield self.segment(t, 1)

    def materialize(self, steps: int | None = None) -> PacketBatch:
        """The (steps, chunk, ...) time-major trace the materialized engine
        runs; streaming this source equals running its materialization."""
        n = self.steps if steps is None else steps
        if not 0 <= n <= self.steps:
            raise ValueError(f"steps {n} outside [0, {self.steps}]")
        return self.segment(0, n)

    def _check_range(self, start: int, count: int) -> None:
        if not 0 <= start <= start + count <= self.steps:
            raise ValueError(
                f"segment [{start}, {start + count}) outside "
                f"[0, {self.steps})")


@dataclasses.dataclass
class MaterializedSource(TraceSource):
    """The trivial source: an already-built (T, chunk, ...) trace."""

    trace: PacketBatch

    def __post_init__(self):
        self.steps = int(self.trace.src_ip.shape[0])
        self.chunk = int(self.trace.src_ip.shape[1])
        self.pmax = int(self.trace.pmax)

    def segment(self, start: int, count: int) -> PacketBatch:
        self._check_range(start, count)
        return map_fields(lambda n, a: a[start:start + count], self.trace)

    @classmethod
    def from_flat(cls, pkts: PacketBatch, chunk: int) -> "MaterializedSource":
        return cls(to_time_major(pkts, chunk))


# fold-in tags of the reference (``jax.random.fold_in(key, tag)``)
_FLOW_TAG = 0xF10


@dataclasses.dataclass
class SyntheticSource(TraceSource):
    """Streaming workload generator: chunk ``t`` = f(seed, t).

    Step ``t`` draws a fresh ``workload`` chunk from a generator seeded by
    ``derived_seed(seed, t)``; ``flows`` (a FlowPool or a flow count)
    rewrites the source identity from the pool with indices drawn from a
    second generator (``derived_seed(seed, t, 0xF10)``); ``load`` (a
    DiurnalLoad) keeps the first ``load.offered(t)`` rows and zeroes the
    dead tail in every field, so the offered trace is canonical."""

    steps: int
    chunk: int = 256
    pmax: int = 2048
    seed: int = 0
    workload: Workload = None
    flows: "FlowPool | int | None" = None
    load: DiurnalLoad | None = None

    def __post_init__(self):
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if self.workload is None:
            self.workload = enterprise()
        if isinstance(self.flows, int):
            self.flows = FlowPool(self.flows, seed=self.seed + 7)

    def _one_step(self, t: int) -> PacketBatch:
        gen = torch.Generator().manual_seed(derived_seed(self.seed, t))
        pkts = self.workload.make_batch(gen, self.chunk, pmax=self.pmax,
                                        device="cpu")
        if self.flows is not None:
            gf = torch.Generator().manual_seed(
                derived_seed(self.seed, t, _FLOW_TAG))
            idx = torch.randint(0, self.flows.n_flows, (self.chunk,),
                                generator=gf)
            ip, port = self.flows.identity(idx)
            pkts = pkts.replace(src_ip=ip, src_port=port)
        if self.load is not None:
            offered = int(self.load.offered(t, self.chunk))
            for name in FIELDS:
                getattr(pkts, name)[offered:] = 0
        return pkts

    def segment(self, start: int, count: int) -> PacketBatch:
        self._check_range(start, count)
        steps = [self._one_step(t) for t in range(start, start + count)]
        if not steps:  # an empty (0, chunk, ...) trace
            return map_fields(lambda n, a: a[None][:0], self._one_step(0))
        return map_fields(lambda n, *xs: torch.stack(xs), *steps)


def as_source(trace, chunk: int | None = None) -> TraceSource:
    """Coerce the trace spellings every engine entry point accepts: a
    TraceSource passes through; a time-major (T, chunk, ...) PacketBatch
    becomes a MaterializedSource; a flat (B, ...) batch needs ``chunk``."""
    if isinstance(trace, TraceSource):
        return trace
    if isinstance(trace, PacketBatch):
        if trace.src_ip.dim() == 2:
            return MaterializedSource(trace)
        if trace.src_ip.dim() == 1:
            if chunk is None:
                raise ValueError(
                    "flat packet batch needs an explicit chunk size")
            return MaterializedSource.from_flat(trace, chunk)
        raise ValueError(
            f"expected a flat batch or a time-major trace, got a "
            f"{trace.src_ip.dim()}-dim PacketBatch")
    raise TypeError(
        f"trace must be a TraceSource or PacketBatch, got "
        f"{type(trace).__name__}")
