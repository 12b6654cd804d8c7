"""Workload generation mirroring the paper's PktGen setup (port of part of
``repro.traffic.generator``; §6.1, Fig. 6).

  * ``fixed(size)`` — fixed-size UDP packets;
  * ``enterprise()`` — the bimodal Benson et al. enterprise mix (~30 % of
    packets under 160 B of payload, mean ~880 B);
  * ``datacenter()`` — the DC-side mix of the same study.

Draws use a CPU ``torch.Generator``, so one seed gives the same packets on
every device (they cannot reproduce ``jax.random``'s draws; parity tests
feed both packages numpy-built inputs instead).  ``flow_hash`` and
``steer_pipes`` are integer hashes and match the reference bit for bit.

The adversarial and churn workloads wait for a later slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.packet import (HDR_BYTES, PacketBatch, gather_rows,
                                     make_udp_batch, to_time_major)
from repro_torch.device import DEFAULT_DEVICE, resolve_device

ENTERPRISE_SIZES = np.array([64, 128, 190, 512, 1024, 1492], np.int32)
ENTERPRISE_PROBS = np.array([0.10, 0.12, 0.08, 0.12, 0.18, 0.40])
DATACENTER_SIZES = np.array([64, 128, 256, 595, 1024, 1492], np.int32)
DATACENTER_PROBS = np.array([0.35, 0.10, 0.05, 0.05, 0.10, 0.35])


def _generator(gen: torch.Generator | int) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    sizes: np.ndarray   # candidate total packet sizes (bytes)
    probs: np.ndarray   # selection probabilities

    @property
    def mean_pkt_bytes(self) -> float:
        return float((self.sizes * self.probs).sum())

    def sample_sizes(self, gen: torch.Generator | int, n: int) -> torch.Tensor:
        idx = torch.multinomial(torch.as_tensor(self.probs, dtype=torch.float64),
                                n, replacement=True, generator=_generator(gen))
        return torch.as_tensor(self.sizes)[idx]

    def make_batch(self, gen: torch.Generator | int, n: int, pmax: int = 2048,
                   device=DEFAULT_DEVICE, **field_overrides) -> PacketBatch:
        gen = _generator(gen)
        sizes = self.sample_sizes(gen, n)
        return make_udp_batch(gen, n, sizes, pmax=pmax, device=device,
                              **field_overrides)


def fixed(size: int) -> Workload:
    if size < HDR_BYTES:
        raise ValueError(f"size {size} is below the {HDR_BYTES}-byte header")
    return Workload(f"fixed{size}", np.array([size], np.int32),
                    np.array([1.0]))


def enterprise() -> Workload:
    return Workload("enterprise", ENTERPRISE_SIZES, ENTERPRISE_PROBS)


def datacenter() -> Workload:
    return Workload("datacenter", DATACENTER_SIZES, DATACENTER_PROBS)


def flow_pool(n_flows: int, seed: int = 7,
              device=DEFAULT_DEVICE) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_flows`` distinct (src_ip, src_port) flows drawn from ``seed``:
    (n_flows,) int32 each."""
    if n_flows < 1:
        raise ValueError(f"n_flows must be >= 1, got {n_flows}")
    gen = _generator(seed)
    ips = torch.randint(1, (1 << 31) - 1, (n_flows,), generator=gen,
                        dtype=torch.int64).to(torch.int32)
    ports = torch.randint(1024, 65536, (n_flows,), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    if torch.unique(ips).numel() != n_flows:
        raise ValueError("flow pool drew a duplicate source IP; pick "
                         "another seed")
    dev = resolve_device(device)
    return ips.to(dev), ports.to(dev)


def flow_hash(pkts: PacketBatch) -> torch.Tensor:
    """Avalanche hash of the flow 5-tuple, (...,) non-negative int32; the
    multiplies wrap like uint32 and ``>>`` is arithmetic."""
    h = pkts.src_ip ^ -1640531527
    h = (h * -2048144789) ^ pkts.dst_ip
    h = h ^ (h >> 13)
    h = (h * -1028477379) ^ (pkts.src_port * 65536) ^ pkts.dst_port
    h = h ^ (h >> 16)
    h = (h * -2048144789) ^ pkts.proto
    h = h ^ (h >> 13)
    return h & 0x7FFFFFFF


def pipe_trace_steps(packets: int, pipes: int, chunk: int) -> int:
    """Per-pipe engine steps after steering — mirrors ``steer_pipes``'s
    default pipe-capacity rounding (~1.25x fair share, up to ``chunk``)."""
    if pipes == 1:
        return packets // chunk
    fair = -(-packets // pipes)
    slack = (fair * 5) // 4
    return -(-slack // chunk)


def steer_pipes(pkts: PacketBatch, num_pipes: int,
                pipe_capacity: int | None = None,
                chunk: int = 256) -> tuple[PacketBatch, dict]:
    """Shard a flat batch into per-pipe batches by flow hash (§6.3.2).

    Returns ``(shards, stats)`` with shard fields shaped
    (num_pipes, pipe_capacity, ...).  Slots past a pipe's arrivals are
    dead; arrivals past ``pipe_capacity`` are dropped and counted in
    ``stats['overflow']``.  Arrival order is kept within a pipe.
    """
    b = pkts.batch_size
    dev = pkts.device
    pipe = torch.remainder(flow_hash(pkts), num_pipes).to(torch.int64)
    if pipe_capacity is None:
        fair = -(-b // num_pipes)
        slack = fair if num_pipes == 1 else (fair * 5) // 4
        pipe_capacity = -(-slack // chunk) * chunk
    onehot = pipe[:, None] == torch.arange(num_pipes, device=dev)[None, :]
    pos = torch.cumsum(onehot.to(torch.int64), dim=0) - 1
    pos = torch.gather(pos, 1, pipe[:, None])[:, 0]
    ok = pos < pipe_capacity
    total = num_pipes * pipe_capacity
    # Invert the permutation; slot ``total`` is the sink of overflow rows,
    # and empty slots gather the dead row ``b``.
    dest = torch.where(ok, pipe * pipe_capacity + pos, total)
    src_of = torch.full((total + 1,), b, dtype=torch.int64, device=dev)
    src_of.scatter_(0, dest, torch.arange(b, device=dev))
    shards = to_time_major(gather_rows(pkts, src_of[:total]), pipe_capacity)
    counts = onehot.sum(dim=0).cpu().tolist()
    stats = dict(
        per_pipe_arrivals=[int(c) for c in counts],
        overflow=int((~ok).sum()),
        pipe_capacity=pipe_capacity,
    )
    return shards, stats
