"""Workload generation mirroring the paper's PktGen setup (port of part of
``repro.traffic.generator``; §6.1, Fig. 6).

  * ``fixed(size)`` — fixed-size UDP packets;
  * ``enterprise()`` — the bimodal Benson et al. enterprise mix (~30 % of
    packets under 160 B of payload, mean ~880 B);
  * ``datacenter()`` — the DC-side mix of the same study;
  * ``adversarial(...)`` — a base mix with a burst-structured storm of
    208-byte spoofed-source packets to one victim (DESIGN.md §10);
  * ``churn(...)`` — a base mix whose flow population slides over time.

Draws use a CPU ``torch.Generator``, so one seed gives the same packets on
every device (they cannot reproduce ``jax.random``'s draws; parity tests
feed both packages numpy-built inputs instead).  Where the reference folds
a tag into its key for a second stream (the storm's draws, the churn
flows), the port seeds a second generator from a hash of the first one's
state and the tag, without advancing the first.  ``flow_hash``,
``steer_pipes`` and ``_flow_identity`` are integer hashes and match the
reference bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib

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


def _fold(gen: torch.Generator, tag: int) -> torch.Generator:
    """A second generator seeded by a hash of ``gen``'s state and ``tag``
    (the counterpart of ``jax.random.fold_in``); ``gen`` does not move."""
    h = hashlib.blake2b(gen.get_state().numpy().tobytes(), digest_size=8,
                        key=int(tag).to_bytes(8, "little"))
    return torch.Generator().manual_seed(
        int.from_bytes(h.digest(), "little") >> 1)


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    sizes: np.ndarray   # candidate total packet sizes (bytes)
    probs: np.ndarray   # selection probabilities

    @property
    def mean_pkt_bytes(self) -> float:
        return float((self.sizes * self.probs).sum())

    def splittable_share(self, min_park_len: int = 160,
                         park_bytes: int = 160) -> float:
        """Fraction of offered wire bytes Split can park: expected parked
        bytes over expected packet bytes (DESIGN.md §7)."""
        parked = sum(
            p * min(s - HDR_BYTES, park_bytes)
            for s, p in zip(self.sizes, self.probs)
            if s - HDR_BYTES >= min_park_len)
        return float(parked) / self.mean_pkt_bytes

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


# --------------------------------------------------------------------------
# Adversarial and churn workloads (DESIGN.md §10)
# --------------------------------------------------------------------------

# Attack packets spoof the source and converge on one victim service (a
# SYN-flood shape), sized just past the parking threshold so each one
# claims a table slot while parking few useful bytes.
VICTIM_IP = 0x0A00FFFE
VICTIM_PORT = 80
ATTACK_SIZE = 208  # 166 B payload: minimally splittable (>= 160 + HDR 42)
_ATTACK_TAG = 0x5ADF
_CHURN_TAG = 0xC4


@dataclasses.dataclass(frozen=True)
class AdversarialWorkload(Workload):
    """Base traffic with a burst-structured small-packet storm overlaid.

    ``attack_fraction`` of the batch's burst slots (runs of ``burst``
    packets) carry attack packets: spoofed random sources, one victim
    destination, ``attack_size`` bytes.  Each burst slot draws one
    permutation rank, independent of the fraction, and attacks iff its
    rank falls below the fraction's cut: a higher fraction only adds
    attack slots, and ``attack_fraction=0`` is bit-identical to the base
    workload (the storm draws from a second generator, ``_fold``).
    """

    base: Workload = None
    attack_fraction: float = 0.0
    burst: int = 32
    attack_size: int = ATTACK_SIZE

    def attack_mask(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """(n,) bool: the rows of attack burst slots, from ``gen`` (the
        storm's generator)."""
        n_slots = -(-n // self.burst)
        rank = torch.randperm(n_slots, generator=gen)
        n_attack = int(round(self.attack_fraction * n_slots))
        return rank[torch.arange(n) // self.burst] < n_attack

    def make_batch(self, gen: torch.Generator | int, n: int, pmax: int = 2048,
                   device=DEFAULT_DEVICE, **field_overrides) -> PacketBatch:
        gen = _generator(gen)
        storm = _fold(gen, _ATTACK_TAG)
        sizes = self.base.sample_sizes(gen, n)
        mask = self.attack_mask(storm, n)
        sizes = torch.where(mask, self.attack_size, sizes).to(torch.int32)
        pkts = make_udp_batch(gen, n, sizes, pmax=pmax, device="cpu",
                              **field_overrides)
        spoof_ip = torch.randint(1 << 28, (1 << 31) - 1, (n,), generator=storm,
                                 dtype=torch.int64).to(torch.int32)
        spoof_port = torch.randint(1024, 65536, (n,), generator=storm,
                                   dtype=torch.int64).to(torch.int32)
        pkts = pkts.replace(
            src_ip=torch.where(mask, spoof_ip, pkts.src_ip),
            src_port=torch.where(mask, spoof_port, pkts.src_port),
            dst_ip=torch.where(mask, VICTIM_IP, pkts.dst_ip).to(torch.int32),
            dst_port=torch.where(mask, VICTIM_PORT,
                                 pkts.dst_port).to(torch.int32))
        return pkts.to(resolve_device(device))


def _named_base(base: str | Workload) -> Workload:
    if isinstance(base, str):
        return {"enterprise": enterprise, "datacenter": datacenter}[base]()
    return base


def adversarial(base: str | Workload = "enterprise",
                attack_fraction: float = 0.5, burst: int = 32,
                attack_size: int = ATTACK_SIZE) -> AdversarialWorkload:
    """Small-packet-storm workload (attack-fraction x burst axes)."""
    base = _named_base(base)
    frac = float(attack_fraction)
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"attack_fraction must be in [0, 1], got {frac}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    if attack_size - HDR_BYTES < 160:
        raise ValueError(
            f"attack_size {attack_size} is not splittable (payload < 160)")
    # the mixture view for the analytic helpers (mean bytes, share)
    sizes = np.append(base.sizes, np.int32(attack_size))
    probs = np.append(base.probs * (1.0 - frac), frac)
    return AdversarialWorkload(
        name=f"adv_{base.name}_f{int(round(frac * 100)):02d}_b{burst}",
        sizes=sizes, probs=probs, base=base, attack_fraction=frac,
        burst=int(burst), attack_size=int(attack_size))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x)


def _flow_identity(flow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Flow index -> (src_ip, src_port), the reference's murmur-style
    int32 mix: wrapping multiplies (in int64, masked) and arithmetic
    shifts."""
    h = _wrap32(torch.as_tensor(flow).to(torch.int64) * -2048144789)
    h = h ^ (h >> 13)
    h = _wrap32(h * -1028477379)
    h = h ^ (h >> 16)
    ip = ((h & 0x7FFFFFFF) | 1).to(torch.int32)
    port = (1024 + ((h >> 7) & 0x7FFF)).to(torch.int32)
    return ip, port


@dataclasses.dataclass(frozen=True)
class ChurnWorkload(Workload):
    """Base traffic whose flow population slides over time: packets draw
    flows uniformly from a ``pool``-wide window that advances by
    ``pool // 2`` every ``rotate`` packets (half-overlapping windows), so
    each flow is live across two windows and then never returns.  With a
    NAT table smaller than the live window, mappings age out while their
    flows still send (``nat_stale_hits``)."""

    base: Workload = None
    pool: int = 256
    rotate: int = 1024

    def flows(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """(n,) int64 flow indices of a batch, from ``gen``."""
        u = torch.randint(0, self.pool, (n,), generator=gen)
        return (torch.arange(n) // self.rotate) * (self.pool // 2) + u

    def make_batch(self, gen: torch.Generator | int, n: int, pmax: int = 2048,
                   device=DEFAULT_DEVICE, **field_overrides) -> PacketBatch:
        gen = _generator(gen)
        churn_gen = _fold(gen, _CHURN_TAG)
        sizes = self.base.sample_sizes(gen, n)
        pkts = make_udp_batch(gen, n, sizes, pmax=pmax, device="cpu",
                              **field_overrides)
        ip, port = _flow_identity(self.flows(churn_gen, n))
        return pkts.replace(src_ip=ip, src_port=port).to(
            resolve_device(device))


def churn(pool: int = 256, rotate: int = 1024,
          base: str | Workload = "enterprise") -> ChurnWorkload:
    """Sustained flow-churn workload (NAT CLOCK-aging pressure)."""
    base = _named_base(base)
    if pool < 2 or rotate < 1:
        raise ValueError(f"need pool >= 2 and rotate >= 1, got "
                         f"({pool}, {rotate})")
    return ChurnWorkload(
        name=f"churn_{base.name}_p{pool}_r{rotate}", sizes=base.sizes,
        probs=base.probs, base=base, pool=int(pool), rotate=int(rotate))


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
