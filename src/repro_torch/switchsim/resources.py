"""Copy of ``repro.switchsim.resources`` (pure Python), over the port's
``ParkConfig``.

Tofino on-chip resource accounting (paper §6.3.2, Table 1).

Models the Match-Action-Unit resources PayloadPark consumes, using public
Tofino-generation constants (the paper omits exact chip details for
confidentiality; §5 footnote):

  * 12 MAU stages per pipe; 80 SRAM blocks of 16 KB per stage (1.28 MB/stage,
    15.36 MB/pipe — consistent with "50-100 MB of stateful SRAM" chip-wide
    for 4 pipes plus packet buffer).
  * register arrays consume whole SRAM blocks; a (M x width) register array
    needs ceil(M * width / 16KB) blocks placed in one stage.
  * PHV capacity 4 kbit; VLIW actions 32 slots/stage.

``utilization`` returns avg/peak per-stage SRAM % plus PHV/VLIW estimates so
the Table 1 benchmark can compare against the paper's reported numbers
(25.94 %/33.75 % for 4 NF servers; 38.23 %/48.75 % for 8).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.park import BLOCK_BYTES, ParkConfig

STAGES_PER_PIPE = 12
SRAM_BLOCKS_PER_STAGE = 80
SRAM_BLOCK_BYTES = 16 * 1024
STAGE_SRAM_BYTES = SRAM_BLOCKS_PER_STAGE * SRAM_BLOCK_BYTES  # 1.28 MB
PIPE_SRAM_BYTES = STAGES_PER_PIPE * STAGE_SRAM_BYTES          # 15.36 MB
PHV_BITS = 4096
VLIW_SLOTS_PER_STAGE = 32


@dataclasses.dataclass(frozen=True)
class Utilization:
    sram_avg_pct: float
    sram_peak_pct: float
    phv_pct: float
    vliw_pct: float
    sram_bytes: int
    stages_used: int

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _blocks(nbytes: int) -> int:
    return math.ceil(nbytes / SRAM_BLOCK_BYTES)


def _placement(capacity: int, banks: int, nf_servers: int) -> list[int]:
    """Per-stage SRAM blocks for one PayloadPark layout.

    Single source of truth shared by the forward model (``utilization``)
    and the Fig. 14 inversion (``capacity_for_memory_fraction``) so the two
    stay mutually consistent — register arrays consume whole 16 KB blocks,
    replicated per server slice (§6.2.3).
    """
    per_stage_blocks = [0] * STAGES_PER_PIPE
    # Stage 1: tagger registers (TI + CLK, 2 x 2B) — negligible, 1 block.
    per_stage_blocks[0] += 1
    # Stage 2: metadata table: EXP(2B) + CLK(2B) + LEN(2B) per slot.
    per_stage_blocks[1] += _blocks(capacity * 6) * nf_servers
    # Stages 3..N: payload banks, BLOCK_BYTES-wide register arrays striped
    # across the remaining stages (Fig. 4).  Two arrays per stage is typical
    # (two MATs can share a stage when resources allow, §4).
    banks_per_stage = 2
    stage = 2
    placed = 0
    while placed < banks:
        k = min(banks_per_stage, banks - placed)
        per_stage_blocks[stage % STAGES_PER_PIPE] += \
            _blocks(capacity * BLOCK_BYTES) * k * nf_servers
        placed += k
        stage += 1
    return per_stage_blocks


def utilization(cfg: ParkConfig, nf_servers: int = 1) -> Utilization:
    """Resource usage for ``nf_servers`` sharing one pipe's MAU (paper §6.2.3
    statically slices the reserved memory among servers on the same pipe)."""
    per_stage_blocks = _placement(cfg.capacity, cfg.banks, nf_servers)
    banks = cfg.banks

    pcts = [100.0 * b / SRAM_BLOCKS_PER_STAGE for b in per_stage_blocks]
    used = [p for p in pcts if p > 0]
    total_bytes = sum(per_stage_blocks) * SRAM_BLOCK_BYTES

    # PHV: parsed Ethernet+IPv4+UDP (~42B) + PP header (7B) + payload blocks
    # carried through the pipeline (park_bytes) + metadata struct (~8B).
    phv_bits = (42 + 7 + cfg.park_bytes + 8) * 8
    phv_pct = 100.0 * phv_bits / PHV_BITS
    # VLIW: ~2 actions for tagger, 4 for metadata, 1 per bank store/fetch.
    vliw = 2 + 4 + banks
    vliw_pct = 100.0 * vliw / (VLIW_SLOTS_PER_STAGE * STAGES_PER_PIPE)

    return Utilization(
        sram_avg_pct=sum(used) / len(used),
        sram_peak_pct=max(pcts),
        phv_pct=phv_pct,
        vliw_pct=vliw_pct,
        sram_bytes=total_bytes,
        stages_used=sum(1 for b in per_stage_blocks if b),
    )


def capacity_for_memory_fraction(frac: float, cfg: ParkConfig,
                                 nf_servers: int = 1) -> int:
    """Invert the model: the largest table capacity whose *placed* SRAM cost
    fits in ``frac`` of one pipe's SRAM (paper Fig. 14 sweeps 'percentage of
    reserved memory').

    Uses the same ``_placement`` as ``utilization`` — whole 16 KB blocks
    per register array, replicated per server slice — so the inversion
    round-trips against the forward model exactly (the seed divided the
    budget by raw per-slot bytes and ignored both effects, overstating the
    affordable capacity).
    """
    budget = frac * PIPE_SRAM_BYTES

    def cost(m: int) -> int:
        return sum(_placement(m, cfg.banks, nf_servers)) * SRAM_BLOCK_BYTES

    if cost(0) > budget:  # fixed tagger overhead alone does not fit
        return 0
    hi = 1
    while cost(hi) <= budget and hi < PIPE_SRAM_BYTES:
        hi *= 2
    lo = hi // 2 if hi > 1 else 0
    # invariant: cost(lo) <= budget < cost(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cost(mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo
