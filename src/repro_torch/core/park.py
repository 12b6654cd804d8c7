"""PayloadPark lookup table: Split / Merge / Evict / Explicit-Drop /
Recirculate (port of ``repro.core.park``, paper Algorithms 1 and 2).

P4 gives atomic, per-packet sequential register semantics (§5).  The
reference reproduces them with a ``lax.scan`` over packets.  The port runs
each control pass as one primitive of the backend registry
(``repro_torch.backend``): ``split_control`` (tagger, metadata probe, tag
CRCs) and ``merge_stage`` (tag check, validation/free pass, gather and
clear of the parked rows) are one CUDA kernel launch each on the card and
plain Python loops over packet positions on the CPU; ``payload_store``
moves Split's rows, and ``merge_payload`` rebuilds Merge's packets (one
launch on the card).  Every tensor may carry leading pipe dimensions, and
all pipes advance together.  Index rules follow the reference: a negative
tag index counts from the end, out-of-range reads clamp and writes drop.

State is consumed: ``split_fn``/``merge_fn``/``recirc_fn`` update the
payload table of the state they are given in place (the port's counterpart
of the reference's donated buffers) and return the new state.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.backend.config import as_config
from repro_torch.backend.ref import MERGE_DECISIONS, MERGE_PAYLOAD_FIELDS
from repro_torch.backend.registry import dispatch
from repro_torch.core import counters as C
from repro_torch.core.packet import FIELDS, PacketBatch
from repro_torch.device import DEFAULT_DEVICE, resolve_device

BLOCK_BYTES = 16  # single MAT-cell width (paper Fig. 4)
PARK_BYTES_BASE = 160  # paper §1
PARK_BYTES_RECIRC = 352  # paper §6.2.5


@dataclasses.dataclass(frozen=True)
class ParkConfig:
    capacity: int = 4096          # M, lookup table entries
    max_exp: int = 1              # Expiry threshold (paper EXP)
    max_clk: int = 1 << 16        # clock rollover (2-byte register, §5)
    min_park_len: int = PARK_BYTES_BASE  # eligibility threshold (§5)
    recirculation: bool = False   # §6.2.5: second pass through the pipeline
    pmax: int = 2048              # payload buffer capacity of PacketBatch
    recirc_frac: float = 0.25     # recirculation-port share of pipe capacity

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.pmax < 1:
            raise ValueError(f"pmax must be >= 1, got {self.pmax}")
        if self.max_exp < 1:
            raise ValueError(f"max_exp must be >= 1, got {self.max_exp}")
        if self.max_clk < 2:
            raise ValueError(f"max_clk must be >= 2, got {self.max_clk}")
        if self.min_park_len < 1:
            raise ValueError(
                f"min_park_len must be >= 1, got {self.min_park_len}")
        if not 0.0 <= self.recirc_frac <= 1.0:
            raise ValueError(
                f"recirc_frac must be in [0, 1], got {self.recirc_frac}")

    @property
    def park_bytes(self) -> int:
        """Full lookup-table row width (accumulated across passes)."""
        return PARK_BYTES_RECIRC if self.recirculation else PARK_BYTES_BASE

    @property
    def pass_bytes(self) -> int:
        """Bytes one pipeline traversal can park."""
        return min(PARK_BYTES_BASE, self.park_bytes)

    @property
    def banks(self) -> int:
        return self.park_bytes // BLOCK_BYTES


@dataclasses.dataclass
class ParkState:
    """Registers + tables of one PayloadPark pipe (or of P pipes, with a
    leading pipe axis on every field)."""

    tbl_idx: torch.Tensor   # (...,) int32 — TI register
    clk: torch.Tensor       # (...,) int32 — CLK register
    meta_exp: torch.Tensor  # (..., M) int32 — Expiry threshold per slot
    meta_clk: torch.Tensor  # (..., M) int32 — generation per slot (0 = free)
    meta_len: torch.Tensor  # (..., M) int32 — parked byte count per slot
    ptable: torch.Tensor    # (..., M, park_bytes) uint8 — payload banks
    counters: torch.Tensor  # (..., C.NUM) int32


def init_state(cfg: ParkConfig, device=DEFAULT_DEVICE,
               pipes: int | None = None) -> ParkState:
    """Fresh state; ``pipes`` adds a leading pipe axis."""
    dev = resolve_device(device)
    lead = () if pipes is None else (pipes,)
    m = cfg.capacity

    def z(*shape, dtype=torch.int32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    return ParkState(
        tbl_idx=z(), clk=z(), meta_exp=z(m), meta_clk=z(m), meta_len=z(m),
        ptable=z(m, cfg.park_bytes, dtype=torch.uint8),
        counters=C.zeros(dev, lead))


def occupancy(state: ParkState) -> torch.Tensor:
    """Number of live (parked) slots, (...,) int32."""
    return (state.meta_exp > 0).sum(dim=-1).to(torch.int32)


def _gather_last(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (..., M) at idx (..., K) -> (..., K)."""
    return torch.gather(a, -1, idx.to(torch.int64))


def _payload_shift(payload, payload_len, shift, pmax):
    """Drop the first ``shift`` bytes of each payload; zero past the new
    length.  Returns (remainder, new_len)."""
    col = torch.arange(pmax, device=payload.device)
    idx = torch.clamp(col + shift[..., None], 0, pmax - 1)
    remainder = torch.gather(payload, -1, idx.to(torch.int64))
    new_len = payload_len - shift
    remainder = torch.where(col < new_len[..., None], remainder, 0)
    return remainder.to(torch.uint8), new_len.to(torch.int32)


# --------------------------------------------------------------------------
# Split (paper Algorithm 1)
# --------------------------------------------------------------------------

def split_fn(cfg: ParkConfig, state: ParkState, pkts: PacketBatch,
             backend=None) -> tuple[ParkState, PacketBatch]:
    """Split: park payload prefixes, emit header-only packets.

    Returns (new_state, packets as sent to the NF server).  Every alive
    packet leaves with a PayloadPark header (ENB=1 if parked, else 0).
    ``backend`` selects the split_control / payload_store
    implementations.
    """
    backend = as_config(backend)
    # the tagger, the metadata probe (Alg. 1 lines 4-25) and the tag CRCs:
    # one call
    (ti, clk, meta_exp, meta_clk, meta_len), d = dispatch(
        "split_control", backend)(
        cfg.capacity, cfg.max_exp, cfg.max_clk, cfg.min_park_len,
        cfg.pass_bytes, state.tbl_idx, state.clk, state.meta_exp,
        state.meta_clk, state.meta_len, pkts.alive, pkts.payload_len)

    # -- stage 3..N: stripe payload blocks into the payload table.  The
    # full row is written (zeros above park_len), so a recirculation pass
    # appends into zeros.
    park = pkts.payload[..., : cfg.park_bytes]
    if park.shape[-1] < cfg.park_bytes:
        park = torch.nn.functional.pad(
            park, (0, cfg.park_bytes - park.shape[-1]))
    lane = torch.arange(cfg.park_bytes, device=park.device)
    park = torch.where(lane < d["park_len"][..., None], park, 0)
    ptable = dispatch("payload_store", backend)(
        state.ptable, park.to(torch.uint8), d["ti"], d["enb"])

    counters = state.counters
    counters = C.bump(counters, "splits", d["enb"].sum(-1))
    counters = C.bump(counters, "evictions", d["evicted"].sum(-1))
    counters = C.bump(counters, "skip_occupied", d["skip_occupied"].sum(-1))
    counters = C.bump(counters, "skip_small_payload", d["skip_small"].sum(-1))

    new_state = ParkState(ti, clk, meta_exp, meta_clk, meta_len, ptable,
                          counters)

    # -- packet transformation: drop the parked prefix, add the PP header --
    remainder, new_len = _payload_shift(pkts.payload, pkts.payload_len,
                                        d["park_len"], cfg.pmax)
    alive = pkts.alive
    enb = d["enb"]
    zero = torch.zeros_like(pkts.pp_op)
    out = pkts.replace(
        payload=torch.where(alive[..., None], remainder, pkts.payload),
        payload_len=torch.where(alive, new_len, pkts.payload_len),
        pp_valid=alive.clone(),
        pp_enb=torch.where(alive, enb.to(torch.int32), zero),
        pp_op=zero,
        pp_ti=torch.where(enb, d["ti"], zero),
        pp_clk=torch.where(enb, d["clk"], zero),
        pp_crc=torch.where(enb, d["crc"], zero),
    )
    return new_state, out


# --------------------------------------------------------------------------
# Recirculation pass (paper §6.2.5)
# --------------------------------------------------------------------------

def _select_rows(mask: torch.Tensor, a: PacketBatch,
                 b: PacketBatch) -> PacketBatch:
    """Per-packet select between two identically shaped PacketBatches."""

    def sel(name):
        x, y = getattr(a, name), getattr(b, name)
        return torch.where(
            mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y)

    return PacketBatch(**{n: sel(n) for n in FIELDS})


def _set_last(a: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              ok: torch.Tensor) -> torch.Tensor:
    """``a[idx[k]] = vals[k]`` where ``ok[k]`` (idx in range), the last
    writer winning on duplicates: (..., M) -> new (..., M)."""
    order = torch.arange(idx.shape[-1], device=idx.device).expand(idx.shape)
    winner = torch.full(a.shape, -1, dtype=torch.int64, device=a.device)
    winner.scatter_reduce_(-1, idx.to(torch.int64),
                           torch.where(ok, order, -1), reduce="amax")
    new = torch.gather(vals, -1, winner.clamp(min=0))
    return torch.where(winner >= 0, new, a).to(a.dtype)


def recirc_fn(cfg: ParkConfig, state: ParkState, pkts: PacketBatch,
              backend=None) -> tuple[ParkState, PacketBatch]:
    """One recirculation pass for packets re-injected through the
    recirculation port (paper §6.2.5):

      * **continuation** (ENB=1 with payload remaining): append up to
        ``park_bytes - meta_len[TI]`` more bytes into the packet's row,
        unless the slot was evicted in between;
      * **retry** (ENB=0 after an occupied-slot skip): a fresh Split.

    The appended row is written whole through ``payload_store``.
    """
    backend = as_config(backend)
    counters = C.bump(state.counters, "recirculations",
                      (pkts.alive & pkts.pp_valid).sum(-1))

    # -- continuation: append into the owned row ---------------------------
    ext = pkts.alive & pkts.pp_valid & (pkts.pp_enb == 1)
    ti = torch.clamp(pkts.pp_ti, 0, cfg.capacity - 1).to(torch.int64)
    own = ext & (_gather_last(state.meta_clk, ti) == pkts.pp_clk)
    cur = torch.where(own, _gather_last(state.meta_len, ti), 0)
    extra = torch.where(
        own, torch.minimum(pkts.payload_len,
                           torch.clamp(cfg.park_bytes - cur, min=0)), 0)
    do_ext = own & (extra > 0)

    col = torch.arange(cfg.park_bytes, device=ti.device)
    src = col - cur[..., None]
    ins = torch.gather(pkts.payload, -1,
                       torch.clamp(src, 0, cfg.pmax - 1).to(torch.int64))
    region = (src >= 0) & (src < extra[..., None])
    old_rows = torch.gather(
        state.ptable, -2,
        ti[..., None].expand(ti.shape + (cfg.park_bytes,)))
    new_row = torch.where(region, ins, old_rows).to(torch.uint8)
    meta_len = _set_last(state.meta_len, ti, cur + extra, do_ext)
    ptable = dispatch("payload_store", backend)(state.ptable, new_row, ti,
                                                do_ext)

    remainder, new_len = _payload_shift(pkts.payload, pkts.payload_len,
                                        extra, cfg.pmax)
    ext_out = pkts.replace(
        payload=torch.where(do_ext[..., None], remainder, pkts.payload),
        payload_len=torch.where(do_ext, new_len, pkts.payload_len),
    )
    mid = ParkState(state.tbl_idx, state.clk, state.meta_exp, state.meta_clk,
                    meta_len, ptable, counters)

    # -- retry: a second Split attempt for ENB=0 packets -------------------
    retry = pkts.alive & pkts.pp_valid & (pkts.pp_enb == 0)
    new_state, retry_out = split_fn(cfg, mid, ext_out.replace(alive=retry),
                                    backend=backend)
    return new_state, _select_rows(retry, retry_out, ext_out)


# --------------------------------------------------------------------------
# Merge + Explicit Drop (paper Algorithm 2, §6.2.4)
# --------------------------------------------------------------------------

def merge_fn(cfg: ParkConfig, state: ParkState, pkts: PacketBatch,
             backend=None) -> tuple[ParkState, PacketBatch]:
    """Merge (and Explicit Drop) for packets returning from the NF server.

      * ENB=0: PayloadPark header removed, packet forwarded.
      * ENB=1, OP=merge, tag valid: payload re-attached, slot freed.
      * ENB=1, OP=drop, tag valid: slot freed, packet consumed (§6.2.4).
      * CRC or generation mismatch: packet dropped, counted.
    """
    backend = as_config(backend)
    # the tag check, the validation/free pass (Alg. 2 stages 1-2) and the
    # gather-and-clear of the matched rows (stages 3..N): one call
    (meta_exp, meta_clk, meta_len), d, parked, ptable = dispatch(
        "merge_stage", backend)(
        state.ptable, state.meta_exp, state.meta_clk, state.meta_len,
        pkts.alive, pkts.pp_valid, pkts.pp_enb, pkts.pp_op, pkts.pp_ti,
        pkts.pp_clk, pkts.pp_crc)
    fetch = d["matched"] & ~d["is_drop_op"]

    counters = state.counters
    counters = C.bump(counters, "merges", fetch.sum(-1))
    counters = C.bump(counters, "explicit_drops", d["is_drop_op"].sum(-1))
    counters = C.bump(counters, "disabled_returns", d["disabled"].sum(-1))
    counters = C.bump(counters, "premature_evictions", d["premature"].sum(-1))
    counters = C.bump(counters, "crc_failures", d["crc_fail"].sum(-1))

    new_state = ParkState(state.tbl_idx, state.clk, meta_exp, meta_clk,
                          meta_len, ptable, counters)

    # -- packet transformation: payload := parked ++ carried remainder, and
    # the header fields after the decisions: one call, to new tensors ------
    out = dispatch("merge_payload", backend)(
        *(getattr(pkts, n) for n in MERGE_PAYLOAD_FIELDS), parked,
        *(d[k] for k in MERGE_DECISIONS))
    out = pkts.replace(**dict(zip(MERGE_PAYLOAD_FIELDS, out)))
    return new_state, out


def stats(state: ParkState) -> dict[str, Any]:
    d = C.as_dict(state.counters)
    d["occupancy"] = int(occupancy(state))
    return d
