"""Paged-KV allocator = the PayloadPark lookup table at page granularity
(port of ``repro.serving.pool``).

The paper's metadata-table machinery re-instantiated for LM serving: a
KV-cache *page* is the parked payload; the compact request header (page
ids + generations + position + last token) is what travels between the
router and the model shards.  Mapping:

  paper                         serving pool
  -----                         ------------
  Split stores 160B payload     admit/extend allocates a page
  circular TI + single probe    same (alloc loop, one probe per page)
  EXP expiry decrement          same (abandoned requests' pages reclaimed)
  generation (CLK) check        validate() before every attention gather
  Merge frees the slot          release() on request completion
  Explicit Drop (OP bit)        release() on client cancel — immediate
  premature-eviction counter    same (request must restart)
  ENB=0 fallback                alloc failure -> request queued, not parked

The state is three int32 vectors and the counters, on the device of the
pool; every function returns a new state.  The reference's ``lax.scan``
over requests is a Python loop of tensor operations (no host sync); its
drop-mode writes to row ``num_pages`` are a row mask here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import counters as C
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    num_pages: int
    page_tokens: int = 128
    max_exp: int = 2
    max_clk: int = 1 << 16


@dataclasses.dataclass
class PoolState:
    tbl_idx: torch.Tensor   # () int32
    clk: torch.Tensor       # () int32
    meta_exp: torch.Tensor  # (M,) int32
    meta_clk: torch.Tensor  # (M,) int32 — generation, 0 = free
    counters: torch.Tensor  # (C.NUM,) int32 (the paper's counter set)


def init_pool(cfg: PoolConfig, device=DEFAULT_DEVICE) -> PoolState:
    dev = resolve_device(device)
    m = cfg.num_pages
    return PoolState(
        tbl_idx=torch.zeros((), dtype=torch.int32, device=dev),
        clk=torch.zeros((), dtype=torch.int32, device=dev),
        meta_exp=torch.zeros((m,), dtype=torch.int32, device=dev),
        meta_clk=torch.zeros((m,), dtype=torch.int32, device=dev),
        counters=C.zeros(dev),
    )


def alloc(cfg: PoolConfig, state: PoolState, want: torch.Tensor):
    """Allocate pages for a batch (Split).  ``want``: (B,) bool — which
    requests need a new page this step.  Single-probe circular allocation
    with expiry-decrement eviction, exactly Alg. 1 stages 1-2, one request
    after another.

    Returns (state, page_ids (B,), gens (B,), ok (B,))."""
    m = cfg.num_pages
    ti, clk = state.tbl_idx, state.clk
    exp_tbl, clk_tbl = state.meta_exp.clone(), state.meta_clk.clone()
    outs = []
    for w in want.to(torch.bool):
        ti = torch.where(w, (ti + 1) % m, ti)
        clk = torch.where(w, clk + 1, clk)
        clk = torch.where(clk >= cfg.max_clk, 1, clk)
        row = ti.to(torch.int64)
        exp_pre = exp_tbl[row]
        exp_dec = torch.where(exp_pre >= 1, exp_pre - 1, exp_pre)
        evicted = w & (exp_pre >= 1) & (exp_dec == 0)
        claim = w & (exp_dec == 0)
        exp_tbl[row] = torch.where(
            w, torch.where(claim, cfg.max_exp, exp_dec), exp_pre)
        clk_tbl[row] = torch.where(
            claim, clk, torch.where(evicted, 0, clk_tbl[row]))
        outs.append((torch.where(claim, ti, -1), torch.where(claim, clk, 0),
                     claim, evicted, w & ~claim))
    dev = state.counters.device
    if outs:
        pages, gens, ok, evicted, failed = (torch.stack(x) for x in zip(*outs))
    else:
        pages = gens = torch.zeros((0,), dtype=torch.int32, device=dev)
        ok = evicted = failed = torch.zeros((0,), dtype=torch.bool,
                                            device=dev)
    counters = state.counters
    counters = C.bump(counters, "splits", ok.sum())
    counters = C.bump(counters, "evictions", evicted.sum())
    counters = C.bump(counters, "skip_occupied", failed.sum())
    return (PoolState(ti, clk, exp_tbl, clk_tbl, counters),
            pages.to(torch.int32), gens.to(torch.int32), ok)


def _read(tbl: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """``tbl[pages]`` with the reference's clamped gather."""
    return tbl[pages.to(torch.int64).clamp(0, tbl.shape[0] - 1)]


def validate(state: PoolState, pages, gens):
    """Generation check (Merge stage 2) for every page a request claims to
    own.  pages/gens: (..., P) with -1 padding.  Returns (...,) bool all-ok."""
    live = pages >= 0
    ok = torch.where(live, _read(state.meta_clk, pages) == gens, True)
    return ok.all(dim=-1)


def release(cfg: PoolConfig, state: PoolState, pages, gens, explicit=False):
    """Free pages (Merge / Explicit Drop).  pages/gens: flat (N,) with -1
    padding.  Stale (already-evicted) pages are counted, not freed twice."""
    live = pages >= 0
    match = live & (_read(state.meta_clk, pages) == gens)
    # the reference writes matched rows and drops the others (and rows past
    # the table); here a mask over the table's rows selects the same rows
    rows = torch.arange(cfg.num_pages, device=pages.device)
    hit = ((rows[:, None] == pages.to(torch.int64)[None, :])
           & match[None, :]).any(dim=-1)
    meta_exp = torch.where(hit, 0, state.meta_exp)
    meta_clk = torch.where(hit, 0, state.meta_clk)
    counters = state.counters
    name = "explicit_drops" if explicit else "merges"
    counters = C.bump(counters, name, match.sum())
    counters = C.bump(counters, "premature_evictions", (live & ~match).sum())
    return PoolState(state.tbl_idx, state.clk, meta_exp, meta_clk, counters)


def occupancy(state: PoolState):
    return (state.meta_exp > 0).sum()
