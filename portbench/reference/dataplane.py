"""Plain reference of P independent PayloadPark pipes (Goswami et al., SOSR
2020, arXiv:2006.05182): Split (Algorithm 1), the NF chain (firewall,
MazuNAT-style NAT, Maglev LB; §6.1, §7), Merge and Explicit Drop
(Algorithm 2, §6.2.4) and the recirculation lane (§6.2.5), stepped chunk by
chunk with ``window`` chunks in flight between Split and Merge (§4).

P4 gives each packet atomic, sequential access to the switch's registers,
so Split's metadata probe, Merge's validation pass and NAT's insert walk run
here as loops over packet positions, each position one gather and one
scatter for every pipe at once.  Everything is integer arithmetic, so a
correct program matches it bit for bit on any device.

A packet batch is a dict of tensors named as ``FIELDS``: header fields
(P, B) int32 (``alive`` and ``pp_valid`` bool), ``payload`` (P, B, pmax)
uint8.  ``run`` returns the merged packets of every step, the final switch
tables and registers, the counters, the per-pipe link telemetry, the
occupancy series and NAT's stale-hit count.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FIELDS = ("dst_mac", "src_mac", "src_ip", "dst_ip", "proto", "src_port",
          "dst_port", "payload_len", "payload", "alive", "pp_valid",
          "pp_enb", "pp_op", "pp_ti", "pp_clk", "pp_crc")
HDR_BYTES = 42          # Ethernet + IPv4 + UDP (paper footnote 1)
PP_HDR_BYTES = 7        # PayloadPark header (paper Fig. 2)
OP_DROP = 1
PARK_BYTES_BASE = 160   # bytes one pass parks (paper §1)
PARK_BYTES_RECIRC = 352  # row width with recirculation (paper §6.2.5)
CRC_POLY, CRC_INIT = 0x1021, 0xFFFF  # CRC-16/CCITT-FALSE over the tag
NAT_PROBE_DEPTH = 8
COUNTERS = ("splits", "merges", "explicit_drops", "disabled_returns",
            "evictions", "premature_evictions", "skip_small_payload",
            "skip_occupied", "crc_failures", "recirculations",
            "recirc_budget_drops", "fault_drops")
TELEMETRY = ("wire_pkts", "wire_bytes", "to_server_pkts", "to_server_bytes",
             "from_server_pkts", "from_server_bytes", "recirc_pkts",
             "recirc_bytes", "merged_pkts", "merged_bytes")


@dataclasses.dataclass(frozen=True)
class Switch:
    """One pipe's PayloadPark configuration (every pipe has the same)."""

    capacity: int            # lookup-table rows, M
    max_exp: int             # expiry threshold EXP
    recirculation: bool
    recirc_frac: float       # recirculation port's share of a step
    pmax: int                # payload buffer of a packet
    window: int              # chunks in flight between Split and Merge
    max_clk: int = 1 << 16   # generation clock rollover (2-byte register)
    min_park_len: int = PARK_BYTES_BASE

    @property
    def park_bytes(self) -> int:
        return PARK_BYTES_RECIRC if self.recirculation else PARK_BYTES_BASE

    @property
    def pass_bytes(self) -> int:
        return PARK_BYTES_BASE

    def lane(self, chunk: int) -> int:
        """Recirculation lane rows a step (0 with the lane off)."""
        if not self.recirculation:
            return 0
        return math.floor(self.recirc_frac * chunk + 1e-9)


@dataclasses.dataclass(frozen=True)
class Firewall:
    rules: tuple             # blocked source addresses (int32 values)


@dataclasses.dataclass(frozen=True)
class Nat:
    capacity: int
    base_port: int
    max_exp: int
    nat_ip: int


@dataclasses.dataclass(frozen=True)
class Maglev:
    backends: tuple          # backend addresses (int32 values)
    table_size: int


# --------------------------------------------------------------------------
# packets
# --------------------------------------------------------------------------

def dead(pipes: int, rows: int, pmax: int, device) -> dict:
    """All-dead rows: every field zero, ``alive`` False."""
    out = {}
    for n in FIELDS:
        if n == "payload":
            out[n] = torch.zeros(pipes, rows, pmax, dtype=torch.uint8,
                                 device=device)
        elif n in ("alive", "pp_valid"):
            out[n] = torch.zeros(pipes, rows, dtype=torch.bool, device=device)
        else:
            out[n] = torch.zeros(pipes, rows, dtype=torch.int32,
                                 device=device)
    return out


def pkt_len(p: dict) -> torch.Tensor:
    return HDR_BYTES + torch.where(p["pp_valid"], PP_HDR_BYTES, 0) \
        + p["payload_len"]


def alive_pkts(p: dict) -> torch.Tensor:
    return p["alive"].sum(-1)


def alive_bytes(p: dict) -> torch.Tensor:
    return torch.where(p["alive"], pkt_len(p), 0).sum(-1)


def select_rows(mask: torch.Tensor, a: dict, b: dict) -> dict:
    """Row by row: ``a`` where ``mask``, else ``b``."""
    return {n: torch.where(mask[..., None] if n == "payload" else mask,
                           a[n], b[n]) for n in FIELDS}


def shift_payload(payload, length, shift, pmax):
    """Drop the first ``shift`` bytes; zero past the new length."""
    col = torch.arange(pmax, device=payload.device)
    idx = torch.clamp(col + shift[..., None], 0, pmax - 1)
    rest = torch.gather(payload, -1, idx.to(torch.int64))
    new_len = length - shift
    rest = torch.where(col < new_len[..., None], rest, 0)
    return rest.to(torch.uint8), new_len.to(torch.int32)


# --------------------------------------------------------------------------
# the tag CRC and the payload table
# --------------------------------------------------------------------------

def crc16_tag(ti: torch.Tensor, clk: torch.Tensor) -> torch.Tensor:
    """CRC-16/CCITT-FALSE over the tag's 4 little-endian bytes, bit by
    bit."""
    ti, clk = ti.to(torch.int32), clk.to(torch.int32)
    crc = torch.full(ti.shape, CRC_INIT, dtype=torch.int32, device=ti.device)
    for byte in (ti & 0xFF, (ti >> 8) & 0xFF, clk & 0xFF, (clk >> 8) & 0xFF):
        crc = crc ^ (byte << 8)
        for _ in range(8):
            hi = (crc >> 15) & 1
            crc = (crc << 1) & 0xFFFF
            crc = torch.where(hi == 1, crc ^ CRC_POLY, crc)
    return crc


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (P, M, W) at idx (P, K) -> (P, K, W)."""
    i = idx.to(torch.int64)[..., None].expand(idx.shape + table.shape[-1:])
    return torch.gather(table, -2, i)


def store_rows(table, rows, idx, enb):
    """``table[idx[b]] = rows[b]`` where ``enb[b]``, in place; the last
    writer of a row wins."""
    m, b = table.shape[-2], idx.shape[-1]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + m, idx)
    ok = enb & (idx >= 0) & (idx < m)
    order = torch.arange(b, device=idx.device).expand(idx.shape)
    winner = torch.full(table.shape[:-1], -1, dtype=torch.int64,
                        device=table.device)
    winner.scatter_reduce_(-1, idx.clamp(0, m - 1),
                           torch.where(ok, order, -1), reduce="amax")
    new = _rows(rows, winner.clamp(min=0))
    table.copy_(torch.where((winner >= 0)[..., None], new, table))


def set_last(a, idx, vals, ok):
    """``a[idx[k]] = vals[k]`` where ``ok[k]``, the last writer winning."""
    order = torch.arange(idx.shape[-1], device=idx.device).expand(idx.shape)
    winner = torch.full(a.shape, -1, dtype=torch.int64, device=a.device)
    winner.scatter_reduce_(-1, idx.to(torch.int64),
                           torch.where(ok, order, -1), reduce="amax")
    new = torch.gather(vals, -1, winner.clamp(min=0))
    return torch.where(winner >= 0, new, a).to(a.dtype)


# --------------------------------------------------------------------------
# Split (Algorithm 1)
# --------------------------------------------------------------------------

def init_switch(sw: Switch, pipes: int, device) -> dict:
    def z(*shape, dtype=torch.int32):
        return torch.zeros((pipes,) + shape, dtype=dtype, device=device)

    m = sw.capacity
    st = dict(tbl_idx=z(), clk=z(), meta_exp=z(m), meta_clk=z(m),
              meta_len=z(m), ptable=z(m, sw.park_bytes, dtype=torch.uint8))
    st["counters"] = {n: z(dtype=torch.int64) for n in COUNTERS}
    return st


def split(sw: Switch, st: dict, p: dict) -> dict:
    """Park payload prefixes and tag the packets; updates ``st`` and
    returns the packets as sent to the NF server."""
    m, alive, plen = sw.capacity, p["alive"], p["payload_len"]
    eligible = alive & (plen >= sw.min_park_len)
    k = torch.cumsum(eligible.to(torch.int64), dim=-1)
    ti0 = st["tbl_idx"].to(torch.int64)[..., None]
    clk0 = st["clk"].to(torch.int64)[..., None]
    ti = torch.remainder(ti0 + k, m)
    clk = torch.where(k > 0, torch.remainder(clk0 - 1 + k, sw.max_clk - 1)
                      + 1, clk0)
    park_len = torch.clamp(plen, max=sw.pass_bytes)

    meta_exp, meta_clk = st["meta_exp"].clone(), st["meta_clk"].clone()
    meta_len = st["meta_len"].clone()
    enb, evicted, avail = (torch.zeros_like(alive) for _ in range(3))
    for i in range(alive.shape[-1]):
        slot, e = ti[:, i:i + 1], eligible[:, i]
        exp_pre = torch.gather(meta_exp, -1, slot)[:, 0]
        clk_cur = torch.gather(meta_clk, -1, slot)[:, 0]
        len_cur = torch.gather(meta_len, -1, slot)[:, 0]
        available = exp_pre <= 1
        ev = e & (exp_pre == 1)
        claim = e & available
        new_exp = torch.where(e, torch.where(available, sw.max_exp,
                                             exp_pre - 1), exp_pre)
        new_clk = torch.where(claim, clk[:, i],
                              torch.where(ev, 0, clk_cur))
        new_len = torch.where(claim, park_len[:, i], len_cur)
        meta_exp.scatter_(-1, slot, new_exp[:, None].to(torch.int32))
        meta_clk.scatter_(-1, slot, new_clk[:, None].to(torch.int32))
        meta_len.scatter_(-1, slot, new_len[:, None].to(torch.int32))
        enb[:, i], evicted[:, i], avail[:, i] = claim, ev, available

    ti32, clk32 = ti.to(torch.int32), clk.to(torch.int32)
    crc = crc16_tag(ti32, clk32)
    parked = torch.where(enb, park_len, 0).to(torch.int32)

    w = sw.park_bytes
    row = p["payload"][..., :w]
    if row.shape[-1] < w:
        row = torch.nn.functional.pad(row, (0, w - row.shape[-1]))
    col = torch.arange(w, device=row.device)
    row = torch.where(col < parked[..., None], row, 0).to(torch.uint8)
    store_rows(st["ptable"], row, ti32, enb)

    c = st["counters"]
    c["splits"] = c["splits"] + enb.sum(-1)
    c["evictions"] = c["evictions"] + evicted.sum(-1)
    c["skip_occupied"] = c["skip_occupied"] + (eligible & ~avail).sum(-1)
    c["skip_small_payload"] = c["skip_small_payload"] + \
        (alive & (plen < sw.min_park_len)).sum(-1)
    st.update(tbl_idx=ti32[:, -1] if alive.shape[-1] else st["tbl_idx"],
              clk=clk32[:, -1] if alive.shape[-1] else st["clk"],
              meta_exp=meta_exp, meta_clk=meta_clk, meta_len=meta_len)

    rest, new_len = shift_payload(p["payload"], plen, parked, sw.pmax)
    zero = torch.zeros_like(p["pp_op"])
    out = dict(p)
    out.update(
        payload=torch.where(alive[..., None], rest, p["payload"]),
        payload_len=torch.where(alive, new_len, plen),
        pp_valid=alive.clone(),
        pp_enb=torch.where(alive, enb.to(torch.int32), zero),
        pp_op=zero,
        pp_ti=torch.where(enb, ti32, zero),
        pp_clk=torch.where(enb, clk32, zero),
        pp_crc=torch.where(enb, crc, zero))
    return out


# --------------------------------------------------------------------------
# the recirculation pass (§6.2.5)
# --------------------------------------------------------------------------

def recirc_select(sw: Switch, out: dict, budget: int):
    """Admit up to ``budget`` recirculation candidates in arrival order:
    parked packets with payload left, and eligible packets that found their
    slot occupied.  Returns (forwarded, lane, denied per pipe)."""
    cont = out["alive"] & out["pp_valid"] & (out["pp_enb"] == 1) & \
        (out["payload_len"] > 0)
    retry = out["alive"] & out["pp_valid"] & (out["pp_enb"] == 0) & \
        (out["payload_len"] >= sw.min_park_len)
    cand = cont | retry
    pos = torch.cumsum(cand.to(torch.int64), dim=-1) - 1
    admit = cand & (pos < budget)
    pipes, b = cand.shape
    # src[pos] = row of the pos-th admitted packet; column ``budget`` takes
    # the rows not admitted, and an empty lane row reads the dead row ``b``
    src = torch.full((pipes, budget + 1), b, dtype=torch.int64,
                     device=cand.device)
    src.scatter_(1, torch.where(admit, pos, budget),
                 torch.arange(b, device=cand.device).expand(pipes, b))
    src = src[:, :budget]
    lane = {}
    for n in FIELDS:
        a = torch.cat([out[n], torch.zeros_like(out[n][:, :1])], 1)
        idx = src[..., None].expand(-1, -1, a.shape[-1]) \
            if n == "payload" else src
        lane[n] = torch.gather(a, 1, idx)
    fwd = dict(out)
    fwd["alive"] = out["alive"] & ~admit
    return fwd, lane, (cand & ~admit).sum(-1)


def recirculate(sw: Switch, st: dict, p: dict) -> dict:
    """A second pass for lane packets: a continuation appends more payload
    to the row it owns (unless the row was evicted meanwhile); a retry is a
    fresh Split."""
    c = st["counters"]
    c["recirculations"] = c["recirculations"] + \
        (p["alive"] & p["pp_valid"]).sum(-1)
    ext = p["alive"] & p["pp_valid"] & (p["pp_enb"] == 1)
    ti = torch.clamp(p["pp_ti"], 0, sw.capacity - 1).to(torch.int64)
    own = ext & (torch.gather(st["meta_clk"], -1, ti) == p["pp_clk"])
    cur = torch.where(own, torch.gather(st["meta_len"], -1, ti), 0)
    extra = torch.where(own, torch.minimum(
        p["payload_len"], torch.clamp(sw.park_bytes - cur, min=0)), 0)
    do_ext = own & (extra > 0)

    col = torch.arange(sw.park_bytes, device=ti.device)
    src = col - cur[..., None]
    ins = torch.gather(p["payload"], -1,
                       torch.clamp(src, 0, sw.pmax - 1).to(torch.int64))
    region = (src >= 0) & (src < extra[..., None])
    new_row = torch.where(region, ins, _rows(st["ptable"], ti))
    st["meta_len"] = set_last(st["meta_len"], ti, cur + extra, do_ext)
    store_rows(st["ptable"], new_row.to(torch.uint8), ti, do_ext)

    rest, new_len = shift_payload(p["payload"], p["payload_len"], extra,
                                  sw.pmax)
    ext_out = dict(p)
    ext_out.update(
        payload=torch.where(do_ext[..., None], rest, p["payload"]),
        payload_len=torch.where(do_ext, new_len, p["payload_len"]))
    retry = p["alive"] & p["pp_valid"] & (p["pp_enb"] == 0)
    retry_in = dict(ext_out)
    retry_in["alive"] = retry
    retry_out = split(sw, st, retry_in)
    return select_rows(retry, retry_out, ext_out)


# --------------------------------------------------------------------------
# Merge and Explicit Drop (Algorithm 2, §6.2.4)
# --------------------------------------------------------------------------

def merge(sw: Switch, st: dict, p: dict) -> dict:
    """Re-attach parked payloads (OP=merge), free the rows of OP=drop
    notices, drop packets whose tag fails its CRC or generation check, and
    strip the PayloadPark header; updates ``st``."""
    m = sw.capacity
    alive, ti = p["alive"], p["pp_ti"]
    crc_ok = crc16_tag(ti, p["pp_clk"]) == p["pp_crc"]
    is_pp = alive & p["pp_valid"] & (p["pp_enb"] == 1)
    checked = is_pp & crc_ok
    slot = ti.to(torch.int64)
    slot = torch.where(slot < 0, slot + m, slot)
    in_range = (slot >= 0) & (slot < m)
    slot = torch.clamp(slot, 0, m - 1)

    meta_exp, meta_clk = st["meta_exp"].clone(), st["meta_clk"].clone()
    meta_len = st["meta_len"].clone()
    matched, gen_ok = torch.zeros_like(alive), torch.zeros_like(alive)
    park_len = torch.zeros_like(ti)
    for i in range(alive.shape[-1]):
        s = slot[:, i:i + 1]
        e0 = torch.gather(meta_exp, -1, s)[:, 0]
        c0 = torch.gather(meta_clk, -1, s)[:, 0]
        l0 = torch.gather(meta_len, -1, s)[:, 0]
        g = c0 == p["pp_clk"][:, i]
        hit = checked[:, i] & g
        free = (hit & in_range[:, i])[:, None]
        meta_exp.scatter_(-1, s, torch.where(free, 0, e0[:, None]))
        meta_clk.scatter_(-1, s, torch.where(free, 0, c0[:, None]))
        meta_len.scatter_(-1, s, torch.where(free, 0, l0[:, None]))
        matched[:, i], gen_ok[:, i] = hit, g
        park_len[:, i] = torch.where(hit, l0, 0)

    premature = checked & ~gen_ok
    crc_fail = is_pp & ~crc_ok
    disabled = alive & p["pp_valid"] & (p["pp_enb"] == 0)
    is_drop = matched & (p["pp_op"] == OP_DROP)

    # gather the matched rows, then clear them
    table = st["ptable"]
    rows = _rows(table, slot)
    rows = torch.where(matched[..., None], rows, 0).to(torch.uint8)
    clear = torch.zeros(table.shape[:-1], dtype=torch.int32,
                        device=table.device)
    clear.scatter_reduce_(-1, slot, (matched & in_range).to(torch.int32),
                          reduce="amax")
    table.masked_fill_(clear.bool()[..., None], 0)

    fetch = matched & ~is_drop
    c = st["counters"]
    c["merges"] = c["merges"] + fetch.sum(-1)
    c["explicit_drops"] = c["explicit_drops"] + is_drop.sum(-1)
    c["disabled_returns"] = c["disabled_returns"] + disabled.sum(-1)
    c["premature_evictions"] = c["premature_evictions"] + premature.sum(-1)
    c["crc_failures"] = c["crc_failures"] + crc_fail.sum(-1)
    st.update(meta_exp=meta_exp, meta_clk=meta_clk, meta_len=meta_len)

    shift = torch.where(fetch, park_len, 0)
    col = torch.arange(sw.pmax, device=shift.device)
    carried = torch.gather(p["payload"], -1, torch.clamp(
        col - shift[..., None], 0, sw.pmax - 1).to(torch.int64))
    if sw.pmax >= sw.park_bytes:
        full = torch.nn.functional.pad(rows, (0, sw.pmax - sw.park_bytes))
    else:
        full = rows[..., :sw.pmax]
    new_payload = torch.where(col < shift[..., None], full, carried)
    new_len = p["payload_len"] + shift
    new_payload = torch.where(col < new_len[..., None], new_payload, 0)

    fwd = disabled | fetch
    dropped = premature | crc_fail | is_drop
    gone = fwd | dropped
    zero = torch.zeros_like(p["pp_op"])
    out = dict(p)
    out.update(
        payload=torch.where(fwd[..., None], new_payload,
                            p["payload"]).to(torch.uint8),
        payload_len=torch.where(fwd, new_len,
                                p["payload_len"]).to(torch.int32),
        alive=alive & ~dropped,
        pp_valid=p["pp_valid"] & ~gone,
        pp_enb=torch.where(gone, zero, p["pp_enb"]),
        pp_op=torch.where(gone, zero, p["pp_op"]),
        pp_ti=torch.where(gone, zero, p["pp_ti"]),
        pp_clk=torch.where(gone, zero, p["pp_clk"]),
        pp_crc=torch.where(gone, zero, p["pp_crc"]))
    return out


# --------------------------------------------------------------------------
# the NF chain (§6.1, §7)
# --------------------------------------------------------------------------

NAT_HASH = (-1640531527, -2048144789, -1028477379)  # 0x9E3779B9, ...


def nat_hash(ip, port, capacity):
    """int32 avalanche mix of the flow key (multiplies wrap)."""
    seed, mul1, mul2 = NAT_HASH
    h = ip.to(torch.int32) ^ seed
    h = (h * mul1) ^ port.to(torch.int32)
    h = h ^ (h >> 13)
    h = h * mul2
    return torch.remainder(h & 0x7FFFFFFF, capacity)


def init_nat(nat: Nat, pipes: int, device) -> torch.Tensor:
    """The flow table as (P, C, 3) rows of (key ip, key port, expiry)."""
    t = torch.zeros(pipes, nat.capacity, 3, dtype=torch.int32, device=device)
    t[..., :2] = -1
    return t


def nat_walk(nat: Nat, table, src_ip, src_port, alive, sequential=True):
    """NAT's insert walk in arrival order: each packet finds its flow's
    mapping in its probe window, or claims the first free slot, or (when
    the window is full) ages every slot of it.  A flow whose mapping aged
    out while it still sends is a stale hit: dropped, binding torn down.

    ``sequential=False`` is the control: every packet of the call reads the
    table as it was when the call began, so two packets of one new flow in
    one batch no longer share a mapping.  Returns (mapped port or -1, stale
    hit) and updates ``table`` in place."""
    cap, depth = nat.capacity, NAT_PROBE_DEPTH
    ar = torch.arange(depth, device=src_ip.device)
    probe = torch.remainder(nat_hash(src_ip, src_port, cap)[..., None] + ar,
                            cap).to(torch.int64)
    start = table.clone()
    mapped = torch.full_like(src_port, -1)
    stale = torch.zeros_like(alive)

    def first(cond):
        return torch.where(cond, ar, depth).amin(dim=-1)

    for i in range(src_ip.shape[-1]):
        pidx = probe[:, i, :]
        gi = pidx[..., None].expand(pidx.shape + (3,))
        kip, kport, ex = torch.gather(table if sequential else start, -2,
                                      gi).unbind(-1)
        ip, port = src_ip[:, i, None], src_port[:, i, None]
        live_pkt = alive[:, i]
        live = ex > 0
        match = (kip == ip) & (kport == port)
        p_slot, p_stale, p_free = (first(live & match), first(~live & match),
                                   first(~live))
        found = p_slot < depth
        hit = live_pkt & found
        stale_hit = live_pkt & ~found & (p_stale < depth)
        insert = live_pkt & ~found & ~stale_hit & (p_free < depth)
        full = live_pkt & ~found & (p_free >= depth)
        p_w = torch.where(hit, p_slot, torch.where(stale_hit, p_stale,
                                                    p_free))
        at = (ar == p_w[:, None]) & (hit | stale_hit | insert)[:, None]
        ci, sh = insert[:, None], stale_hit[:, None]
        new_ip = torch.where(at, torch.where(ci, ip, torch.where(sh, -1, kip)),
                             kip)
        new_port = torch.where(at, torch.where(
            ci, port, torch.where(sh, -1, kport)), kport)
        new_ex = torch.where(at & ~sh, nat.max_exp, ex)
        new_ex = torch.where(full[:, None], torch.clamp(ex - 1, min=0),
                             new_ex)
        table.scatter_(-2, gi, torch.stack([new_ip, new_port, new_ex],
                                           dim=-1).to(torch.int32))
        slot = torch.gather(pidx, -1, p_w.clamp(max=depth - 1)[:, None])[:, 0]
        mapped[:, i] = torch.where(hit | insert, nat.base_port + slot, -1)
        stale[:, i] = stale_hit
    return mapped, stale


def _mix64(salt: int, b: int) -> int:
    """splitmix64 finalizer over (salt, backend)."""
    x = (b * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) & (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (1 << 64) - 1
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (1 << 64) - 1
    return x ^ (x >> 31)


def maglev_table(backends: tuple, size: int) -> np.ndarray:
    """Maglev's population (Eisenbud et al., NSDI'16): backends take turns
    filling their next preferred free slot, by (offset, skip)."""
    n = len(backends)
    offset = [_mix64(1, b) % size for b in backends]
    skip = [_mix64(2, b) % (size - 1) + 1 for b in backends]
    entry = np.full(size, -1, np.int32)
    nxt = [0] * n
    filled = 0
    while filled < size:
        for i in range(n):
            c = (offset[i] + nxt[i] * skip[i]) % size
            while entry[c] >= 0:
                nxt[i] += 1
                c = (offset[i] + nxt[i] * skip[i]) % size
            entry[c] = i
            nxt[i] += 1
            filled += 1
            if filled == size:
                break
    return entry


def maglev_pick(lb: Maglev, table, ips, p) -> torch.Tensor:
    """The backend address of each packet's 5-tuple hash."""
    h = p["src_ip"].to(torch.int32)
    for v in (p["dst_ip"], p["src_port"], p["dst_port"], p["proto"]):
        h = (h * 1000003) ^ v.to(torch.int32)
    h = h & 0x7FFFFFFF
    return ips[table[torch.remainder(h, lb.table_size).to(torch.int64)]
               .to(torch.int64)]


def run_chain(chain: tuple, nstate: dict, p: dict, sequential_nat=True):
    """Run the chain's NFs in order over the header fields; returns the
    packets (payload untouched) and updates NAT's table and stale-hit
    count in ``nstate``."""
    out = dict(p)
    alive = p["alive"]
    for i, nf in enumerate(chain):
        if isinstance(nf, Firewall):
            rules = nstate[i]
            alive = alive & ~(out["src_ip"][..., None] == rules).any(-1)
        elif isinstance(nf, Nat):
            mapped, stale = nat_walk(nf, nstate[i]["table"], out["src_ip"],
                                     out["src_port"], alive, sequential_nat)
            ok = alive & (mapped >= 0)
            out["src_ip"] = torch.where(ok, nf.nat_ip, out["src_ip"]) \
                .to(torch.int32)
            out["src_port"] = torch.where(ok, mapped, out["src_port"])
            alive = alive & (mapped >= 0)
            nstate[i]["stale_hits"] = nstate[i]["stale_hits"] + stale.sum(-1)
        elif isinstance(nf, Maglev):
            table, ips = nstate[i]
            out["alive"] = alive
            out["dst_ip"] = torch.where(alive, maglev_pick(nf, table, ips,
                                                           out), out["dst_ip"])
        else:
            raise ValueError(f"unknown NF {nf!r}")
    out["alive"] = alive
    return out


def init_chain(chain: tuple, pipes: int, device) -> dict:
    state = {}
    for i, nf in enumerate(chain):
        if isinstance(nf, Firewall):
            state[i] = torch.tensor(nf.rules, dtype=torch.int32,
                                    device=device)
        elif isinstance(nf, Nat):
            state[i] = dict(table=init_nat(nf, pipes, device),
                            stale_hits=torch.zeros(pipes, dtype=torch.int64,
                                                   device=device))
        elif isinstance(nf, Maglev):
            state[i] = (torch.from_numpy(maglev_table(
                nf.backends, nf.table_size)).to(device),
                torch.tensor(nf.backends, dtype=torch.int32, device=device))
    return state


# --------------------------------------------------------------------------
# the pipes, step by step
# --------------------------------------------------------------------------

def run(sw: Switch, chain: tuple, traces: dict, sequential_nat=True) -> dict:
    """Step P pipes over (P, T, chunk, ...) traces, then drain the window
    (and the lane).  Chunk ``t`` is split at step ``t`` and merges at step
    ``t + window``; with the lane, Split's recirculation candidates take a
    second pass at the next step before they travel on."""
    pipes, steps, chunk = traces["src_ip"].shape
    dev = traces["src_ip"].device
    lane_w = sw.lane(chunk)
    pad = sw.window + (1 if lane_w else 0)
    st = init_switch(sw, pipes, dev)
    nstate = init_chain(chain, pipes, dev)
    ring = [dead(pipes, chunk + lane_w, sw.pmax, dev)
            for _ in range(max(sw.window, 1))]
    lane = dead(pipes, lane_w, sw.pmax, dev) if lane_w else None
    tel = {n: [] for n in TELEMETRY}
    merged, occ = [], []
    for t in range(steps + pad):
        cin = ({n: traces[n][:, t] for n in FIELDS} if t < steps
               else dead(pipes, chunk, sw.pmax, dev))
        tel["wire_pkts"].append(alive_pkts(cin))
        tel["wire_bytes"].append(alive_bytes(cin))
        if lane_w:
            rout = recirculate(sw, st, lane)
        out = split(sw, st, cin)
        if lane_w:
            out, lane, denied = recirc_select(sw, out, lane_w)
            c = st["counters"]
            c["recirc_budget_drops"] = c["recirc_budget_drops"] + denied
            tel["recirc_pkts"].append(alive_pkts(lane))
            tel["recirc_bytes"].append(alive_bytes(lane))
            nf_in = {n: torch.cat([rout[n], out[n]], dim=1) for n in FIELDS}
        else:
            tel["recirc_pkts"].append(torch.zeros_like(alive_pkts(cin)))
            tel["recirc_bytes"].append(torch.zeros_like(alive_pkts(cin)))
            nf_in = out
        tel["to_server_pkts"].append(alive_pkts(nf_in))
        tel["to_server_bytes"].append(alive_bytes(nf_in))
        nf_out = run_chain(chain, nstate, nf_in, sequential_nat)
        if sw.window == 0:
            back = nf_out
        else:
            back = ring[t % sw.window]
            ring[t % sw.window] = nf_out
        m = merge(sw, st, back)
        tel["from_server_pkts"].append(alive_pkts(back))
        tel["from_server_bytes"].append(alive_bytes(back))
        tel["merged_pkts"].append(alive_pkts(m))
        tel["merged_bytes"].append(alive_bytes(m))
        occ.append((st["meta_exp"] > 0).sum(-1))
        if t >= sw.window:
            merged.append(m)
    stale = sum((s["stale_hits"] for s in nstate.values()
                 if isinstance(s, dict)),
                torch.zeros(pipes, dtype=torch.int64, device=dev))
    return dict(
        merged={n: torch.stack([m[n] for m in merged], dim=1)
                for n in FIELDS},
        state={k: st[k] for k in ("tbl_idx", "clk", "meta_exp", "meta_clk",
                                  "meta_len", "ptable")},
        counters=st["counters"],
        telemetry={n: torch.stack(v, 1).to(torch.int64).sum(1)
                   for n, v in tel.items()},
        occ=torch.stack(occ, 1).to(torch.int64),
        nat_stale_hits=stale)
