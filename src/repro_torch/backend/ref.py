"""Plain PyTorch versions of every dataplane primitive (port of
``repro.backend.ref``).

One function per registry primitive.  They run on CPU tensors by default
and on CUDA tensors only when ``backend="ref"`` is chosen explicitly.  Each
dataplane kernel in ``repro_torch.kernels`` must match its primitive here
bit-exactly, and every dataplane function accepts leading batch (pipe)
dimensions.  ``paged_decode_attention`` (the serving side, port of
``repro.kernels.paged_attention.ref``) is floating point: its kernel agrees
within the reference's tolerances (atol 0.02, rtol 0.05).  ``nf_chain`` is
the NF chain's whole header pass (firewall, NAT, Maglev LB, MAC swap);
NAT's insert walk (``nat_insert``) is the port's copy of the reference's
``lax.scan`` over packets.

Index rules follow the reference exactly: a negative index counts from the
end (``i + n``), an out-of-range read is clamped and an out-of-range write
is dropped.  ``payload_store``/``payload_fetch`` update ``table`` in place
(the port's counterpart of the reference's donated table buffer) and
return it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.packet import OP_DROP

# ---------------------------------------------------------------------------
# crc16_tag — PayloadPark header tag CRC (paper §3.2, Fig. 2)
# ---------------------------------------------------------------------------

CRC_POLY = 0x1021
CRC_INIT = 0xFFFF


def crc16_bytes(data: torch.Tensor) -> torch.Tensor:
    """CRC-16/CCITT-FALSE over the trailing axis of byte values in
    [0, 255]: (..., N) -> (...,) int32, bit by bit."""
    data = data.to(torch.int32)
    crc = torch.full(data.shape[:-1], CRC_INIT, dtype=torch.int32,
                     device=data.device)
    for i in range(data.shape[-1]):
        crc = crc ^ (data[..., i] << 8)
        for _ in range(8):
            hi = (crc >> 15) & 1
            crc = (crc << 1) & 0xFFFF
            crc = torch.where(hi == 1, crc ^ CRC_POLY, crc)
    return crc


def tag_bytes(ti: torch.Tensor, clk: torch.Tensor) -> torch.Tensor:
    """(ti, clk) as 4 little-endian bytes: (..., 4) int32."""
    ti = ti.to(torch.int32)
    clk = clk.to(torch.int32)
    return torch.stack(
        [ti & 0xFF, (ti >> 8) & 0xFF, clk & 0xFF, (clk >> 8) & 0xFF], dim=-1)


def crc16_tag(ti: torch.Tensor, clk: torch.Tensor) -> torch.Tensor:
    """CRC over the PayloadPark tag: (...,) int32."""
    return crc16_bytes(tag_bytes(ti, clk))


# ---------------------------------------------------------------------------
# acl_match — firewall blocked-IP linear probe (paper §6.1)
# ---------------------------------------------------------------------------

def acl_match(src_ip: torch.Tensor, rules: torch.Tensor) -> torch.Tensor:
    """src_ip: (...,) int32; rules: (R,) int32 -> (...,) bool blocked."""
    return (src_ip[..., None] == rules).any(dim=-1)


# ---------------------------------------------------------------------------
# maglev_select — L4-LB backend selection (paper §6.1, Maglev NSDI'16)
# ---------------------------------------------------------------------------

def maglev_hash5(src_ip, dst_ip, src_port, dst_port, proto) -> torch.Tensor:
    """int32 5-tuple hash; the multiply wraps like uint32."""
    h = src_ip.to(torch.int32)
    for v in (dst_ip, src_port, dst_port, proto):
        h = (h * 1000003) ^ v.to(torch.int32)
    return h & 0x7FFFFFFF


def maglev_select(src_ip, dst_ip, src_port, dst_port, proto,
                  table, backend_ips) -> torch.Tensor:
    """Backend VIP per packet: hash the 5-tuple, index the lookup table.

    ``table`` is (T,), shared by every pipe, or (..., T) with one row per
    pipe of the (..., B) packets (an LB fault picks the live or degraded
    table per pipe); each packet reads its own pipe's row."""
    h = maglev_hash5(src_ip, dst_ip, src_port, dst_port, proto)
    idx = torch.remainder(h, table.shape[-1]).to(torch.int64)
    if table.dim() == 1:
        chosen = table[idx]
    else:
        chosen = torch.gather(table, -1, idx)
    return backend_ips[chosen.to(torch.int64)]


# ---------------------------------------------------------------------------
# payload_store / payload_fetch — parked-payload movement (paper Fig. 4)
# ---------------------------------------------------------------------------

def norm_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices count from the end, as in the reference."""
    return torch.where(idx < 0, idx + n, idx)


def _rows_of(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table (..., M, W) gathered at rows (..., K) -> (..., K, W)."""
    i = rows.to(torch.int64)[..., None].expand(rows.shape + table.shape[-1:])
    return torch.gather(table, -2, i)


def payload_store(table, payload, idx, enb) -> torch.Tensor:
    """Split stage 3..N: ``table[idx[b]] = payload[b]`` where ``enb[b]``,
    in place.  table: (..., M, W); payload: (..., B, W); idx, enb: (..., B).

    Duplicate enabled rows resolve as the sequential TPU kernel does — the
    last writer wins — through a per-row max over packet positions, so the
    result does not depend on scatter order on any device."""
    m = table.shape[-2]
    b = idx.shape[-1]
    rows = norm_index(idx.to(torch.int64), m)
    ok = enb & (rows >= 0) & (rows < m)
    order = torch.arange(b, device=idx.device).expand(idx.shape)
    winner = torch.full(table.shape[:-1], -1, dtype=torch.int64,
                        device=table.device)
    winner.scatter_reduce_(-1, rows.clamp(0, m - 1),
                           torch.where(ok, order, -1), reduce="amax")
    new = _rows_of(payload, winner.clamp(min=0))
    table.copy_(torch.where((winner >= 0)[..., None], new, table))
    return table


def payload_fetch(table, idx, mask):
    """Merge stage 3..N gather + clear (Alg. 2 lines 21-23), in place.

    Returns ``(gathered (..., B, W), table)``: rows where ``mask`` is unset
    gather zeros and leave the table untouched."""
    m = table.shape[-2]
    rows = norm_index(idx.to(torch.int64), m)
    gathered = _rows_of(table, rows.clamp(0, m - 1))
    gathered = torch.where(mask[..., None], gathered, 0).to(table.dtype)
    wr = mask & (rows >= 0) & (rows < m)
    clear = torch.zeros(table.shape[:-1], dtype=torch.int32,
                        device=table.device)
    clear.scatter_reduce_(-1, rows.clamp(0, m - 1), wr.to(torch.int32),
                          reduce="amax")
    table.masked_fill_(clear.bool()[..., None], 0)
    return gathered, table


# ---------------------------------------------------------------------------
# split_control / merge_stage — the Split and Merge control passes (paper
# Algorithms 1 and 2), as the reference's ``lax.scan`` runs them
# ---------------------------------------------------------------------------

def _meta_row(meta: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """meta (..., M, 3) at slot (...,) int64 -> (..., 3)."""
    i = slot[..., None, None].expand(slot.shape + (1, 3))
    return torch.gather(meta, -2, i).squeeze(-2)


def _set_meta_row(meta: torch.Tensor, slot: torch.Tensor,
                  row: torch.Tensor) -> None:
    i = slot[..., None, None].expand(slot.shape + (1, 3))
    meta.scatter_(-2, i, row[..., None, :])


def split_control(m, max_exp, max_clk, min_park_len, pass_bytes, tbl_idx,
                  clk, meta_exp, meta_clk, meta_len, alive, payload_len):
    """Split's sequential tagger + metadata-table pass and the tag CRC.

    ``m`` is the table's capacity and the other scalars are ParkConfig's;
    registers (...,), metadata (..., M) int32, packets (..., B).  Returns
    ``((tbl_idx, clk, meta_exp, meta_clk, meta_len), d)``: the new
    registers and (new) metadata tensors, and the per-packet decisions
    ``enb, ti, clk, evicted, skip_occupied, skip_small, park_len, crc``.

    The metadata (expiry, generation, length) is packed into one
    (..., M, 3) tensor, so each packet position costs one gather and one
    scatter for every pipe at once."""
    plen = payload_len
    eligible = alive & (plen >= min_park_len)

    # -- stage 1: packet tagger (Alg. 1 lines 4-7).  Each eligible packet
    # advances TI and CLK by one, so the sequence is a running count; the
    # generation clock wraps to 1, skipping 0 (0 marks a free slot).
    k = torch.cumsum(eligible.to(torch.int64), dim=-1)
    ti0 = tbl_idx.to(torch.int64)[..., None]
    clk0 = clk.to(torch.int64)[..., None]
    ti_n = torch.remainder(ti0 + k, m)
    clk_n = torch.where(
        k > 0, torch.remainder(clk0 - 1 + k, max_clk - 1) + 1, clk0)
    park_len = torch.clamp(plen, max=pass_bytes)

    # -- stage 2: metadata probe (Alg. 1 lines 10-25), packet by packet ----
    meta = torch.stack([meta_exp, meta_clk, meta_len], dim=-1)
    claims, evicts, avails = [], [], []
    for i in range(alive.shape[-1]):
        slot, e = ti_n[..., i], eligible[..., i]
        row = _meta_row(meta, slot)
        exp_pre, clk_cur, len_cur = row.unbind(-1)
        available = exp_pre <= 1         # expiry reaches 0 (lines 11-14)
        evicted = e & (exp_pre == 1)
        claim = e & available
        new_exp = torch.where(
            e, torch.where(available, max_exp, exp_pre - 1), exp_pre)
        new_clk = torch.where(claim, clk_n[..., i],
                              torch.where(evicted, 0, clk_cur))
        new_len = torch.where(claim, park_len[..., i], len_cur)
        _set_meta_row(meta, slot, torch.stack(
            [new_exp, new_clk, new_len], dim=-1).to(torch.int32))
        claims.append(claim)
        evicts.append(evicted)
        avails.append(available)

    def stacked(xs):
        if xs:
            return torch.stack(xs, dim=-1)
        return torch.zeros_like(alive)

    enb, evicted, available = stacked(claims), stacked(evicts), stacked(avails)
    ti32, clk32 = ti_n.to(torch.int32), clk_n.to(torch.int32)
    d = dict(
        enb=enb, ti=ti32, clk=clk32,
        evicted=evicted,
        skip_occupied=eligible & ~available,
        skip_small=alive & (plen < min_park_len),
        park_len=torch.where(enb, park_len, 0).to(torch.int32),
        crc=crc16_tag(ti32, clk32),
    )
    regs = (ti_n[..., -1].to(torch.int32) if alive.shape[-1] else tbl_idx,
            clk_n[..., -1].to(torch.int32) if alive.shape[-1] else clk)
    return regs + tuple(meta.unbind(-1)), d


def split_rounds(m, max_exp, max_clk, min_park_len, pass_bytes, tbl_idx,
                 clk, meta_exp, meta_clk, meta_len, alive, payload_len):
    """``split_control``'s result in the order ``csrc/split_control.cu``
    probes: a packet with running count k touches only slot (TI + k) mod M,
    so the eligible packets of k in (jM, (j + 1)M] name distinct slots and
    round j probes them all at once, one gather and one scatter; the
    rounds run j = 0 .. ceil(total / M) - 1.  The kernel's per-slot walk
    takes each slot's packets in the same order (k, k + M, ...).  Same
    arguments and result as ``split_control``.  Not on any path: the tests
    and ``chip_smoke.py`` hold the kernel's schedule with it."""
    plen = payload_len
    eligible = alive & (plen >= min_park_len)
    k = torch.cumsum(eligible.to(torch.int64), dim=-1)
    ti0 = tbl_idx.to(torch.int64)[..., None]
    clk0 = clk.to(torch.int64)[..., None]
    ti_n = torch.remainder(ti0 + k, m)
    clk_n = torch.where(
        k > 0, torch.remainder(clk0 - 1 + k, max_clk - 1) + 1, clk0)
    park_len = torch.clamp(plen, max=pass_bytes)

    # row M takes the scatters of the packets that a round does not probe
    meta = torch.stack([meta_exp, meta_clk, meta_len], dim=-1)
    meta = torch.cat([meta, torch.zeros_like(meta[..., :1, :])], dim=-2)
    enb = torch.zeros_like(eligible)
    evicted = torch.zeros_like(eligible)
    available = torch.zeros_like(eligible)
    total = int(k[..., -1].max()) if k.numel() else 0
    for j in range(-(-total // m)):
        on = eligible & (k > j * m) & (k <= (j + 1) * m)
        exp_pre, clk_cur, len_cur = _rows_of(meta, ti_n).unbind(-1)
        avail = exp_pre <= 1
        claim = on & avail
        row = torch.stack([
            torch.where(avail, max_exp, exp_pre - 1),
            torch.where(avail, clk_n, clk_cur),
            torch.where(avail, park_len, len_cur)], dim=-1)
        slot = torch.where(on, ti_n, m)
        meta.scatter_(-2, slot[..., None].expand(slot.shape + (3,)),
                      row.to(torch.int32))
        enb = enb | claim
        evicted = evicted | (on & (exp_pre == 1))
        available = available | (on & avail)
    d = dict(
        enb=enb, ti=ti_n.to(torch.int32), clk=clk_n.to(torch.int32),
        evicted=evicted,
        skip_occupied=eligible & ~available,
        skip_small=alive & (plen < min_park_len),
        park_len=torch.where(enb, park_len, 0).to(torch.int32),
        crc=crc16_tag(ti_n.to(torch.int32), clk_n.to(torch.int32)),
    )
    regs = (d["ti"][..., -1] if alive.shape[-1] else tbl_idx,
            d["clk"][..., -1] if alive.shape[-1] else clk)
    return regs + tuple(meta[..., :m, :].unbind(-1)), d


def merge_stage(table, meta_exp, meta_clk, meta_len, alive, pp_valid,
                pp_enb, pp_op, pp_ti, pp_clk, pp_crc):
    """Merge's tag check, sequential metadata validation/free pass (Alg. 2
    lines 11-13) and the gather-and-clear of the matched rows.

    table (..., M, W) uint8, updated in place; metadata (..., M) int32;
    header fields (..., B).  Returns ``((meta_exp, meta_clk, meta_len), d,
    parked (..., B, W), table)`` with the per-packet decisions ``matched,
    premature, crc_fail, disabled, is_drop_op, park_len`` in ``d``.  The
    tag CRC check is per-packet math, so it runs batched before the loop."""
    m = meta_exp.shape[-1]
    crc_ok = crc16_tag(pp_ti, pp_clk) == pp_crc
    is_pp = alive & pp_valid & (pp_enb == 1)
    checked = is_pp & crc_ok
    slot = norm_index(pp_ti.to(torch.int64), m)
    in_range = (slot >= 0) & (slot < m)
    slot = torch.clamp(slot, 0, m - 1)

    meta = torch.stack([meta_exp, meta_clk, meta_len], dim=-1)
    matches, gens, lens = [], [], []
    for i in range(alive.shape[-1]):
        s = slot[..., i]
        row = _meta_row(meta, s)
        gen_ok = row[..., 1] == pp_clk[..., i]
        matched = checked[..., i] & gen_ok               # Alg. 2 line 11
        # free the slot (Alg. 2 line 13); an out-of-range tag frees nothing
        _set_meta_row(meta, s, torch.where(
            (matched & in_range[..., i])[..., None], 0, row))
        matches.append(matched)
        gens.append(gen_ok)
        lens.append(torch.where(matched, row[..., 2], 0))

    def stacked(xs, like):
        return torch.stack(xs, dim=-1) if xs else torch.zeros_like(like)

    matched = stacked(matches, alive)
    gen_ok = stacked(gens, alive)
    d = dict(
        matched=matched,
        premature=checked & ~gen_ok,
        crc_fail=is_pp & ~crc_ok,
        disabled=alive & pp_valid & (pp_enb == 0),
        is_drop_op=matched & (pp_op == OP_DROP),
        park_len=stacked(lens, pp_ti).to(torch.int32),
    )
    # -- stage 3..N: gather payload blocks, then clear the rows ------------
    parked, table = payload_fetch(table, pp_ti, matched)
    return tuple(meta.unbind(-1)), d, parked, table


# ---------------------------------------------------------------------------
# merge_payload — Merge's packet transformation: payload := parked ++
# carried remainder, and the header fields after the decisions
# ---------------------------------------------------------------------------

# the PacketBatch fields merge_payload takes and returns, in order, and
# the decisions of merge_stage it takes after the parked rows
MERGE_PAYLOAD_FIELDS = ("payload", "payload_len", "alive", "pp_valid",
                        "pp_enb", "pp_op", "pp_ti", "pp_clk", "pp_crc")
MERGE_DECISIONS = ("matched", "premature", "crc_fail", "disabled",
                   "is_drop_op", "park_len")


def merge_payload(payload, payload_len, alive, pp_valid, pp_enb, pp_op,
                  pp_ti, pp_clk, pp_crc, parked, matched, premature,
                  crc_fail, disabled, is_drop_op, park_len):
    """Merge's packet transformation after ``merge_stage``'s decisions.

    payload (..., B, pmax) uint8, header fields (..., B), parked (..., B,
    W) uint8 and the decisions of ``merge_stage`` (..., B).  A forwarded
    packet (disabled, or matched and not an explicit drop) gets its parked
    prefix back in front of its payload, zeros past the new length; a
    dropped or forwarded packet loses its PayloadPark header.  Returns new
    tensors of ``MERGE_PAYLOAD_FIELDS``, in that order."""
    pmax, width = payload.shape[-1], parked.shape[-1]
    fetch = matched & ~is_drop_op
    shift = torch.where(fetch, park_len, 0)
    col = torch.arange(pmax, device=shift.device)
    rem_idx = torch.clamp(col - shift[..., None], 0, pmax - 1)
    carried = torch.gather(payload, -1, rem_idx.to(torch.int64))
    if pmax >= width:
        parked_full = torch.nn.functional.pad(parked, (0, pmax - width))
    else:
        parked_full = parked[..., :pmax]
    new_payload = torch.where(col < shift[..., None], parked_full, carried)
    new_len = payload_len + shift
    new_payload = torch.where(col < new_len[..., None], new_payload, 0)

    forwarded = disabled | fetch
    dropped = premature | crc_fail | is_drop_op
    gone = forwarded | dropped
    zero = torch.zeros_like(pp_op)
    return (torch.where(forwarded[..., None], new_payload,
                        payload).to(torch.uint8),
            torch.where(forwarded, new_len, payload_len).to(torch.int32),
            alive & ~dropped,
            pp_valid & ~gone,
            torch.where(gone, zero, pp_enb),
            torch.where(gone, zero, pp_op),
            torch.where(gone, zero, pp_ti),
            torch.where(gone, zero, pp_clk),
            torch.where(gone, zero, pp_crc))


# ---------------------------------------------------------------------------
# nat_insert / nf_chain — the NF chain's header pass (paper §6.1, §7): the
# firewall's match, NAT's insert walk and rewrite, the LB's selection and
# the MAC swap, stage after stage
# ---------------------------------------------------------------------------

NAT_PROBE_DEPTH = 8
NF_KINDS = ("fw", "nat", "lb", "macswap")
# the header fields the four NFs read or write, in the order ``nf_chain``
# takes and returns them
NF_FIELDS = ("alive", "src_ip", "dst_ip", "src_port", "dst_port", "proto",
             "src_mac", "dst_mac")
# the header fields each kind of stage reads and writes; a field that no
# stage of a chain writes comes back as the tensor that went in
NF_READS = {"fw": ("alive", "src_ip"),
            "nat": ("alive", "src_ip", "src_port"),
            "lb": ("alive", "src_ip", "dst_ip", "src_port", "dst_port",
                   "proto"),
            "macswap": ("alive", "src_mac", "dst_mac")}
NF_WRITES = {"fw": ("alive",),
             "nat": ("alive", "src_ip", "src_port"),
             "lb": ("dst_ip",),
             "macswap": ("src_mac", "dst_mac")}


# NAT's hash constants as the reference writes them, signed int32: the
# golden ratio 0x9E3779B9 and the multipliers 0x85EBCA6B and 0xC2B2AE3D
# (the reference's docstring names the murmur3 finalizer's 0xC2B2AE35; the
# value it uses is 0xC2B2AE3D, and so is the port's); csrc/nf_chain.cu
# holds the same three literals
NAT_HASH_CONSTS = (-1640531527, -2048144789, -1028477379)


def nat_hash(ip: torch.Tensor, port: torch.Tensor,
             capacity: int) -> torch.Tensor:
    """int32 avalanche mix of the flow key; multiplies wrap like uint32,
    ``>>`` is arithmetic."""
    seed, mul1, mul2 = NAT_HASH_CONSTS
    h = ip.to(torch.int32) ^ seed
    h = (h * mul1) ^ port.to(torch.int32)
    h = h ^ (h >> 13)
    h = h * mul2
    return torch.remainder(h & 0x7FFFFFFF, capacity)


def nat_insert(src_ip, src_port, alive, key_ip, key_port, exp, capacity,
               base_port, max_exp):
    """NAT's flow-table walk, packet by packet in arrival order, as the
    reference's ``lax.scan`` runs it.

    Packets (..., B), tables (..., C) int32.  Returns ``(mapped,
    stale_hit, key_ip, key_port, exp)``: the external port of each packet
    (``base_port + slot``, -1 when it found no slot or was dead), whether
    it hit a binding that had aged out, and the new tables (new tensors).

    Each packet reads and writes only its ``NAT_PROBE_DEPTH`` probe slots,
    which are distinct (capacity >= NAT_PROBE_DEPTH), so one gather and one
    scatter of the packed (key_ip, key_port, exp) rows cover it for every
    pipe at once."""
    cap, depth = capacity, NAT_PROBE_DEPTH
    dev = src_ip.device
    ar = torch.arange(depth, device=dev)
    h = nat_hash(src_ip, src_port, cap)
    probe = torch.remainder(h[..., None] + ar, cap).to(torch.int64)
    table = torch.stack([key_ip, key_port, exp], dim=-1)

    def first(cond):
        """Probe position of the first True, ``depth`` if none."""
        return torch.where(cond, ar, depth).amin(dim=-1)

    mapped_l, stale_l = [], []
    for i in range(src_ip.shape[-1]):
        pidx = probe[..., i, :]
        gi = pidx[..., None].expand(pidx.shape + (3,))
        kip, kport, ex = torch.gather(table, -2, gi).unbind(-1)
        ip = src_ip[..., i, None]
        port = src_port[..., i, None]
        live_pkt = alive[..., i]
        live = ex > 0
        match = (kip == ip) & (kport == port)
        p_slot, p_stale, p_free = (first(live & match),
                                   first(~live & match), first(~live))
        found = p_slot < depth
        hit = live_pkt & found
        # the flow's mapping aged out while it was still sending: the
        # slot's port may be re-issued already, so count, drop and
        # tear the dead binding down
        stale_hit = live_pkt & ~found & (p_stale < depth)
        can_insert = live_pkt & ~found & ~stale_hit & (p_free < depth)
        exhausted = live_pkt & ~found & (p_free >= depth)
        p_w = torch.where(hit, p_slot,
                          torch.where(stale_hit, p_stale, p_free))
        at_w = (ar == p_w[..., None]) & \
            (hit | stale_hit | can_insert)[..., None]
        ci, sh = can_insert[..., None], stale_hit[..., None]
        new_ip = torch.where(at_w, torch.where(
            ci, ip, torch.where(sh, -1, kip)), kip)
        new_port = torch.where(at_w, torch.where(
            ci, port, torch.where(sh, -1, kport)), kport)
        # use refreshes the expiry; CLOCK ages the whole window when a
        # flow found neither its mapping nor a free slot
        new_ex = torch.where(at_w & ~sh, max_exp, ex)
        new_ex = torch.where(exhausted[..., None],
                             torch.clamp(ex - 1, min=0), new_ex)
        table.scatter_(-2, gi, torch.stack(
            [new_ip, new_port, new_ex], dim=-1).to(torch.int32))
        slot = torch.gather(pidx, -1,
                            p_w.clamp(max=depth - 1)[..., None])[..., 0]
        mapped_l.append(torch.where(hit | can_insert, base_port + slot, -1))
        stale_l.append(stale_hit)

    if mapped_l:
        mapped = torch.stack(mapped_l, dim=-1).to(torch.int32)
        stale_hit = torch.stack(stale_l, dim=-1)
    else:
        mapped = torch.full_like(src_port, -1)
        stale_hit = torch.zeros_like(alive)
    key_ip, key_port, exp = table.unbind(-1)
    return mapped, stale_hit, key_ip, key_port, exp


NAT_WAVE_CHUNK = 256  # kChunk in csrc/nf_chain.cu


def nat_waves(src_ip, src_port, alive, capacity, chunk=NAT_WAVE_CHUNK):
    """The order in which ``csrc/nf_chain.cu`` walks NAT's packets.

    Packets (..., B).  Returns (..., B) int64 waves, 0 for a dead packet.
    A live packet's wave is 1 + the largest wave of an earlier live packet
    whose probe window ``[h, h + NAT_PROBE_DEPTH) mod C`` overlaps its own
    (1 when there is none), counted within arrival-order chunks of
    ``chunk`` packets, each chunk's waves following the last one's.  A
    packet reads and writes only its window (``nat_insert``), so the
    packets of one wave commute, and walking the waves in order, each in
    any order, gives ``nat_insert``'s result.  Not on any path: the tests
    and ``chip_smoke.py`` hold the kernel's schedule with it."""
    probe = NAT_PROBE_DEPTH
    h = nat_hash(src_ip, src_port, capacity).to(torch.int64)
    wave = torch.zeros(h.shape, dtype=torch.int64, device=h.device)
    done = torch.zeros(h.shape[:-1], dtype=torch.int64, device=h.device)
    for c0 in range(0, h.shape[-1], chunk):
        hc, live = h[..., c0:c0 + chunk], alive[..., c0:c0 + chunk]
        n = hc.shape[-1]
        d = torch.remainder(hc[..., None, :] - hc[..., :, None], capacity)
        earlier = torch.ones(n, n, dtype=torch.bool, device=h.device).tril(-1)
        # pred[..., i, j]: packet j is live, earlier than i, and overlaps it
        pred = ((d < probe) | (d > capacity - probe)) & earlier \
            & live[..., None, :]
        pending, local, r = live.clone(), torch.zeros_like(hc), 0
        while bool(pending.any()):
            r += 1
            ready = pending & ~(pred & pending[..., None, :]).any(-1)
            local = torch.where(ready, r, local)
            pending = pending & ~ready
        wave[..., c0:c0 + n] = torch.where(live, local + done[..., None], 0)
        done = done + local.amax(-1)
    return wave


class FwState(NamedTuple):
    """A ``fw`` stage's state: the blocked source addresses."""

    rules: torch.Tensor        # (R,)


class NatState(NamedTuple):
    """A ``nat`` stage's state, named as ``Nat``'s state dict is."""

    key_ip: torch.Tensor       # (..., C)
    key_port: torch.Tensor     # (..., C)
    exp: torch.Tensor          # (..., C)
    stale_hits: torch.Tensor   # (...)


class NatConsts(NamedTuple):
    """A ``nat`` stage's constants."""

    nat_ip: int
    capacity: int
    base_port: int
    max_exp: int


class LbState(NamedTuple):
    """An ``lb`` stage's state: ``up`` is None (the live table) or a bool
    flag, 0-d or one per pipe, that picks the live or the degraded table
    (``table_down``, None when ``up`` is)."""

    table: torch.Tensor        # (T,)
    backend_ips: torch.Tensor  # (NB,)
    table_down: torch.Tensor | None
    up: torch.Tensor | None


class Stage(NamedTuple):
    """One NF of a chain as ``nf_chain`` takes it: its kind (one of
    ``NF_KINDS``), its state and its constants: ``FwState`` for ``fw``,
    ``NatState`` and ``NatConsts`` for ``nat``, ``LbState`` for ``lb``,
    nothing for ``macswap``."""

    kind: str
    state: tuple = ()
    consts: tuple = ()


def nf_chain(fields: tuple, stages: tuple):
    """The header pass of an NF chain: ``fields`` are the ``NF_FIELDS``
    tensors (..., B), ``stages`` a tuple of ``Stage``, run in order.

    Returns ``(fields, dropped, states)``: the header fields (new tensors
    for those the stages write, ``NF_WRITES``; the others as they came
    in), the OR of every stage's drop mask, and each stage's new state (a
    ``NatState`` of new tensors for NAT; the other kinds' states
    unchanged)."""
    alive, src_ip, dst_ip, src_port, dst_port, proto, src_mac, dst_mac = \
        fields
    dropped = torch.zeros_like(alive)
    states = []
    for st in stages:
        new_state = st.state
        if st.kind == "fw":
            blocked = acl_match(src_ip, st.state.rules)
            drop = alive & blocked
            alive = alive & ~blocked
        elif st.kind == "nat":
            nat, c = st.state, st.consts
            mapped, stale_hit, *tables = nat_insert(
                src_ip, src_port, alive, nat.key_ip, nat.key_port, nat.exp,
                c.capacity, c.base_port, c.max_exp)
            ok = alive & (mapped >= 0)
            drop = alive & (mapped < 0)
            src_ip = torch.where(ok, c.nat_ip, src_ip).to(torch.int32)
            src_port = torch.where(ok, mapped, src_port)
            alive = alive & ~drop
            new_state = NatState(*tables, (nat.stale_hits + stale_hit.sum(
                -1)).to(torch.int32))
        elif st.kind == "lb":
            lb = st.state
            table = lb.table
            if lb.up is not None:
                table = torch.where(lb.up[..., None], table, lb.table_down)
            new_dst = maglev_select(src_ip, dst_ip, src_port, dst_port,
                                    proto, table, lb.backend_ips)
            dst_ip = torch.where(alive, new_dst, dst_ip)
            drop = torch.zeros_like(alive)
        elif st.kind == "macswap":
            src_mac, dst_mac = (torch.where(alive, dst_mac, src_mac),
                                torch.where(alive, src_mac, dst_mac))
            drop = torch.zeros_like(alive)
        else:
            raise ValueError(f"unknown NF stage kind {st.kind!r} "
                             f"(have {NF_KINDS})")
        dropped = dropped | drop
        states.append(new_state)
    return ((alive, src_ip, dst_ip, src_port, dst_port, proto, src_mac,
             dst_mac), dropped, tuple(states))


# ---------------------------------------------------------------------------
# paged_attention — decode attention over the parked KV pages (serving)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths):
    """One query token per request over its paged KV history.

    q: (B, K, G, E); k_pages/v_pages: (P, page, K, E); page_table: (B, MP)
    int32 with -1 padding; lengths: (B,) tokens valid.  Returns
    (B, K, G, E) in q's dtype.

    Gather the pages (ids clamped into [0, P), as the reference's gather
    clamps), f32 scores scaled by E**-0.5, mask tokens at or beyond the
    length and tokens of -1 pages, softmax in f32, probabilities in the
    value dtype, f32 PV product.  A request with no live token gives zeros,
    as the CUDA kernel does (it never reads a -1 page); the reference
    returns the mean of the clamped pages' values there instead.
    """
    b, kh, g, e = q.shape
    npages, page = k_pages.shape[:2]
    mp = page_table.shape[1]
    pt = page_table.to(torch.int64).clamp(0, npages - 1)
    k = k_pages[pt].reshape(b, mp * page, kh, e)
    v = v_pages[pt].reshape(b, mp * page, kh, e)
    s = torch.einsum("bkge,btke->bkgt", q.float(), k.float()) * (e ** -0.5)
    pos = torch.arange(mp * page, device=q.device)[None, :]
    mask = (pos < lengths.to(torch.int64)[:, None]) \
        & (page_table >= 0).repeat_interleave(page, dim=1)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    norm = p.sum(dim=-1, keepdim=True)
    w = (p / norm).to(v.dtype).float()
    out = torch.einsum("bkgt,btke->bkge", w, v.float())
    out = torch.where(mask.any(dim=-1)[:, None, None, None], out, 0.0)
    return out.to(q.dtype)
