"""Plain PyTorch versions of every dataplane primitive (port of
``repro.backend.ref``).

One function per registry primitive.  They run on CPU tensors by default
and on CUDA tensors only when ``backend="ref"`` is chosen explicitly.  Each
dataplane kernel in ``repro_torch.kernels`` must match its primitive here
bit-exactly, and every dataplane function accepts leading batch (pipe)
dimensions.  ``paged_decode_attention`` (the serving side, port of
``repro.kernels.paged_attention.ref``) is floating point: its kernel agrees
within the reference's tolerances (atol 0.02, rtol 0.05).

Index rules follow the reference exactly: a negative index counts from the
end (``i + n``), an out-of-range read is clamped and an out-of-range write
is dropped.  ``payload_store``/``payload_fetch`` update ``table`` in place
(the port's counterpart of the reference's donated table buffer) and
return it.
"""
from __future__ import annotations

import torch

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
