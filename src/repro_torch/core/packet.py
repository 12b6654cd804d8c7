"""Struct-of-tensors packet batches (port of ``repro.core.packet``).

A batch of B packets: a fixed 42-byte Ethernet+IPv4+UDP header (paper
footnote 1), an opaque payload byte buffer of ``PMAX`` bytes with
``payload_len`` live bytes, and the optional 7-byte PayloadPark header
(paper Fig. 2).  Every field may carry leading batch dimensions (the
engine's pipe and time axes): header fields are (..., B) and ``payload``
is (..., B, PMAX).  ``wire_bytes`` serializes packets to their on-wire
bytes for the wire-level equivalence checks (paper §6.2.6).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

ETH_HDR_BYTES = 14
IPV4_HDR_BYTES = 20
UDP_HDR_BYTES = 8
HDR_BYTES = ETH_HDR_BYTES + IPV4_HDR_BYTES + UDP_HDR_BYTES  # 42, paper §1
PP_HDR_BYTES = 7  # paper Fig. 2 / §7

OP_MERGE = 0
OP_DROP = 1


@dataclasses.dataclass
class PacketBatch:
    """A batch of UDP packets (struct of tensors).

    Header fields are int32 (MACs truncated to 31 bits, as in the
    reference); ``payload`` is uint8; ``alive``/``pp_valid`` are bool.
    """

    dst_mac: torch.Tensor
    src_mac: torch.Tensor
    src_ip: torch.Tensor     # uint32 bit pattern in int32
    dst_ip: torch.Tensor
    proto: torch.Tensor
    src_port: torch.Tensor
    dst_port: torch.Tensor
    payload_len: torch.Tensor
    payload: torch.Tensor    # (..., B, PMAX) uint8
    alive: torch.Tensor      # (..., B) bool

    pp_valid: torch.Tensor   # PayloadPark header present on the wire
    pp_enb: torch.Tensor     # ENB bit
    pp_op: torch.Tensor      # OP bit (OP_MERGE / OP_DROP)
    pp_ti: torch.Tensor      # TAG.table_index
    pp_clk: torch.Tensor     # TAG.generation (clock)
    pp_crc: torch.Tensor     # TAG.CRC-16 over (ti, clk)

    @property
    def batch_size(self) -> int:
        return self.src_ip.shape[-1]

    @property
    def pmax(self) -> int:
        return self.payload.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.src_ip.device

    def pkt_len(self) -> torch.Tensor:
        """Total on-wire length: 42B header + optional PP header + payload."""
        pp = torch.where(self.pp_valid, PP_HDR_BYTES, 0)
        return (HDR_BYTES + pp + self.payload_len).to(torch.int32)

    def replace(self, **kw) -> "PacketBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PacketBatch":
        return map_fields(lambda _n, a: a.to(device), self)


FIELDS = tuple(f.name for f in dataclasses.fields(PacketBatch))


def map_fields(fn, *batches: PacketBatch) -> PacketBatch:
    """``PacketBatch(name=fn(name, a.name, b.name, ...))`` field by field."""
    return PacketBatch(**{
        n: fn(n, *(getattr(b, n) for b in batches)) for n in FIELDS})


def _pkt_axis(name: str) -> int:
    """The packet axis of a field, counted from the end."""
    return -2 if name == "payload" else -1


def _field_dtype(name: str) -> torch.dtype:
    if name == "payload":
        return torch.uint8
    if name in ("alive", "pp_valid"):
        return torch.bool
    return torch.int32


def make_udp_batch(gen: torch.Generator | int, batch: int, pkt_len,
                   pmax: int = 2048, src_ip=None, dst_ip=None, src_port=None,
                   dst_port=None, device=DEFAULT_DEVICE) -> PacketBatch:
    """A batch of UDP packets with pseudorandom headers and payload bytes.

    ``gen`` is a CPU ``torch.Generator`` (or a seed): draws happen on the
    CPU and the batch is then moved to ``device``, so one seed gives the
    same packets on every device.  ``pkt_len`` is a scalar or a (B,)
    tensor of total packet lengths including the 42-byte header.
    """
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32)

    pkt_len = torch.as_tensor(pkt_len, dtype=torch.int32).expand(batch)
    payload_len = torch.clamp(pkt_len - HDR_BYTES, min=0)
    payload = draw(0, 256, (batch, pmax))
    mask = torch.arange(pmax)[None, :] < payload_len[:, None]
    payload = torch.where(mask, payload, 0).to(torch.uint8)

    def field(lo, hi, override):
        if override is not None:
            return torch.as_tensor(override, dtype=torch.int32).expand(
                batch).clone()
        return draw(lo, hi, (batch,))

    z = torch.zeros(batch, dtype=torch.int32)
    pkts = PacketBatch(
        dst_mac=draw(0, (1 << 31) - 1, (batch,)),
        src_mac=draw(0, (1 << 31) - 1, (batch,)),
        src_ip=field(0, (1 << 31) - 1, src_ip),
        dst_ip=field(0, (1 << 31) - 1, dst_ip),
        proto=torch.full((batch,), 17, dtype=torch.int32),
        src_port=field(1024, 65536, src_port),
        dst_port=field(1024, 65536, dst_port),
        payload_len=payload_len.clone(),
        payload=payload,
        alive=torch.ones(batch, dtype=torch.bool),
        pp_valid=torch.zeros(batch, dtype=torch.bool),
        pp_enb=z, pp_op=z.clone(), pp_ti=z.clone(), pp_clk=z.clone(),
        pp_crc=z.clone(),
    )
    return pkts.to(dev)


def dead_batch(batch: int, pmax: int, device=DEFAULT_DEVICE,
               lead: tuple[int, ...] = ()) -> PacketBatch:
    """All-dead batch (``alive=False``, zero fields): the padding of ring
    seeds, trace tails and steering overflow rows.  Every Split/Merge/NF
    state update is predicated on ``alive``, so dead rows are no-ops."""
    dev = resolve_device(device)

    def make(name):
        shape = lead + ((batch, pmax) if name == "payload" else (batch,))
        return torch.zeros(shape, dtype=_field_dtype(name), device=dev)

    return PacketBatch(**{n: make(n) for n in FIELDS})


def gather_rows(p: PacketBatch, idx: torch.Tensor) -> PacketBatch:
    """Gather packets by row index along the packet axis; any index equal
    to ``batch_size`` yields a dead packet.  ``idx`` is (..., K) with the
    batch's leading shape."""

    def take(name, a):
        ax = _pkt_axis(name)
        pad_shape = list(a.shape)
        pad_shape[ax] = 1
        padded = torch.cat([a, a.new_zeros(pad_shape)], dim=ax)
        if name == "payload":
            i = idx[..., None].expand(idx.shape + (a.shape[-1],))
        else:
            i = idx
        return torch.gather(padded, ax, i.to(torch.int64))

    return map_fields(take, p)


def to_time_major(p: PacketBatch, chunk: int) -> PacketBatch:
    """Reshape the packet axis B into (T, chunk) for the engine.  B must be
    a multiple of ``chunk``."""
    b = p.batch_size
    if b % chunk:
        raise ValueError(f"batch {b} is not a multiple of chunk {chunk}")

    def split(name, a):
        ax = a.ndim + _pkt_axis(name)
        return a.reshape(a.shape[:ax] + (b // chunk, chunk) + a.shape[ax + 1:])

    return map_fields(split, p)


def from_time_major(p: PacketBatch) -> PacketBatch:
    """Inverse of ``to_time_major``: (..., T, chunk) -> (..., T*chunk)."""

    def merge(name, a):
        ax = a.ndim + _pkt_axis(name) - 1
        return a.reshape(a.shape[:ax] + (a.shape[ax] * a.shape[ax + 1],)
                         + a.shape[ax + 2:])

    return map_fields(merge, p)


def _bytes_of(v: torch.Tensor, n: int) -> torch.Tensor:
    """Little-endian bytes of an int32 field: (..., n) uint8 (bytes past the
    fourth are zero, as in the reference)."""
    v = v.to(torch.int32)
    cols = [((v >> (8 * i)) & 0xFF).to(torch.uint8) if i < 4
            else torch.zeros_like(v, dtype=torch.uint8) for i in range(n)]
    return torch.stack(cols, dim=-1)


def wire_bytes(p: PacketBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """Serialize each packet to its on-wire bytes (..., B, 42+7+PMAX) uint8.

    Returns (bytes, lengths).  The PayloadPark header region is present only
    when ``pp_valid``; dead packets serialize to zeros with length 0.
    """
    pmax = p.pmax
    width = HDR_BYTES + PP_HDR_BYTES + pmax
    zero = torch.zeros_like(p.proto)
    hdr = torch.cat([
        _bytes_of(p.dst_mac, 6),
        _bytes_of(p.src_mac, 6),
        _bytes_of(torch.full_like(p.proto, 0x0800), 2),  # ethertype
        _bytes_of(p.proto, 1),
        _bytes_of(p.src_ip, 4),
        _bytes_of(p.dst_ip, 4),
        _bytes_of(zero, 11),  # ver/ihl/tos/id/ttl/cksum pad
        _bytes_of(p.src_port, 2),
        _bytes_of(p.dst_port, 2),
        _bytes_of(p.payload_len + UDP_HDR_BYTES, 2),
        _bytes_of(zero, 2),  # udp cksum
    ], dim=-1)
    pp = torch.cat([
        _bytes_of(p.pp_enb | (p.pp_op << 1), 1),
        _bytes_of(p.pp_ti, 2),
        _bytes_of(p.pp_clk, 2),
        _bytes_of(p.pp_crc, 2),
    ], dim=-1)
    pp = torch.where(p.pp_valid[..., None], pp, 0).to(torch.uint8)

    lead = p.src_ip.shape
    col = torch.arange(width, device=p.device).expand(lead + (width,))
    pp_len = torch.where(p.pp_valid, PP_HDR_BYTES, 0)
    src_idx = col - HDR_BYTES - pp_len[..., None]
    in_pp = (col >= HDR_BYTES) & (src_idx < 0)
    pp_idx = torch.clamp(col - HDR_BYTES, 0, PP_HDR_BYTES - 1)
    payload_region = (src_idx >= 0) & (src_idx < p.payload_len[..., None])
    gathered = torch.gather(p.payload, -1,
                            torch.clamp(src_idx, 0, pmax - 1).to(torch.int64))
    out = torch.zeros(lead + (width,), dtype=torch.uint8, device=p.device)
    out[..., :HDR_BYTES] = hdr
    out = torch.where(in_pp, torch.gather(pp, -1, pp_idx.to(torch.int64)), out)
    out = torch.where(payload_region, gathered, out)
    out = torch.where(p.alive[..., None], out, 0).to(torch.uint8)
    length = torch.where(p.alive, p.pkt_len(), 0).to(torch.int32)
    return out, length
