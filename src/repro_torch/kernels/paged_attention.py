"""paged_decode_attention on the card: CUDA kernel ``csrc/paged_attention.cu``.

Replaces ``repro/kernels/paged_attention/kernel.py::
paged_decode_attention_kernel`` (the TPU kernel runs a (B, MAX_PAGES) grid
in order and DMAs page ``pt[b, p]`` per step, -1 pages included and
masked).  Here one launch splits each request's token walk over blocks
(flash-decoding): a block takes one (request, KV head, 8 query rows) and
one range of ``split_tokens`` tokens, its 4 warps stage 16-token K/V tiles
with ``cp.async`` and multiply them on the tensor cores (bf16), and the
block that finishes last merges the splits' partials.  A -1 page is never
read.  Bound by bytes and latency: the live K and V rows.

``split_plan`` picks the split from host-known shapes only (never the
lengths, which would cost a device sync per call); ``launch_plan`` adds
the pipeline depth and the shared memory a block takes.
``paged_decode_attention_cuda`` launches the kernel and raises on CPU
tensors and on shapes it does not take (``ValueError``);
``paged_decode_attention`` is the ``auto`` entry, which takes the plain
version (``paged_decode_attention_plain``) only because its tensors lie on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.backend.ref import \
    paged_decode_attention as paged_decode_attention_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("paged_attention")

HEAD_DIMS = (16, 32, 64, 128, 256)  # 16: the reduced configs
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_SHARED = 227 * 1024  # bytes of shared memory a block may use

# the kernel's constants (csrc/paged_attention.cu)
WARPS = 4     # warps per block, each with its own 16-token tiles
TILE = 16     # tokens per warp tile
COLS = 8      # query rows per block
MAX_STAGES = 2  # K/V tiles in flight per warp
SMALL_WORDS = WARPS * 2 * COLS + WARPS * TILE * COLS + 2 * COLS + 4
# the split: about two blocks per SM of the H100's 132, at most 64 splits
# per head (the last block's merge takes two per lane).  A history of at
# most ONE_SPLIT_TOKENS (3 tiles per warp) is not split: the merge's round
# trip through memory costs more than the walk (PERF.md section 6)
TARGET_BLOCKS = 2 * 132
MAX_SPLITS = 64
ONE_SPLIT_TOKENS = 3 * WARPS * TILE

__all__ = ["COUNT", "launch_plan", "paged_decode_attention",
           "paged_decode_attention_cuda", "paged_decode_attention_plain",
           "shared_bytes", "split_plan"]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(b: int, kv_heads: int, max_pages: int, page: int,
               groups: int) -> tuple[int, int]:
    """(split_tokens, splits) of a call: every token position below
    ``max_pages * page`` lies in exactly one split and ``split_tokens`` is a
    multiple of 16.  A history of at most ``ONE_SPLIT_TOKENS`` is one
    split; a longer one is cut into splits of a multiple of 64 tokens (one
    tile per warp), so that the grid holds about ``TARGET_BLOCKS`` blocks,
    at most ``MAX_SPLITS`` per (request, KV head, 8 query rows)."""
    total = max_pages * page
    if total <= ONE_SPLIT_TOKENS:
        return max(TILE, _ceil(total, TILE) * TILE), 1
    heads = max(1, b * kv_heads * _ceil(groups, COLS))
    tiles = _ceil(total, TILE)
    want = min(MAX_SPLITS, max(1, _ceil(TARGET_BLOCKS, heads)))
    per = min(_ceil(_ceil(tiles, want), WARPS) * WARPS, tiles)
    return per * TILE, _ceil(total, per * TILE)


def shared_bytes(head_dim: int, itemsize: int, stages: int,
                 splits: int) -> int:
    """Dynamic shared memory of one block: each warp's K and V tiles per
    stage (rows padded by 16 bytes), a region the warps' merge (f32 8 x E
    per warp) and the last block's merge weights (f32 8 per split) reuse,
    the small f32 words, and for f32 the query rows."""
    row = head_dim + 16 // itemsize
    region = max(WARPS * stages * 2 * TILE * row * itemsize,
                 4 * WARPS * COLS * head_dim, 4 * splits * COLS)
    region = _ceil(region, 16) * 16
    return (region + 4 * SMALL_WORDS
            + (COLS * row * itemsize if itemsize == 4 else 0))


def launch_plan(b: int, kv_heads: int, groups: int, head_dim: int,
                itemsize: int, max_pages: int, page: int) -> dict:
    """The split, the pipeline depth (one stage per tile a warp walks, at
    most ``MAX_STAGES``, as many as fit) and the shared memory of a call;
    raises ``ValueError`` when one stage does not fit a block."""
    split_tokens, splits = split_plan(b, kv_heads, max_pages, page, groups)
    stages = min(MAX_STAGES, _ceil(split_tokens // TILE, WARPS))
    while stages > 1 and shared_bytes(head_dim, itemsize, stages,
                                      splits) > MAX_SHARED:
        stages -= 1
    shared = shared_bytes(head_dim, itemsize, stages, splits)
    if shared > MAX_SHARED:
        raise ValueError(f"paged_attention: E={head_dim} at {itemsize} "
                         f"bytes an element needs {shared} B of shared "
                         f"memory, more than a block has ({MAX_SHARED})")
    return dict(split_tokens=split_tokens, splits=splits, stages=stages,
                shared=shared,
                heads=b * kv_heads * _ceil(groups, COLS))


_TICKETS: dict[torch.device, torch.Tensor] = {}


def tickets(dev: torch.device, n: int) -> torch.Tensor:
    """The kernel's int32 split counters on ``dev``, at least ``n``: cached
    per device, grown as needed, zeroed only when allocated (each call's
    last block resets its counters).  Calls on one device must run on one
    stream at a time, as every caller in the port makes them."""
    buf = _TICKETS.get(dev)
    if buf is None or buf.numel() < n:
        old = 0 if buf is None else buf.numel()
        buf = torch.zeros(max(n, 2 * old, 256), dtype=torch.int32,
                          device=dev)
        _TICKETS[dev] = buf
    return buf


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table,
                                lengths) -> torch.Tensor:
    """q (B, K, G, E), k_pages/v_pages (P, page, K, E) of one dtype (bf16
    or f32) on the card, page_table (B, MP) int32 with -1 padding, lengths
    (B,) -> (B, K, G, E) in q's dtype."""
    dev = require_cuda("paged_attention", q, k_pages, v_pages, page_table,
                       lengths)
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: need q (B, K, G, E) and pages "
                         f"(P, page, K, E), got {tuple(q.shape)} and "
                         f"{tuple(k_pages.shape)}")
    b, kh, g, e = q.shape
    npages, page = k_pages.shape[:2]
    if (k_pages.shape[2:] != (kh, e) or v_pages.shape != k_pages.shape
            or page_table.dim() != 2 or page_table.shape[0] != b
            or lengths.shape != (b,)):
        raise ValueError(
            f"paged_attention: shapes disagree: q {tuple(q.shape)}, k "
            f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}, page_table "
            f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if q.dtype not in DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"paged_attention: q, k and v must share one dtype "
                         f"of {sorted(map(str, DTYPES))}, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if e not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {e} not in {HEAD_DIMS}")
    if min(kh, g, npages, page) < 1:
        raise ValueError(f"paged_attention: empty heads or pool: q "
                         f"{tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    mp = page_table.shape[1]
    plan = launch_plan(b, kh, g, e, q.element_size(), mp, page)
    qc = q.contiguous()
    require_aligned("paged_attention", qc, k_pages, v_pages)
    pt = page_table.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    if b == 0 or mp == 0:
        return out.zero_()
    heads, splits = plan["heads"], plan["splits"]
    part_acc = part_ml = cnt = None
    if splits > 1:
        part_acc = torch.empty(heads * splits * COLS * e,
                               dtype=torch.float32, device=dev)
        part_ml = torch.empty(heads * splits * 2 * COLS, dtype=torch.float32,
                              device=dev)
        cnt = tickets(dev, heads)
    rc = library().pp_paged_attention(
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), pt.data_ptr(),
        ln.data_ptr(), out.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (part_acc, part_ml,
                                                         cnt)),
        DTYPES[q.dtype], b, kh, g, e, npages, page, mp,
        plan["split_tokens"], splits, plan["stages"], e ** -0.5,
        stream_handle(dev))
    check("paged_attention", rc)
    trace.count(COUNT)
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table,
                           lengths) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths)
    return paged_decode_attention_cuda(q, k_pages, v_pages, page_table,
                                       lengths)
