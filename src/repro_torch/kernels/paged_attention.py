"""paged_decode_attention on the card: CUDA kernel ``csrc/paged_attention.cu``.

Replaces ``repro/kernels/paged_attention/kernel.py::
paged_decode_attention_kernel`` (the TPU kernel runs a (B, MAX_PAGES) grid
in order and DMAs page ``pt[b, p]`` per step, -1 pages included and
masked; here one block per (request, KV head) walks the request's tokens
256 at a time, one per thread, and never reads a -1 page).  Bound by
bytes: the live K and V rows.

``paged_decode_attention_cuda`` launches the kernel and raises on CPU
tensors and on shapes it does not take (``ValueError``);
``paged_decode_attention`` is the ``auto`` entry, which takes the plain
version (``paged_decode_attention_plain``) only because its tensors lie on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.backend.ref import \
    paged_decode_attention as paged_decode_attention_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_aligned, require_cuda,
                                       stream_handle)

COUNT = launch_counter("paged_attention")

HEAD_DIMS = (16, 32, 64, 128, 256)  # 16: the reduced configs
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_SHARED = 227 * 1024  # bytes of shared memory a block may use

__all__ = ["COUNT", "paged_decode_attention", "paged_decode_attention_cuda",
           "paged_decode_attention_plain", "shared_bytes"]


CHUNK = 256  # tokens per pass of a block (the kernel's kChunk)


def shared_bytes(groups: int, head_dim: int) -> int:
    """Shared memory of one block: f32 q and acc (G, E), scores (G, CHUNK)
    and the running m, l and alpha (G), padded to 8 bytes; int64 row
    offsets (CHUNK)."""
    return (4 * (2 * groups * head_dim + groups * CHUNK + 3 * groups
                 + groups % 2) + 8 * CHUNK)


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
    if shared_bytes(g, e) > MAX_SHARED:
        raise ValueError(f"paged_attention: G={g}, E={e} need "
                         f"{shared_bytes(g, e)} B of shared memory, more "
                         f"than a block has ({MAX_SHARED})")
    require_aligned("paged_attention", k_pages, v_pages)
    qc = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    ln = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    if b == 0 or page_table.shape[1] == 0:
        return out.zero_()
    rc = library().pp_paged_attention(
        qc.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), pt.data_ptr(),
        ln.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, kh, g, e, npages,
        page, pt.shape[1], e ** -0.5, stream_handle(dev))
    check("paged_attention", rc)
    COUNT.launches += 1
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table,
                           lengths) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                            lengths)
    return paged_decode_attention_cuda(q, k_pages, v_pages, page_table,
                                       lengths)
