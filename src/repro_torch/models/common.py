"""Shared transformer building blocks (port of ``repro.models.common``).

Plain functions on tensors over explicit parameter dicts, with the
reference's conventions: compute dtype bf16, norm scales and rotary tables
f32, softmax and logits accumulation f32.  Dimension names: B batch, S/T
sequence (queries / keys), D model, H query heads, K KV heads, G query
heads per KV head (H = K * G), E head dim, F d_ff, V vocab.

Attention over a whole sequence is blockwise: a running softmax over
key/value blocks inside a loop over query blocks, f32 scores and f32
accumulators, as the reference's scans compute it, so a long prefill never
holds an (S, T) score matrix.  Products the reference takes with
``preferred_element_type=float32`` run on f32 copies of their bf16
operands here (exact products, f32 sums).

Initializers draw from an explicit ``torch.Generator`` and create their
tensors on ``device`` (``"meta"`` gives shapes and dtypes without memory).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

# elements drawn in f32 at once: a larger leaf is drawn slice by slice of
# its leading axis, so the f32 temporary stays one slice of it (a stacked
# Mixtral ``wi`` is 16 x 8 x 4096 x 14336)
DRAW_CHUNK = 1 << 26


def ninit(gen: torch.Generator | None, shape, scale, device, dtype=DTYPE):
    """Normal(0, scale) drawn in f32 and cast to ``dtype``."""
    shape = tuple(shape)
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if math.prod(shape) > DRAW_CHUNK and len(shape) > 1:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = ninit(gen, shape[1:], scale, device, dtype)
        return out
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def zeros(shape, device, dtype=DTYPE):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, device, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=device)


# --------------------------------------------------------------------------
# norms and rotary embeddings
# --------------------------------------------------------------------------

def rmsnorm(x, scale, eps=1e-6):
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_angles(positions, head_dim, theta, mrope_sections=None):
    """positions: (B, S) integer, or (3, B, S) for M-RoPE, whose
    ``mrope_sections`` (t, h, w) give the rotary channels that take their
    angle from the temporal, height and width position.  Returns (cos, sin):
    (B, S, head_dim/2) f32."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    if mrope_sections is None:
        ang = positions.float()[..., None] * inv_freq
    else:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        t, h, w = mrope_sections
        if t + h + w != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not sum "
                             f"to head_dim/2 = {half}")
        sec = torch.tensor([0] * t + [1] * h + [2] * w,
                           device=positions.device)
        pos_c = positions.float()[sec]                 # (half, B, S)
        ang = pos_c.movedim(0, -1) * inv_freq          # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, N, E); cos/sin: (B, S, E/2).  Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# blockwise (flash-style) attention
# --------------------------------------------------------------------------

NEG_INF = -1e30


def f32_einsum(eq, a, b):
    """``einsum`` with f32 products and sums, as the reference's
    ``preferred_element_type=float32``.  Two DTensor operands sharded only
    on indices the einsum keeps run on each rank's shards
    (``_local_einsum``)."""
    a, b = a.float(), b.float()
    local = _local_einsum(eq, a, b)
    return torch.einsum(eq, a, b) if local is None else local


def _align(a, la, b, lb):
    """``a`` and ``b`` resharded, mesh dim by mesh dim, so that each is
    replicated or plainly sharded and, where both shard, on the same
    index: a layout other than a plain shard is gathered; ``b`` is
    gathered where the two shard different indices (the FSDP all-gather
    of a weight); an operand replicated where the other shards an index
    both carry takes its own slice (a local chunk, no collective)."""
    from torch.distributed.tensor import Replicate, Shard

    def plain(p):
        return p if type(p) is Shard or isinstance(p, Replicate) \
            else Replicate()

    want_a, want_b = [], []
    for pa, pb in zip(a.placements, b.placements):
        pa, pb = plain(pa), plain(pb)
        if type(pa) is Shard and type(pb) is Shard \
                and la[pa.dim] != lb[pb.dim]:
            pb = Replicate()
        if type(pa) is Shard and isinstance(pb, Replicate) \
                and la[pa.dim] in lb:
            pb = Shard(lb.index(la[pa.dim]))
        elif type(pb) is Shard and isinstance(pa, Replicate) \
                and lb[pb.dim] in la:
            pa = Shard(la.index(lb[pb.dim]))
        want_a.append(pa)
        want_b.append(pb)
    if want_a != list(a.placements):
        a = a.redistribute(a.device_mesh, want_a)
    if want_b != list(b.placements):
        b = b.redistribute(b.device_mesh, want_b)
    return a, b


def _local_einsum(eq, a, b, local_fn=None):
    """``eq`` of two DTensors computed shard by shard, or None where that
    is not the einsum of the whole tensors.  After ``_align``, per mesh
    dim, each operand is replicated or sharded on an index that the other
    operand shards alike or lacks.  A kept index sharded so shards the
    output; a contracted index sharded alike gives each rank a partial sum,
    taken in f32 and all-reduced in f32 before the result returns to the
    operands' dtype (one rounding of an f32 sum, as a one-device product
    accumulates).  An operand replicated where the other shards an index
    it lacks gets a ``Partial`` gradient on that mesh dim (each rank holds
    its shard's share).  DTensor's own einsum and matmul take the same
    layouts, but plan them for ~0.06-0.7 s a call on a 2-D mesh and sum
    partial products in the operands' dtype; this plans nothing.
    ``local_fn`` computes the shards' product (default ``torch.einsum``
    of ``eq``).  Plain tensors return None at once."""
    if type(a) is torch.Tensor or type(b) is torch.Tensor:
        return None
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)
            and a.device_mesh == b.device_mesh):
        return None
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    a, b = _align(a, la, b, lb)
    placements, grad_a, grad_b = [], [], []
    for pa, pb in zip(a.placements, b.placements):
        ia = la[pa.dim] if type(pa) is Shard else None
        ib = lb[pb.dim] if type(pb) is Shard else None
        if ((ia is None and not isinstance(pa, Replicate))
                or (ib is None and not isinstance(pb, Replicate))):
            return None
        if ia is None and ib is None:
            placements.append(Replicate())
        elif ia == ib and ia not in out:
            placements.append(Partial())
        else:
            idx = ia or ib
            if idx not in out or (ia and ib and ia != ib) \
                    or (ia is None and idx in la) \
                    or (ib is None and idx in lb):
                return None
            placements.append(Shard(out.index(idx)))
        grad_a.append(Partial() if ia is None and ib is not None else pa)
        grad_b.append(Partial() if ib is None and ia is not None else pb)
    sizes = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    shape = torch.Size(sizes[i] for i in out)
    xa = a.to_local(grad_placements=grad_a)
    xb = b.to_local(grad_placements=grad_b)
    partial = any(isinstance(p, Partial) for p in placements)
    dtype = torch.promote_types(a.dtype, b.dtype)
    if partial:
        xa, xb = xa.float(), xb.float()
    product = (local_fn(xa, xb) if local_fn is not None
               else torch.einsum(eq, xa, xb))
    # DTensor reshapes its local tensor as a view, which a permuted
    # einsum result may not allow
    res = DTensor.from_local(product.contiguous(), a.device_mesh,
                             placements, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta")
                             .stride())
    if partial:
        res = res.redistribute(a.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in placements]).to(dtype)
    return res


def einsum(eq, *ops):
    """``torch.einsum``; on DTensors, operand by operand from the left,
    each pair shard by shard (``_local_einsum``) where their layouts
    allow.  DTensor's own einsum folds the batch letters into one axis,
    which it cannot do for letters sharded over two mesh dims."""
    from repro_torch.distributed.sharding import is_dtensor
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(eq, *ops)
    ins, out = eq.split("->")
    terms = ins.split(",")
    acc, lacc = ops[0], terms[0]
    for i in range(1, len(ops)):
        rest = "".join(terms[i + 1:]) + out
        keep = out if i == len(ops) - 1 else "".join(dict.fromkeys(
            c for c in lacc + terms[i] if c in rest))
        sub = f"{lacc},{terms[i]}->{keep}"
        local = _local_einsum(sub, acc, ops[i])
        acc = torch.einsum(sub, acc, ops[i]) if local is None else local
        lacc = keep
    return acc


def matmul(x, w):
    """``x @ w`` for x (..., K) and w (K, N); two DTensors go shard by
    shard (``_local_einsum``, each rank's ``@``) where their layouts
    allow."""
    lead = "abcdefgh"[:x.dim() - 1]
    local = _local_einsum(f"{lead}y,yz->{lead}z", x, w, torch.matmul)
    return x @ w if local is None else local


class _GradAsInput(torch.autograd.Function):
    """Identity whose backward lays the gradient out as the input was
    (a DTensor gradient that comes back ``Partial`` is reduced there)."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.layout
        return g if tuple(g.placements) == placements else \
            g.redistribute(mesh, placements)


def grad_as_input(x):
    """``x``; for a DTensor, its gradient is laid out as ``x`` at this
    point of the backward pass."""
    from repro_torch.distributed.sharding import is_dtensor
    return _GradAsInput.apply(x) if is_dtensor(x) else x


def local_apply(fn, x, dim: int):
    """``fn(x)`` for an ``fn`` that works along ``dim`` alone (a roll, a
    pad, a cumulative sum); a DTensor is first gathered on the mesh dims
    that shard ``dim`` and ``fn`` then runs on each rank's shard, as DTensor
    has no rule for some of these operations in some torch versions.  The
    result keeps the input's layout."""
    from repro_torch.distributed.sharding import is_dtensor
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    want = [Replicate() if not isinstance(p, (Shard, Replicate))
            or (isinstance(p, Shard) and p.dim == dim) else p
            for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    out = fn(x.to_local(grad_placements=want))
    shape = list(out.shape)
    for p, size in zip(want, mesh.shape):
        if isinstance(p, Shard):
            shape[p.dim] *= size
    shape = torch.Size(shape)
    return DTensor.from_local(out, mesh, want, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def gather_where(x, ref, dim: int):
    """DTensor ``x`` gathered on the mesh dims that shard ``ref``'s axis
    ``dim``; anything else as it is.  A decode step's query meets a cache
    sharded along its ring this way: the products then run where the
    ring's slices are (context parallelism) instead of gathering the
    ring."""
    from repro_torch.distributed.sharding import is_dtensor
    if not (is_dtensor(x) and is_dtensor(ref)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate() if isinstance(pr, Shard) and pr.dim == dim else px
            for px, pr in zip(x.placements, ref.placements)]
    return x if want == list(x.placements) else \
        x.redistribute(x.device_mesh, want)


def batch_only(x):
    """A DTensor (B, S, ...) gathered on every mesh dim that does not
    shard its batch axis, as Megatron's sequence parallelism gathers the
    sequence before a mixer that scans it; anything else as it is."""
    from repro_torch.distributed.sharding import is_dtensor
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in x.placements]
    return x if want == list(x.placements) else \
        x.redistribute(x.device_mesh, want)


def blockwise_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                        q_block=512, kv_block=1024):
    """q: (B, S, K, G, E); k: (B, T, K, E); v: (B, T, K, Ev).  Returns
    (B, S, K, G, Ev).

    A running softmax over key/value blocks nested in a loop over query
    blocks; scores are (B, K, G, q_block, kv_block) f32 tiles only.
    ``q_offset`` positions the queries absolutely; ``window`` keeps keys
    less than ``window`` positions behind the query.  The value head dim
    may differ from the query's (MLA)."""
    b, s, kh, g, e = q.shape
    t = k.shape[1]
    ve = v.shape[-1]
    if k.shape[-1] != e:
        raise ValueError(f"key head dim {k.shape[-1]} != query's {e}")
    q_block = min(q_block, s)
    kv_block = min(kv_block, t)
    if s % q_block or t % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) do not divide "
                         f"the lengths ({s}, {t})")
    scale = e ** -0.5
    dev = q.device
    from repro_torch.distributed.sharding import is_dtensor
    # DTensor operands: the accumulators take the first block's layout
    # (made plain, they would be whole on every rank)
    dist = is_dtensor(q)
    outs = []
    for qi in range(s // q_block):
        qblk = q[:, qi * q_block:(qi + 1) * q_block]
        qpos = torch.arange(q_block, device=dev) + q_offset + qi * q_block
        m = norm = acc = None
        if not dist:
            m = torch.full((b, kh, g, q_block), NEG_INF, dtype=torch.float32,
                           device=dev)
            norm = torch.zeros((b, kh, g, q_block), dtype=torch.float32,
                               device=dev)
            acc = torch.zeros((b, kh, g, q_block, ve), dtype=torch.float32,
                              device=dev)
        for ki in range(t // kv_block):
            kblk = k[:, ki * kv_block:(ki + 1) * kv_block]
            vblk = v[:, ki * kv_block:(ki + 1) * kv_block]
            kvpos = torch.arange(kv_block, device=dev) + ki * kv_block
            srel = f32_einsum("bqkge,btke->bkgqt", qblk, kblk) * scale
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kvpos[None, :]
            if window is not None:
                mask &= (qpos[:, None] - kvpos[None, :]) < window
            srel = torch.where(mask, srel, NEG_INF)
            top = srel.amax(dim=-1)
            if m is None:
                m = torch.full_like(top, NEG_INF)
                norm = torch.zeros_like(top)
            m_new = torch.maximum(m, top)
            p = torch.exp(srel - m_new[..., None])
            alpha = torch.exp(m - m_new)
            norm = norm * alpha + p.sum(dim=-1)
            pv = f32_einsum("bkgqt,btke->bkgqe", p.to(vblk.dtype), vblk)
            if acc is None:
                acc = torch.zeros_like(pv)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(norm[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, lengths, *, window=None):
    """Single-token attention over a cache.  q: (B, K, G, E); caches:
    (B, T, K, E); lengths: (B,) tokens valid (the new token's k/v already
    written at lengths - 1)."""
    b, t, kh, e = k_cache.shape
    scale = e ** -0.5
    s = f32_einsum("bkge,btke->bkgt", q, k_cache) * scale
    pos = torch.arange(t, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window is not None:
        mask &= pos >= (lengths[:, None] - window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    norm = p.sum(dim=-1, keepdim=True)
    out = f32_einsum("bkgt,btke->bkge", (p / norm).to(v_cache.dtype),
                      v_cache)
    return out.to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------

def attn_init(gen, cfg: ModelConfig, device, lead: tuple[int, ...] = ()):
    """Attention parameters; ``lead`` prepends stacked axes (the layers)."""
    d, h, k, e = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ninit(gen, lead + (d, h, e), d ** -0.5, device),
        "wk": ninit(gen, lead + (d, k, e), d ** -0.5, device),
        "wv": ninit(gen, lead + (d, k, e), d ** -0.5, device),
        "wo": ninit(gen, lead + (h, e, d), (h * e) ** -0.5, device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros(lead + (h, e), device)
        p["bk"] = zeros(lead + (k, e), device)
        p["bv"] = zeros(lead + (k, e), device)
    if cfg.qk_norm:
        p["q_norm"] = ones(lead + (e,), device)
        p["k_norm"] = ones(lead + (e,), device)
    return p


def proj(x, w):
    """x (B, S, D) against w (D, ...) -> (B, S, ...)."""
    return matmul(x, w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])


def attn_qkv_heads(p, x, cfg: ModelConfig, cos, sin):
    """Project + position-encode.
    x: (B,S,D) -> q (B,S,H,E), k/v (B,S,K,E)."""
    q = proj(x, p["wq"])
    kx = proj(x, p["wk"])
    vx = proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        kx = kx + p["bk"]
        vx = vx + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        kx = rmsnorm(kx, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, cos, sin), apply_rope(kx, cos, sin), vx


def split_heads(q, k: int):
    """(B, S, H, E) -> (B, S, K, H/K, E).  DTensor splits a sharded axis
    only where its first factor divides the shards, so a DTensor whose
    head axis is sharded over a mesh dim that does not divide K is first
    gathered on that mesh dim (a decode step's one-token queries)."""
    b, s, h, e = q.shape
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(q):
        from torch.distributed.tensor import Replicate, Shard
        want = [Replicate() if (isinstance(p, Shard) and p.dim == 2
                                and k % size) else p
                for p, size in zip(q.placements, q.device_mesh.shape)]
        if want != list(q.placements):
            q = q.redistribute(q.device_mesh, want)
    return q.reshape(b, s, k, h // k, e)


def attn_qkv(p, x, cfg: ModelConfig, cos, sin):
    """Project + position-encode.
    x: (B,S,D) -> q (B,S,K,G,E), k/v (B,S,K,E)."""
    q, kx, vx = attn_qkv_heads(p, x, cfg, cos, sin)
    return split_heads(q, cfg.num_kv_heads), kx, vx


def attn_out_heads(p, o):
    """o: (B, S, H, E) -> (B, S, D).  DTensors contract (H, E) against
    ``wo`` shard by shard: flattening a ``wo`` sharded on two mesh dims
    gives a strided layout whose shards DTensor sizes by reading an index
    tensor, a host read that fake tensors refuse."""
    local = _local_einsum("bshe,hed->bsd", o, p["wo"])
    if local is not None:
        return local
    b, s, h, e = o.shape
    return matmul(o.reshape(b, s, h * e), p["wo"].reshape(h * e, -1))


def attn_out(p, o):
    """o: (B, S, K, G, E) -> (B, S, D)."""
    b, s, k, g, e = o.shape
    return attn_out_heads(p, o.reshape(b, s, k * g, e))


# --------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, device, lead: tuple[int, ...] = ()):
    return {
        "wi": ninit(gen, lead + (d_model, d_ff), d_model ** -0.5, device),
        "wg": ninit(gen, lead + (d_model, d_ff), d_model ** -0.5, device),
        "wo": ninit(gen, lead + (d_ff, d_model), d_ff ** -0.5, device),
    }


def mlp_apply(p, x, act: str):
    gate = matmul(x, p["wg"])
    up = matmul(x, p["wi"])
    # jax.nn.gelu defaults to the tanh approximation
    a = F.gelu(gate, approximate="tanh") if act == "gelu" else F.silu(gate)
    return matmul(a * up, p["wo"])


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, device):
    v = cfg.vocab_padded()
    p = {"table": ninit(gen, (v, cfg.d_model), cfg.d_model ** -0.5, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = ninit(gen, (cfg.d_model, v), cfg.d_model ** -0.5,
                             device)
    return p


def shard_offset(x, dim: int) -> int:
    """This rank's first index along ``dim`` of a DTensor ``x``: the axis
    is split over the mesh dims that shard it in mesh order, major to
    minor (shards are even, ``sharding.distribute``)."""
    from torch.distributed.tensor import Shard
    offset, span = 0, x.shape[dim]
    for p, size, c in zip(x.placements, x.device_mesh.shape,
                          x.device_mesh.get_coordinate()):
        if isinstance(p, Shard) and p.dim == dim:
            span //= size
            offset += c * span
    return offset


def _embed_rows(table, ids):
    """``table[ids]`` of DTensors shard by shard (Megatron's
    vocab-parallel embedding): each rank looks its own ids up in its own
    rows of the table, zero where another rank holds the row, and the
    rows are summed over the mesh dims that shard the vocabulary; the ids
    keep their layout (DTensor's own lookup refuses ids sharded over two
    mesh dims in some torch versions).  None where the table is laid out
    otherwise than vocab-sharded or replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if any(not (isinstance(p, Replicate) or p == Shard(0))
           for p in table.placements):
        return None
    mesh = table.device_mesh
    want = [Replicate() if isinstance(pt, Shard) or not isinstance(
        pi, (Replicate, Shard)) else pi
        for pt, pi in zip(table.placements, ids.placements)]
    if want != list(ids.placements):
        ids = ids.redistribute(mesh, want)
    out_p, grad_p = [], []
    for pt, pi in zip(table.placements, ids.placements):
        out_p.append(Partial() if isinstance(pt, Shard) else pi)
        grad_p.append(Partial() if isinstance(pi, Shard) else pt)
    local = table.to_local(grad_placements=grad_p)
    slot = ids.to_local() - shard_offset(table, 0)
    mine = (slot >= 0) & (slot < local.shape[0])
    rows = local[torch.clamp(slot, 0, local.shape[0] - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    shape = torch.Size(tuple(ids.shape) + (table.shape[1],))
    out = DTensor.from_local(rows, mesh, out_p, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta")
                             .stride())
    if any(isinstance(p, Partial) for p in out_p):
        out = out.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                      else p for p in out_p])
    return out


def embed_apply(p, tokens, cfg: ModelConfig, one_hot_matmul: bool = False):
    """Token embeddings; ``one_hot_matmul`` takes them as a one-hot product
    with the table (the reference's vocab-parallel form), the same rows."""
    from repro_torch.distributed.sharding import is_dtensor
    table = p["table"]
    if one_hot_matmul:
        oh = F.one_hot(tokens.long(), table.shape[0]).to(table.dtype)
        x = matmul(oh, table)
    else:
        x = None
        if is_dtensor(table) and is_dtensor(tokens):
            x = _embed_rows(table, tokens.long())
        if x is None:
            x = table[tokens.long()]
    if cfg.embed_scale:
        # gemma scaling; sqrt(d_model) is rounded to the table's dtype first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed_apply(p, x, cfg: ModelConfig, shard=None):
    """Logits; ``shard`` is the hook through which a multi-device layer
    keeps them vocab-sharded."""
    if cfg.tie_embeddings:
        logits = matmul(x, p["table"].T)
    else:
        logits = matmul(x, p["unembed"])
    return logits if shard is None else shard(logits, "logits")
