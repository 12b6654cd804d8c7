"""The causal LM over every architecture family of the pool (port of
``repro.models.lm``).

One code path per *block kind*; an architecture is a list of homogeneous
segments whose per-layer parameters are stacked on a leading layer axis,
as the reference's ``jax.vmap(init_one)`` gives, and run as a Python loop
over that axis (the reference's ``lax.scan``):

  dense / vlm        [("blocks", ("dense",), L)]
  moe (mixtral)      [("blocks", ("moe",), L)]           + SWA window
  moe+mla (deepseek) [("dense0", ("mla_dense",), 1), ("blocks", ("mla_moe",), L-1)]
  hybrid (griffin)   [("sb", ("rec","rec","attn_local"), L//3), ("tail", ("rec","rec"), 1)]
  ssm (mamba2)       [("blocks", ("ssd",), L)]
  audio (enc-dec)    encoder [("enc", ("enc",), Le)] + decoder [("dec", ("dec",), L)]

Phases: ``train`` (full sequence, loss), ``prefill`` (full sequence ->
cache), ``decode`` (one token against the cache).  Caches keep the
reference's tree: per segment, ``sub<i>`` leaves stacked on the layer
axis, so ``convert.lm_params`` carries them across unchanged.  ``shard``
is the hook through which a multi-device layer constrains layouts
(``distributed.sharding.Rules.act_shard``; identity by default).  The
reference's ``unroll``, ``decode_carry_cache`` and
``assume_uniform_decode`` only steer XLA's lowering and give the same
math, so they have no counterpart.  ``vocab_parallel`` takes the token
embeddings as a one-hot product with the table, keeps the logits
vocab-sharded through the ``shard`` hook and picks each label's logit
shard-locally (Megatron's vocab-parallel cross entropy).

Parameters may be DTensors (``distributed.sharding.distribute``).  The
model then makes plain tensors that meet them: the RoPE tables
(``_angles`` of the ``arange`` positions of ``_positions``, ``_encode``
and the decode positions), the masks, ``arange`` offsets and
running-softmax accumulators of attention (``common.blockwise_attention``,
``common.decode_attention``) and the ``arange`` of the
ring write (``_ring_write``), the ``aux`` zeros of ``_run_segment`` and
the vocabulary ids of the vocab-parallel gold pick.  ``forward_train``,
``loss``, ``prefill`` and ``decode_step`` therefore run under
``implicit_replication`` (``mesh_scope``) when the parameters are
DTensors, which treats each such plain tensor as replicated;
``train_step`` keeps that scope over the backward pass too.  The
products (``common.matmul``, ``common.f32_einsum``) run shard by shard,
with explicit redistributes only where a layout needs one
(``common._align``, the f32 reduction of partial sums).

``remat_policy`` (``minimal | dots | off``) rematerializes each layer of
the train-phase forward in the backward pass, as the reference's
``jax.checkpoint`` of its scan body: ``minimal`` keeps only each layer's
inputs (``torch.utils.checkpoint``), ``dots`` also the outputs of its
matrix products (selective checkpointing, the reference's
``checkpoint_dots``), ``off`` keeps every activation.  The three give the
same values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models import common as cm
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg_mod
from repro_torch.models import ssd as ssd_mod

Shard = Callable[[torch.Tensor, str], torch.Tensor]


def _identity(x, name):
    return x


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    kinds: tuple[str, ...]
    count: int


def segments_for(cfg: ModelConfig) -> list[Segment]:
    nl = cfg.num_layers
    if cfg.family == "ssm":
        return [Segment("blocks", ("ssd",), nl)]
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        full, rem = divmod(nl, len(pat))
        segs = [Segment("sb", tuple(k if k != "attn" else "attn_local"
                                    for k in pat), full)]
        if rem:
            segs.append(Segment("tail", tuple(
                k if k != "attn" else "attn_local" for k in pat[:rem]), 1))
        return segs
    if cfg.family == "audio":
        return [Segment("dec", ("dec",), nl)]
    if cfg.moe is not None:
        if cfg.mla is not None:
            fd = cfg.moe.first_dense_layers
            segs = []
            if fd:
                segs.append(Segment("dense0", ("mla_dense",), fd))
            segs.append(Segment("blocks", ("mla_moe",), nl - fd))
            return segs
        return [Segment("blocks", ("moe",), nl)]
    return [Segment("blocks", ("dense",), nl)]


# --------------------------------------------------------------------------
# block init / apply, by kind
# --------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, kind: str, count: int, device):
    """One block's parameters for ``count`` stacked layers."""
    d, lead = cfg.d_model, (count,)
    p: dict[str, Any] = {"ln1": cm.ones(lead + (d,), device)}
    if kind in ("dense", "moe", "attn_local", "enc", "dec"):
        p["attn"] = cm.attn_init(gen, cfg, device, lead)
    if kind in ("mla_dense", "mla_moe"):
        p["attn"] = mla_mod.mla_init(gen, cfg, device, lead)
    if kind == "rec":
        p["rec"] = rg_mod.rglru_init(gen, cfg, device, lead)
    if kind == "ssd":
        p["ssd"] = ssd_mod.ssd_init(gen, cfg, device, lead)
        return p  # the mamba block is the whole layer
    if kind == "dec":
        p["ln_cross"] = cm.ones(lead + (d,), device)
        p["cross"] = cm.attn_init(gen, cfg, device, lead)
    p["ln2"] = cm.ones(lead + (d,), device)
    if kind in ("moe", "mla_moe"):
        p["ffn"] = moe_mod.moe_init(gen, cfg, device, lead)
    else:
        p["ffn"] = cm.mlp_init(gen, d, cfg.d_ff, device, lead)
    return p


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    cos: torch.Tensor                       # (B, S, E/2)
    sin: torch.Tensor
    phase: str                              # train | prefill | decode
    shard: Shard = _identity
    lengths: Optional[torch.Tensor] = None  # (B,) decode: tokens incl. new
    cache_len: int = 0
    enc_out: Optional[torch.Tensor] = None  # audio: encoder output (B,Se,D)
    attn_blocks: Optional[tuple] = None     # (q_block, kv_block) override


def _prefill_cache_layout(arr, cache_len: int):
    """Lay a full-sequence (B, S, ...) tensor into a (B, cache_len, ...)
    ring so that token t lands at slot t % cache_len (decode's ring write);
    cache_len >= S pads with zeros."""
    s = arr.shape[1]
    if cache_len >= s:
        pad = [0, 0] * (arr.dim() - 2) + [0, cache_len - s]
        return cm.local_apply(lambda a: F.pad(a, pad), arr, 1)
    return cm.local_apply(
        lambda a: torch.roll(a, (s - cache_len) % cache_len, dims=1),
        arr[:, -cache_len:], 1)


def _ring_write(buf, new, lengths, shard: Shard):
    """A new buffer with the new token's row at slot (lengths-1) % ring."""
    idx = (lengths - 1) % buf.shape[1]
    if is_dtensor(buf):
        return shard(_ring_write_local(buf, new, idx), "cache_kv")
    out = buf.index_put((torch.arange(new.shape[0], device=buf.device), idx),
                        new[:, 0].to(buf.dtype))
    return shard(out, "cache_kv")


def _ring_write_local(buf, new, idx):
    """``_ring_write`` of a DTensor (B, T, ...) buffer in its own layout:
    ``new`` and ``idx`` are laid out as ``buf`` on every axis but the
    ring's (replicated there, so each rank holding a slice of the ring
    sees every row), and each rank writes the rows whose slot falls in its
    slice.  (DTensor's own ``index_put`` gathers the whole ring first.)"""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    want = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
            for p in buf.placements]
    new = new.redistribute(mesh, want) if is_dtensor(new) else \
        DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                           run_check=False).redistribute(mesh, want)
    idx_want = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in buf.placements]
    idx = idx.redistribute(mesh, idx_want) if is_dtensor(idx) else \
        DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                           run_check=False).redistribute(mesh, idx_want)
    local = buf.to_local()
    slot = idx.to_local() - cm.shard_offset(buf, 1)
    mine = (slot >= 0) & (slot < local.shape[1])
    slot = torch.clamp(slot, 0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    row = torch.where(mine.view(-1, *[1] * (local.dim() - 2)),
                      new.to_local()[:, 0].to(local.dtype),
                      local[rows, slot])
    out = local.index_put((rows, slot), row)
    return DTensor.from_local(out, mesh, buf.placements, run_check=False,
                              shape=buf.shape, stride=buf.stride())


def _attn_kw(ctx: Ctx) -> dict:
    if not ctx.attn_blocks:
        return {}
    return {"q_block": ctx.attn_blocks[0], "kv_block": ctx.attn_blocks[1]}


def _attn_sublayer(p, x, ctx: Ctx, cache, *, window, causal=True):
    cfg = ctx.cfg
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q, k, v = cm.attn_qkv_heads(p["attn"], h, cfg, ctx.cos, ctx.sin)
    if ctx.phase == "decode":
        cache = {"k": _ring_write(cache["k"], k, ctx.lengths, ctx.shard),
                 "v": _ring_write(cache["v"], v, ctx.lengths, ctx.shard)}
        cl = cache["k"].shape[1]
        valid = torch.clamp(ctx.lengths, max=cl)
        win = None if (window is None or window >= cl) else window
        q = cm.gather_where(cm.split_heads(q, cfg.num_kv_heads),
                            cache["k"], 1)
        o = cm.decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                                window=win)[:, None]
        return x + cm.attn_out(p["attn"], o), cache
    # KV heads expanded to the query heads, so the head axis is one
    # contiguous (model-shardable) axis, never split into (K, G)
    b_, s_, h_, e_ = q.shape
    g_ = h_ // cfg.num_kv_heads
    k = ctx.shard(k, "kv_compact")
    v = ctx.shard(v, "kv_compact")
    qf = ctx.shard(q.reshape(b_, s_, h_, 1, e_), "q_heads")
    kf = ctx.shard(k.repeat_interleave(g_, dim=2), "kv_heads")
    vf = ctx.shard(v.repeat_interleave(g_, dim=2), "kv_heads")
    o = cm.blockwise_attention(qf, kf, vf, causal=causal, window=window,
                               **_attn_kw(ctx))
    if ctx.phase == "prefill":
        cl = ctx.cache_len if window is None else min(ctx.cache_len, window)
        cache = {"k": _prefill_cache_layout(k, cl),
                 "v": _prefill_cache_layout(v, cl)}
    return x + cm.attn_out_heads(p["attn"], o.reshape(b_, s_, h_, e_)), cache


def _cross_sublayer(p, x, ctx: Ctx, cache):
    """Encoder-decoder cross attention; keys and values come from the
    encoder output (cached at prefill), with no rotary embedding."""
    cfg = ctx.cfg
    h = cm.rmsnorm(x, p["ln_cross"], cfg.norm_eps)
    if ctx.phase == "decode":
        ck, cv = cache["ck"], cache["cv"]
    else:
        ck = cm.proj(ctx.enc_out, p["cross"]["wk"])
        cv = cm.proj(ctx.enc_out, p["cross"]["wv"])
        if ctx.phase == "prefill":
            cache = {"ck": ck, "cv": cv}
    q = cm.split_heads(cm.proj(h, p["cross"]["wq"]), cfg.num_kv_heads)
    b = q.shape[0]
    if ctx.phase == "decode":
        lengths = torch.full((b,), ck.shape[1], dtype=torch.int32,
                             device=x.device)
        o = cm.decode_attention(cm.gather_where(q, ck, 1)[:, 0], ck, cv,
                                lengths)[:, None]
    else:
        o = cm.blockwise_attention(q, ck, cv, causal=False, **_attn_kw(ctx))
    return x + cm.attn_out(p["cross"], o), cache


def _ffn_sublayer(p, x, ctx: Ctx):
    cfg = ctx.cfg
    h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None and "router" in p["ffn"]:
        out, aux = moe_mod.moe_apply(p["ffn"], h, cfg, cfg.act)
        return x + out, aux
    return x + cm.mlp_apply(p["ffn"], h, cfg.act), 0.0


def _mla_sublayer(p, x, ctx: Ctx, cache):
    cfg = ctx.cfg
    h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
    if ctx.phase == "decode":
        c_kv_new, k_rope_new = mla_mod.mla_latent(p["attn"], h, cfg,
                                                  ctx.cos, ctx.sin)
        cache = {
            "ckv": _ring_write(cache["ckv"], c_kv_new, ctx.lengths,
                               ctx.shard),
            "krope": _ring_write(cache["krope"], k_rope_new[:, :, 0],
                                 ctx.lengths, ctx.shard),
        }
        valid = torch.clamp(ctx.lengths, max=cache["ckv"].shape[1])
        o = mla_mod.mla_decode(p["attn"], h, cfg, ctx.cos, ctx.sin,
                               (cache["ckv"], cache["krope"]), valid)
        return x + o, cache
    o, (c_kv, k_rope) = mla_mod.mla_attention(
        p["attn"], h, cfg, ctx.cos, ctx.sin, shard=ctx.shard,
        **_attn_kw(ctx))
    if ctx.phase == "prefill":
        cache = {"ckv": _prefill_cache_layout(c_kv, ctx.cache_len),
                 "krope": _prefill_cache_layout(k_rope, ctx.cache_len)}
    return x + o, cache


def _state_sublayer(kind, p, x, ctx: Ctx, cache):
    key = "rec" if kind == "rec" else "ssd"
    if ctx.phase == "decode":
        step = rg_mod.rglru_step if kind == "rec" else ssd_mod.ssd_step
        o, (h, conv) = step(p[key], x, ctx.cfg, (cache["h"], cache["conv"]))
        return o, {"h": h, "conv": conv}
    seq = rg_mod.rglru_seq if kind == "rec" else ssd_mod.ssd_seq
    o, (h, conv) = seq(p[key], x, ctx.cfg)
    return o, ({"h": h, "conv": conv} if ctx.phase == "prefill" else None)


def block_apply(kind: str, p, x, ctx: Ctx, cache):
    """Apply one block.  Returns (x, cache, aux)."""
    cfg = ctx.cfg
    aux = 0.0
    if kind in ("dense", "moe", "enc"):
        x, cache = _attn_sublayer(p, x, ctx, cache, window=cfg.window,
                                  causal=(kind != "enc"))
        x, aux = _ffn_sublayer(p, x, ctx)
    elif kind == "attn_local":
        x, cache = _attn_sublayer(p, x, ctx, cache,
                                  window=cfg.hybrid.local_window)
        x, aux = _ffn_sublayer(p, x, ctx)
    elif kind in ("mla_dense", "mla_moe"):
        x, cache = _mla_sublayer(p, x, ctx, cache)
        x, aux = _ffn_sublayer(p, x, ctx)
    elif kind == "dec":
        x, self_cache = _attn_sublayer(
            p, x, ctx, None if cache is None else cache["self"], window=None)
        x, cross_cache = _cross_sublayer(
            p, x, ctx, None if cache is None else cache["cross"])
        x, aux = _ffn_sublayer(p, x, ctx)
        cache = None if self_cache is None and cross_cache is None else \
            {"self": self_cache, "cross": cross_cache}
    elif kind in ("rec", "ssd"):
        o, cache = _state_sublayer(kind, p, x, ctx, cache)
        x = x + o
        if kind == "rec":  # griffin rec blocks also carry an MLP residual
            x, aux = _ffn_sublayer(p, x, ctx)
    else:
        raise ValueError(kind)
    return ctx.shard(x, "act"), cache, aux


def _unbind(stacked: dict) -> dict:
    """Each stacked (L, ...) leaf as the sequence of its layers: views, one
    ``unbind`` a leaf, whose backward stacks the layers' gradients once
    (indexing each layer out of the stack would add a full-size gradient
    per layer)."""
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in stacked.items()}


def _layer(layers: dict, li: int) -> dict:
    """Layer ``li`` of ``_unbind``'s result."""
    return {k: _layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in layers.items()}


def _layer_apply(kinds, p_layer, x, aux, ctx: Ctx, c_layer=None):
    """One layer of a segment: its blocks in order.  Returns (x, aux plus
    the layer's, the layer's cache or None)."""
    new_c = {}
    for i, kind in enumerate(kinds):
        ci = None if c_layer is None else c_layer[f"sub{i}"]
        x, ci, a = block_apply(kind, p_layer[f"sub{i}"], x, ctx, ci)
        new_c[f"sub{i}"] = ci
        aux = aux + a
    return x, aux, (None if all(v is None for v in new_c.values())
                    else new_c)


def _rows_like(labels, logits):
    """DTensor ``labels`` (B, S) laid out as ``logits``' (B, S) axes (a
    local slice of a replicated axis, no collective), so the loss's
    elementwise work runs on ``logits``' shards rather than gathering
    them; anything else as it is."""
    if not (is_dtensor(labels) and is_dtensor(logits)):
        return labels
    from torch.distributed.tensor import Replicate, Shard
    want = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in logits.placements]
    return labels.redistribute(labels.device_mesh, want)


# ``dots``: the matrix products' outputs are saved, the rest recomputed
_SAVE_DOTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
     torch.ops.aten.addmm.default])
REMAT_POLICIES = ("minimal", "dots", "off")


def _stack(trees: list) -> dict:
    """Per-layer dicts of tensors stacked on a new leading layer axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees])
            for k in trees[0]}


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def mesh_scope(params):
    """``implicit_replication`` when ``params`` holds DTensors (plain
    tensors the model makes count as replicated), else nothing.  Entered
    only where it is not on already: leaving ``implicit_replication``
    turns it off, also inside an outer one.  Autograd's worker threads
    inherit it, so a backward called in the scope runs in it."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.training.tree import leaves
    if not is_dtensor(leaves(params)[0]):
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()
    return implicit_replication()


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig
    remat_policy: str = "minimal"   # minimal | dots | off
    attn_blocks: Optional[tuple] = None  # (q_block, kv_block) override
    vocab_parallel: bool = False    # one-hot embed + vocab-sharded logits

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} is not "
                             f"one of {REMAT_POLICIES}")

    def _ctx(self, **kw) -> Ctx:
        return Ctx(cfg=self.cfg, attn_blocks=self.attn_blocks, **kw)

    # -- params ------------------------------------------------------------
    def init_params(self, generator: torch.Generator | None = None,
                    device=None) -> dict:
        """Random parameters drawn from ``generator`` on its device (or on
        ``device``; ``"meta"`` gives shapes and dtypes only).  Keys, shapes
        and dtypes are the reference's: ``embed.table`` (+ ``unembed``
        when untied), ``final_norm``, per segment ``sub<i>`` blocks with a
        leading layer axis, and ``enc`` / ``enc_norm`` for an encoder."""
        cfg = self.cfg
        if device is None:
            device = generator.device
        device = torch.device(device)
        if device.type == "meta":
            generator = None
        params: dict[str, Any] = {
            "embed": cm.embed_init(generator, cfg, device),
            "final_norm": cm.ones((cfg.d_model,), device),
        }
        for seg in segments_for(cfg):
            params[seg.name] = {
                f"sub{i}": _block_init(generator, cfg, kind, seg.count,
                                       device)
                for i, kind in enumerate(seg.kinds)}
        if cfg.enc_layers:
            params["enc"] = {"sub0": _block_init(generator, cfg, "enc",
                                                 cfg.enc_layers, device)}
            params["enc_norm"] = cm.ones((cfg.d_model,), device)
        return params

    # -- the layer loop ------------------------------------------------------
    def _run_segment(self, seg: Segment, seg_params, x, ctx: Ctx,
                     cache=None):
        """Run a segment's layers in order.  Returns (x, new_cache stacked
        on the layer axis or None, aux summed over the layers)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        p_layers = _unbind(seg_params)
        c_layers = None if cache is None else _unbind(cache)
        remat = (ctx.phase == "train" and self.remat_policy != "off"
                 and torch.is_grad_enabled())
        kw = {"context_fn": _SAVE_DOTS} if self.remat_policy == "dots" else {}

        def body(x, aux, p_layer):
            return _layer_apply(seg.kinds, p_layer, x, aux, ctx)[:2]

        caches = []
        for li in range(seg.count):
            p_layer = _layer(p_layers, li)
            if remat:
                x, aux = checkpoint(body, x, aux, p_layer,
                                    use_reentrant=False, **kw)
                caches.append(None)
                continue
            x, aux, new_c = _layer_apply(
                seg.kinds, p_layer, x, aux, ctx,
                None if c_layers is None else _layer(c_layers, li))
            caches.append(new_c)
        return x, (None if caches[0] is None else _stack(caches)), aux

    # -- positions / rope ----------------------------------------------------
    def _angles(self, positions):
        cfg = self.cfg
        e = cfg.mla.rope_head_dim if cfg.mla is not None else cfg.head_dim
        return cm.rope_angles(positions, e, cfg.rope_theta,
                              cfg.mrope_sections)

    def _decode_positions(self, positions):
        # positions: (B,) index of the new token
        if self.cfg.mrope_sections is not None:
            return positions[None, :, None].expand(3, positions.shape[0], 1)
        return positions[:, None]

    def _positions(self, batch, b: int, s: int, device):
        positions = batch.get("positions")
        if positions is not None:
            return positions
        pos2d = torch.arange(s, device=device)[None].expand(b, s)
        if self.cfg.mrope_sections is not None:
            return pos2d[None].expand(3, b, s)
        return pos2d

    def _embed(self, params, batch, shard: Shard, one_hot: bool = False):
        """Token embeddings with the vision stub's rows in front (vlm), and
        the encoder output (audio)."""
        cfg = self.cfg
        x = cm.embed_apply(params["embed"], batch["tokens"], cfg,
                           one_hot_matmul=one_hot)
        if cfg.family == "vlm" and "vision_embeds" in batch:
            ve = batch["vision_embeds"].to(x.dtype)    # (B, NV, D) stub
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
        x = shard(x, "act")
        enc_out = None
        if cfg.enc_layers:
            enc_out = self._encode(params, batch["enc_frames"].to(x.dtype),
                                   shard)
        return x, enc_out

    # -- encoder (audio) -----------------------------------------------------
    def _encode(self, params, frames, shard: Shard):
        cfg = self.cfg
        b, s, _ = frames.shape
        cos, sin = self._angles(
            torch.arange(s, device=frames.device)[None].expand(b, s))
        ctx = self._ctx(cos=cos, sin=sin, phase="train", shard=shard)
        seg = Segment("enc", ("enc",), cfg.enc_layers)
        x, _, _ = self._run_segment(seg, params["enc"], frames, ctx)
        return cm.rmsnorm(x, params["enc_norm"], cfg.norm_eps)

    # -- train forward -------------------------------------------------------
    def forward_train(self, params, batch, shard: Shard = _identity):
        """batch: tokens (B,S) int, labels (B,S) int (-1 = pad), optional
        positions, vision_embeds, enc_frames.  Returns (logits (B,S,V),
        aux summed over the MoE layers)."""
        cfg = self.cfg
        with mesh_scope(params):
            b, s = batch["tokens"].shape
            cos, sin = self._angles(self._positions(batch, b, s,
                                                    batch["tokens"].device))
            x, enc_out = self._embed(params, batch, shard,
                                     one_hot=self.vocab_parallel)
            ctx = self._ctx(cos=cos, sin=sin, phase="train", shard=shard,
                            enc_out=enc_out)
            aux_total = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
            for seg in segments_for(cfg):
                x, _, aux = self._run_segment(seg, params[seg.name], x, ctx)
                aux_total = aux_total + aux
            x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
            return cm.unembed_apply(
                params["embed"], x, cfg,
                shard=shard if self.vocab_parallel else None), aux_total

    def loss(self, params, batch, shard: Shard = _identity,
             aux_weight: float = 0.01):
        """Mean next-token cross entropy over labels >= 0, plus
        ``aux_weight`` times the MoE balance loss.  Returns (loss, {"ce",
        "aux"})."""
        with mesh_scope(params):
            logits, aux = self.forward_train(params, batch, shard)
            labels = _rows_like(batch["labels"], logits)
            mask = labels >= 0
            lab = torch.clamp(labels, min=0).long()
            logits = logits.float()
            # (B, S, 1) throughout: on vocab-sharded DTensor logits the
            # gather gives a masked partial that reduces in the
            # subtraction, over the shape it was made with
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            if self.vocab_parallel or is_dtensor(logits):
                # shard-local gold pick: reduces over the vocab-sharded
                # axis instead of gathering logits (Megatron
                # vocab-parallel CE); on any DTensor logits, since the
                # gather's backward makes a zero gradient of the whole
                # logits on every rank
                vid = torch.arange(logits.shape[-1],
                                   device=logits.device)[None, None, :]
                gold = torch.sum(torch.where(vid == lab[..., None], logits,
                                             0.0), -1, keepdim=True)
            else:
                gold = torch.gather(logits, -1, lab[..., None])
            nll = torch.where(mask[..., None], lse - gold, 0.0)
            ce = nll.sum() / torch.clamp(mask.sum(), min=1)
            return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    # -- cache construction ---------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, enc_len: int = 0,
                   device=DEFAULT_DEVICE) -> dict:
        """A zero cache for ``decode_step``: per segment, ``sub<i>`` leaves
        stacked on the layer axis; ``device="meta"`` gives shapes and
        dtypes only (the reference's ``cache_struct``)."""
        cfg = self.cfg
        dev = resolve_device(device)

        def z(shape, dtype=cm.DTYPE):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def leaf(kind, n):
            k, e = cfg.num_kv_heads, cfg.head_dim
            if kind in ("dense", "moe", "enc", "attn_local"):
                cl = cache_len
                if kind == "attn_local":
                    cl = min(cache_len, cfg.hybrid.local_window)
                if kind == "moe" and cfg.window:
                    cl = min(cache_len, max(cfg.window, 1))
                return {"k": z((n, batch, cl, k, e)),
                        "v": z((n, batch, cl, k, e))}
            if kind in ("mla_dense", "mla_moe"):
                m = cfg.mla
                return {"ckv": z((n, batch, cache_len, m.kv_lora_rank)),
                        "krope": z((n, batch, cache_len, m.rope_head_dim))}
            if kind == "dec":
                return {"self": {"k": z((n, batch, cache_len, k, e)),
                                 "v": z((n, batch, cache_len, k, e))},
                        "cross": {"ck": z((n, batch, enc_len, k, e)),
                                  "cv": z((n, batch, enc_len, k, e))}}
            if kind == "rec":
                dr = cfg.hybrid.d_rnn or cfg.d_model
                return {"h": z((n, batch, dr), torch.float32),
                        "conv": z((n, batch, cfg.hybrid.conv_width - 1, dr))}
            if kind == "ssd":
                s = cfg.ssm
                d_in = s.expand * cfg.d_model
                nheads = d_in // s.head_dim
                gn = s.n_groups * s.d_state
                w = s.conv_width - 1
                return {"h": z((n, batch, nheads, s.d_state, s.head_dim),
                               torch.float32),
                        "conv": {"x": z((n, batch, w, d_in)),
                                 "b": z((n, batch, w, gn)),
                                 "c": z((n, batch, w, gn))}}
            raise ValueError(kind)

        return {seg.name: {f"sub{i}": leaf(k, seg.count)
                           for i, k in enumerate(seg.kinds)}
                for seg in segments_for(cfg)}

    # -- decode ---------------------------------------------------------------
    def decode_step(self, params, cache, tokens, positions,
                    shard: Shard = _identity, cache_len: int = 0):
        """tokens: (B,) new token ids; positions: (B,) their indices.
        Returns (logits (B, V), new_cache); ``cache`` is left as it was."""
        with mesh_scope(params):
            return self._decode_step(params, cache, tokens, positions,
                                     shard, cache_len)

    def _decode_step(self, params, cache, tokens, positions, shard: Shard,
                     cache_len: int):
        cfg = self.cfg
        cache_len = cache_len or self._cache_len_from(cache)
        cos, sin = self._angles(self._decode_positions(positions))
        x = cm.embed_apply(params["embed"], tokens[:, None], cfg)
        ctx = self._ctx(cos=cos, sin=sin, phase="decode", shard=shard,
                        lengths=positions + 1, cache_len=cache_len)
        new_cache = {}
        for seg in segments_for(cfg):
            x, new_cache[seg.name], _ = self._run_segment(
                seg, params[seg.name], x, ctx, cache[seg.name])
        x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return cm.unembed_apply(params["embed"], x, cfg)[:, 0], new_cache

    def _cache_len_from(self, cache) -> int:
        for seg in segments_for(self.cfg):
            sub = cache[seg.name]["sub0"]
            for key in ("k", "ckv"):
                if key in sub:
                    return sub[key].shape[2]
            if "self" in sub:
                return sub["self"]["k"].shape[2]
        # state-space models: no kv length; the ring length is irrelevant
        return 1

    # -- prefill --------------------------------------------------------------
    def prefill(self, params, batch, cache_len: int,
                shard: Shard = _identity):
        """Full-sequence forward that also returns the populated cache.
        Returns (last-token logits (B, V), cache)."""
        with mesh_scope(params):
            return self._prefill(params, batch, cache_len, shard)

    def _prefill(self, params, batch, cache_len: int, shard: Shard):
        cfg = self.cfg
        b, s = batch["tokens"].shape
        cos, sin = self._angles(self._positions(batch, b, s,
                                                batch["tokens"].device))
        x, enc_out = self._embed(params, batch, shard)
        ctx = self._ctx(cos=cos, sin=sin, phase="prefill", shard=shard,
                        cache_len=cache_len, enc_out=enc_out)
        caches = {}
        for seg in segments_for(cfg):
            x, caches[seg.name], _ = self._run_segment(
                seg, params[seg.name], x, ctx)
        x = cm.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return cm.unembed_apply(params["embed"], x[:, -1:], cfg)[:, 0], caches
