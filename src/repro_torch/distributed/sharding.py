"""Logical-axis sharding rules: parameter, batch and cache trees ->
partition specs -> DTensor placements (port of
``repro.distributed.sharding``).

Megatron-style 2-D (+pod) layout on mesh axes ("pod", "data", "model"):
  * batch over ("pod", "data") — pod folds into data parallelism;
  * attention heads / FFN hidden / vocab over "model" (tensor parallel);
  * GQA kv-head projections shard over "model" only when kv_heads divides the
    axis; otherwise they replicate and the *decode KV cache* shards over the
    sequence axis instead (context parallelism);
  * MoE experts shard over "model" when num_experts divides it (EP —
    deepseek's 160/16), else expert-internal d_ff shards (TP — mixtral's 8);
  * SSD heads and RG-LRU channels shard over "model" (head-parallel scan).

Rules are name+shape based over the ``/``-joined leaf paths (the port's
trees carry the reference's keys); anything unmatched replicates.  Every
rule goes through ``divides_axis``, which falls back to replication when
a dimension does not divide the axis, so no shard is ever uneven
(``distribute`` asserts it).

A spec is a ``P``: a tuple with one entry per tensor dim, each ``None``
(replicated), a mesh axis name, or a tuple of names (sharded over their
product, major to minor).  ``placements`` turns a spec into DTensor
``Shard`` / ``Replicate`` placements per mesh dim, and ``distribute``
lays a tree out on a ``DeviceMesh`` (the reference's ``to_shardings`` +
``device_put``).  ``act_shard`` is the model's ``shard(x, name)`` hook:
on a DTensor it redistributes to the reference's layout for ``name``
(``act_spec``; the reference's ``with_sharding_constraint``), and it
leaves a plain tensor alone.

Two consumers share ``axis_size`` / ``divides_axis``: the model-parallel
side (``Rules``, ``launch/train.py``) and the dataplane side
(``switchsim/fabric.py``, whose pipe axis falls back to one device when
it does not divide the device count).
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of axis names); trailing dims left out replicate.  As
    JAX's ``PartitionSpec``, a tuple of one axis is that axis and an empty
    tuple is ``None``."""

    def __new__(cls, *parts):
        def norm(part):
            if isinstance(part, (tuple, list)):
                part = tuple(part)
                return (None if not part else part[0] if len(part) == 1
                        else part)
            return part
        return super().__new__(cls, (norm(p) for p in parts))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object whose
    ``shape`` already is that dict, as the reference's ``Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(mesh, n) for n in name)
    shape = mesh_shape(mesh)
    return shape[name] if name in shape else 1


def divides_axis(dim: int, size: int) -> bool:
    """The guarded-sharding predicate: can ``dim`` shard over an axis of
    ``size`` devices without padding?  Every sharding decision in the
    port — ``Rules.g`` for model dims, ``fabric.resolve_devices`` for the
    pipe axis — routes through this one check, so "doesn't divide" always
    means the same thing: fall back to replication, never pad or crash."""
    return dim % max(size, 1) == 0


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _map_with_path(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: the
    tensor dim whose entry names the mesh dim is ``Shard``, else
    ``Replicate``.  A tensor dim over a tuple of axes shards on each of
    them, in mesh order (JAX's major-to-minor order).  A mesh dim of one
    device is ``Replicate`` whatever the spec: the same layout, and DTensor
    refuses reshapes of a dim sharded over it that JAX takes."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        assert len(dims) <= 1, (spec, name)
        out.append(Shard(dims[0]) if dims and sizes[name] > 1
                   else Replicate())
    return tuple(out)


def _check_even(spec: P, shape, mesh) -> None:
    for d, part in enumerate(spec):
        size = axis_size(mesh, part)
        assert shape[d] % size == 0, (
            f"dim {d} of {tuple(shape)} does not divide over {part} ({size})")


def distribute(tree, spec_tree, mesh):
    """Lay ``tree`` out on ``mesh`` leaf by leaf under ``spec_tree`` (the
    reference's ``device_put`` with ``to_shardings``): every leaf becomes a
    DTensor with ``placements(spec)``.  Every rank passes the same global
    tree (the port's parameters, batches and checkpoints are drawn or read
    alike on every rank) and keeps its own shard of it: no collective.  A
    replicated leaf keeps the tensor it was given, so later in-place
    updates (``apply_updates``) write through to it."""
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, spec):
        _check_even(spec, leaf.shape, mesh)
        return distribute_tensor(leaf, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    if isinstance(tree, dict):
        return {k: distribute(v, spec_tree[k], mesh) for k, v in tree.items()}
    return one(tree, spec_tree)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a plain tensor is told apart without
    importing DTensor)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class Rules:
    """Resolve partition specs for one (cfg, mesh) pair.

    ``fsdp=True`` additionally shards every >=2-D weight's first free
    divisible dim over "data" (ZeRO-3 within a pod).
    """

    def __init__(self, cfg: ModelConfig, mesh,
                 seq_sharded_cache: bool = True,
                 sp_activations: bool = False,
                 fsdp: bool = True,
                 head_sharded_cache: bool = False,
                 pin_attn_heads: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.model = axis_size(mesh, "model")
        self.dp = dp_axes(mesh)
        self.seq_sharded_cache = seq_sharded_cache
        self.sp_activations = sp_activations
        self.fsdp = fsdp
        # shard the decode cache on kv-heads instead of sequence when
        # kv_heads divides the model axis
        self.head_sharded_cache = head_sharded_cache
        # pin q/kv head sharding through the attention reshapes (opt-in,
        # chosen per arch in the reference)
        self.pin_attn_heads = pin_attn_heads

    def _add_fsdp(self, spec: P, shape: tuple[int, ...]) -> P:
        if not self.fsdp or len(shape) < 2:
            return spec
        data = axis_size(self.mesh, "data")
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (p, dim) in enumerate(zip(parts, shape)):
            if p is None and dim % max(data, 1) == 0 and dim >= data:
                parts[i] = "data"
                break
        return P(*parts)

    # -- helpers ------------------------------------------------------------
    def g(self, dim: int, axis: str = "model") -> Optional[str]:
        """axis if dim divides its size, else None (replicate)."""
        return axis if divides_axis(dim, axis_size(self.mesh, axis)) else None

    # -- parameters -----------------------------------------------------------
    def param_spec(self, path: str, shape: tuple[int, ...]) -> P:
        cfg = self.cfg
        m = self.model
        s = P

        # embeddings
        if path.endswith("embed/table"):
            return s(self.g(shape[0]), None)            # vocab over model
        if path.endswith("embed/unembed"):
            return s(None, self.g(shape[1]))
        # attention
        if re.search(r"(attn|cross)/wq$", path):
            return s(None, self.g(shape[1]), None)
        if re.search(r"(attn|cross)/w[kv]$", path):
            return s(None, self.g(shape[1]), None)      # replicates if kv<m
        if re.search(r"(attn|cross)/wo$", path):
            return s(self.g(shape[0]), None, None)
        if re.search(r"(attn|cross)/b[qkv]$", path):
            return s(self.g(shape[0]), None)
        # MLA
        if path.endswith("attn/wq_a"):
            return s(None, self.g(shape[1]))
        if path.endswith("attn/wq_b"):
            return s(None, self.g(shape[1]), None)
        if path.endswith("attn/wkv_a"):
            return s(None, None)
        if re.search(r"attn/w[kv]_b$", path):
            return s(None, self.g(shape[1]), None)      # heads over model
        # MoE
        if path.endswith("ffn/router"):
            return s(None, None)
        if re.search(r"ffn/w[ig]$", path) and len(shape) == 3:
            if cfg.moe and cfg.moe.num_experts % m == 0:
                return s("model", None, None)           # EP
            return s(None, None, self.g(shape[2]))      # TP inside experts
        if path.endswith("ffn/wo") and len(shape) == 3:
            if cfg.moe and cfg.moe.num_experts % m == 0:
                return s("model", None, None)
            return s(None, self.g(shape[1]), None)
        # dense MLP (incl. MoE shared experts)
        if re.search(r"(ffn|shared)/w[ig]$", path):
            return s(None, self.g(shape[1]))
        if re.search(r"(ffn|shared)/wo$", path):
            return s(self.g(shape[0]), None)
        # RG-LRU
        if re.search(r"rec/(w_gate|w_x)$", path):
            return s(None, self.g(shape[1]))
        if re.search(r"rec/(wa_gate|wx_gate)$", path):
            return s(self.g(shape[0]), None, None)      # gate blocks = heads
        if re.search(r"rec/conv_w$", path):
            return s(None, self.g(shape[1]))
        if path.endswith("rec/w_out"):
            return s(self.g(shape[0]), None)
        # SSD
        if re.search(r"ssd/(w_z|w_x)$", path):
            return s(None, self.g(shape[1]))
        if path.endswith("ssd/w_dt"):
            return s(None, self.g(shape[1]))
        if re.search(r"ssd/conv_x$", path):
            return s(None, self.g(shape[1]))
        if path.endswith("ssd/out_proj"):
            return s(self.g(shape[0]), None)
        # everything else (norms, biases, scalars, B/C projections) replicates
        return P()

    def param_specs(self, params) -> dict:
        def spec_of(key, leaf):
            shape = tuple(leaf.shape)
            # embeddings stay model-sharded only; norms/scalars replicate;
            # everything else may pick up an FSDP dim.
            skip_fsdp = ("embed/" in key or len(shape) < 2
                         or re.search(r"(ln\d|norm|_b$|bias)", key))
            # params stacked along a segment's layer axis: rules see the
            # per-layer shape; prepend None for the stack dim.
            if self._is_stacked(key):
                inner = self.param_spec(key, shape[1:])
                if not skip_fsdp:
                    inner = self._add_fsdp(inner, shape[1:])
                return P(None, *inner)
            spec = self.param_spec(key, shape)
            if not skip_fsdp:
                spec = self._add_fsdp(spec, shape)
            return spec

        return _map_with_path(spec_of, params)

    def _is_stacked(self, key: str) -> bool:
        # segment params contain "/subN/" (stacked); top-level embed / norms
        # do not.
        return "/sub" in key

    # -- activations (the shard hook of models.lm) --------------------------
    def act_spec(self, shape: tuple[int, ...], name: str) -> Optional[P]:
        """The reference's ``with_sharding_constraint`` layout for an
        activation ``name`` of ``shape``, or None to leave it as it is."""
        nd = len(shape)
        if name == "act" and nd == 3:
            dp = self._dp_for(shape[0])
            sp = "model" if (self.sp_activations
                             and shape[1] % max(self.model, 1) == 0
                             and shape[1] >= self.model) else None
            return P(dp, sp, None)
        if name == "mla_latent" and nd == 3:
            # the sequence all-gather happens on the compressed latent,
            # never on the per-head expansion
            return P(self._dp_for(shape[0]), None, None)
        if name == "q_heads" and nd == 5:
            if not self.pin_attn_heads:
                return None
            return P(self._dp_for(shape[0]), None, self.g(shape[2]), None,
                     None)
        if name == "kv_heads" and nd == 4:
            if not self.pin_attn_heads:
                return None
            return P(self._dp_for(shape[0]), None, self.g(shape[2]), None)
        if name == "logits" and nd == 3:
            return P(self._dp_for(shape[0]), None, self.g(shape[2]))
        if name == "kv_compact" and nd == 4:
            # gather GQA kv across the sequence shards before the
            # repeat-to-H expansion: the compact (B,S,K,E) form moves
            return P(self._dp_for(shape[0]), None, self.g(shape[2]), None)
        return None  # cache layouts are pinned via cache_spec

    def act_shard(self):
        """The model's ``shard(x, name)`` hook: a DTensor goes to
        ``act_spec``'s layout (a redistribute, differentiable); a plain
        tensor, or a name with no layout, passes through."""
        def shard(x, name):
            if not is_dtensor(x):
                return x
            spec = self.act_spec(tuple(x.shape), name)
            if spec is None:
                return x
            _check_even(spec, x.shape, x.device_mesh)
            want = placements(spec, x.device_mesh)
            if tuple(x.placements) == want:
                return x
            return x.redistribute(x.device_mesh, want)

        return shard

    # -- batches ---------------------------------------------------------------
    def _dp_for(self, batch_dim: int):
        """dp axes if the batch dim divides them; else None (batch=1 cells)."""
        return self.dp if batch_dim % axis_size(self.mesh, self.dp) == 0 \
            else None

    def _seq_axes(self, batch_dim: int, seq_dim: int):
        """Sequence axis sharding for caches: when the batch can't shard
        (long-context batch=1), spread the sequence over the whole mesh."""
        if not self.seq_sharded_cache:
            return None
        candidates = ((("data", "model"),) if self._dp_for(batch_dim) is None
                      else ()) + (("model",), None)
        for cand in candidates:
            if cand is None:
                return None
            if seq_dim % axis_size(self.mesh, cand) == 0:
                return cand
        return None

    def batch_spec(self, batch_tree) -> dict:
        def spec_of(path, leaf):
            key = path.split("/")[-1]
            shape = tuple(leaf.shape)
            if key == "positions" and len(shape) == 3:
                return P(None, self._dp_for(shape[1]), None)
            return P(self._dp_for(shape[0]), *([None] * (len(shape) - 1)))

        return _map_with_path(spec_of, batch_tree)

    # -- caches ------------------------------------------------------------------
    def cache_spec(self, cache_tree) -> dict:
        """Decode caches: batch over dp (when divisible); kv sequence axis
        over model — or over the whole mesh for unsharded-batch long-context
        cells (context parallelism); recurrent states shard channels/heads
        over model.  Leading dim of every leaf is the segment's layer
        stack."""

        def spec_of(path, leaf):
            key = path.split("/")[-1]
            shape = tuple(leaf.shape)
            nd = len(shape)
            if key in ("k", "v", "ck", "cv"):        # (L,B,T,K,E)
                dp = self._dp_for(shape[1])
                if (self.head_sharded_cache
                        and shape[3] % max(self.model, 1) == 0):
                    return P(None, dp, None, "model", None)
                seq = self._seq_axes(shape[1], shape[2])
                return P(None, dp, seq, None, None)
            if key == "ckv" or key == "krope":       # (L,B,T,R)
                dp = self._dp_for(shape[1])
                seq = self._seq_axes(shape[1], shape[2])
                return P(None, dp, seq, None)
            dp = self._dp_for(shape[1])
            if key == "h" and nd == 3:               # rec state (L,B,Dr)
                return P(None, dp, self.g(shape[2]))
            if key == "h" and nd == 5:               # ssd state (L,B,H,N,P)
                return P(None, dp, self.g(shape[2]), None, None)
            if key in ("x",):                        # ssd conv state (L,B,W,D)
                return P(None, dp, None, self.g(shape[3]))
            if key in ("b", "c"):
                return P(None, dp, None, None)
            if key == "conv" and nd == 4:            # rec conv (L,B,W,Dr)
                return P(None, dp, None, self.g(shape[3]))
            return P(None, dp, *([None] * (nd - 2)))

        return _map_with_path(spec_of, cache_tree)

    # -- train state ---------------------------------------------------------------
    def state_spec(self, state) -> dict:
        pspecs = self.param_specs(state["params"])
        return {
            "params": pspecs,
            "opt": {
                "m": pspecs,
                "v": pspecs,
                "step": P(),
            },
        }
