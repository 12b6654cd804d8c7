"""The causal-LM parameter layout the serving engine runs (port of the
matching part of ``repro.models.lm``).

An architecture is a list of homogeneous segments; each segment's
per-layer parameters are stacked on a leading layer axis, as the
reference's ``jax.vmap(init_one)`` gives.  This slice ports the ``dense``
block kind, which the ``dense`` and ``vlm`` families use.  The training,
prefill and decode phases belong to the LM-stack port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm

# the later slice that ports each remaining block kind
_LATER = {
    "moe": "models/moe.py (MoE blocks)",
    "mla_dense": "models/mla.py (MLA attention)",
    "mla_moe": "models/mla.py and models/moe.py",
    "rec": "models/rglru.py (RG-LRU blocks)",
    "attn_local": "models/rglru.py (the hybrid stack)",
    "ssd": "models/ssd.py (Mamba-2 blocks)",
    "dec": "the encoder-decoder stack of models/lm.py",
}


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


def ported_segments(cfg: ModelConfig) -> list[Segment]:
    """``segments_for(cfg)``; raises ``NotImplementedError`` naming the
    later slice when a block kind (or the encoder) is not ported yet."""
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder stack is not ported yet: it needs "
            f"{_LATER['dec']}, a later slice of the port")
    segs = segments_for(cfg)
    later = sorted({k for seg in segs for k in seg.kinds} - {"dense"})
    if later:
        raise NotImplementedError(
            f"block kind {later[0]!r} ({cfg.name}) is not ported yet: it "
            f"needs {_LATER[later[0]]}, a later slice of the port")
    return segs


def _block_init(gen, cfg: ModelConfig, kind: str, count: int, device):
    """One ``dense`` block's parameters for ``count`` stacked layers."""
    assert kind == "dense", kind
    d, lead = cfg.d_model, (count,)
    return {
        "ln1": cm.ones(lead + (d,), device),
        "attn": cm.attn_init(gen, cfg, device, lead),
        "ln2": cm.ones(lead + (d,), device),
        "ffn": cm.mlp_init(gen, d, cfg.d_ff, device, lead),
    }


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def init_params(self, generator: torch.Generator | None = None,
                    device=None) -> dict:
        """Random parameters drawn from ``generator`` on its device (or on
        ``device``; ``"meta"`` gives shapes and dtypes only).  Keys, shapes
        and dtypes are the reference's: ``embed.table`` (+ ``unembed``
        when untied), ``final_norm``, and per segment ``sub<i>`` blocks
        with a leading layer axis."""
        cfg = self.cfg
        segs = ported_segments(cfg)
        if device is None:
            device = generator.device
        device = torch.device(device)
        if device.type == "meta":
            generator = None
        params: dict[str, Any] = {
            "embed": cm.embed_init(generator, cfg, device),
            "final_norm": cm.ones((cfg.d_model,), device),
        }
        for seg in segs:
            params[seg.name] = {
                f"sub{i}": _block_init(generator, cfg, kind, seg.count,
                                       device)
                for i, kind in enumerate(seg.kinds)}
        return params
