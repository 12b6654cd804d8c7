"""Input shapes and per-(arch x shape) applicability (copy of
``repro.configs.shapes``).

LM transformer shapes are seq_len x global_batch.  ``decode_*`` /
``long_*`` are one new token against a KV cache of seq_len, not a train
step.  ``long_500k`` needs sub-quadratic attention: it runs for SSM /
hybrid / sliding-window archs and is skipped, with the reason recorded,
for pure full-attention archs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for one (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention: 500k-token decode state "
                       "is unbounded; skipped per the assignment brief "
                       "(runs only for SSM/hybrid/sliding-window archs)")
    return True, ""


def cells(cfg: ModelConfig):
    """All shape cells for one arch with applicability annotations."""
    out = []
    for s in SHAPES.values():
        ok, why = applicable(cfg, s)
        out.append((s, ok, why))
    return out
