"""Architecture registry (copy of ``repro.configs``): every assigned config
selectable by name, ``--arch <id>``; plus the scenario matrix's run-shape
presets (``sweeps``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        gemma_7b, minitron_8b, qwen3_32b, qwen2_5_3b, mixtral_8x7b,
        deepseek_v2_236b, qwen2_vl_72b, recurrentgemma_9b,
        seamless_m4t_large_v2, mamba2_1_3b,
    )
