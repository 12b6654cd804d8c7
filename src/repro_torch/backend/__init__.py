"""Dataplane-backend layer: one registry of hot-path primitives, each with
a plain PyTorch version (``ref``) and a CUDA kernel (``cuda``), selected by
a frozen ``BackendConfig`` (port of ``repro.backend``)."""
from repro_torch.backend.config import (BACKENDS, PRIMITIVES, BackendConfig,
                                        as_config)
from repro_torch.backend.registry import Primitive, dispatch, primitive

__all__ = [
    "BACKENDS", "PRIMITIVES", "BackendConfig", "as_config",
    "Primitive", "dispatch", "primitive",
]
