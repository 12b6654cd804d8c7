"""Frozen backend selection for the dataplane-primitive registry.

Port of ``repro.backend.config``.  A ``BackendConfig`` names which
implementation of each hot-path primitive the dataplane (and, for
``paged_attention``, the serving engine) runs; ``split_control`` and
``merge_stage`` are Split's and Merge's whole control passes,
``merge_payload`` Merge's packet transformation, and ``nf_chain`` the NF
chain's whole header pass:

  * ``"ref"``  — the plain PyTorch version (``repro_torch.backend.ref``),
                 on whatever device its tensors lie;
  * ``"cuda"`` — the hand-written CUDA kernel (``repro_torch.kernels``);
                 raises on CPU tensors;
  * ``"auto"`` — resolved from the tensors' device at call time: ``cuda``
                 for CUDA tensors, ``ref`` for CPU tensors.

``ref`` on CUDA tensors runs only when chosen explicitly (the kernel-vs-
plain comparison does that); nothing on the default path picks it there.
"""
from __future__ import annotations

import dataclasses

# The registry asserts it implements exactly this set, in this order.
PRIMITIVES = ("crc16_tag", "acl_match", "maglev_select", "payload_store",
              "payload_fetch", "paged_attention", "split_control",
              "merge_stage", "nf_chain", "merge_payload")

BACKENDS = ("ref", "cuda", "auto")


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """One default plus per-primitive overrides (a sorted tuple of
    ``(primitive, backend)`` pairs; a dict is accepted and normalized)."""

    default: str = "auto"
    overrides: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        if isinstance(self.overrides, dict):
            object.__setattr__(self, "overrides",
                               tuple(sorted(self.overrides.items())))
        if self.default not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.default!r} (have {BACKENDS})")
        for prim, mode in self.overrides:
            if prim not in PRIMITIVES:
                raise ValueError(
                    f"override for unknown primitive {prim!r} "
                    f"(have {PRIMITIVES})")
            if mode not in BACKENDS:
                raise ValueError(
                    f"unknown backend {mode!r} for {prim!r} "
                    f"(have {BACKENDS})")

    def mode(self, primitive: str) -> str:
        """The configured mode ("ref" | "cuda" | "auto") of one primitive;
        ``"auto"`` is left for the call site to resolve from its tensors."""
        if primitive not in PRIMITIVES:
            raise KeyError(
                f"unknown primitive {primitive!r} (have {PRIMITIVES})")
        return dict(self.overrides).get(primitive, self.default)


def as_config(backend: "BackendConfig | str | None") -> BackendConfig:
    """None (= auto), a backend name, or a full BackendConfig."""
    if backend is None:
        return BackendConfig()
    if isinstance(backend, BackendConfig):
        return backend
    if isinstance(backend, str):
        return BackendConfig(default=backend)
    raise TypeError(
        f"backend must be a BackendConfig, a backend name or None; "
        f"got {type(backend).__name__}")
