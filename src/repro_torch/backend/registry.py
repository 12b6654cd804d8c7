"""The dataplane-primitive registry: one plain version and one CUDA kernel
per primitive (port of ``repro.backend.registry``).

``dispatch(name, backend)`` is the single switch every hot-path call site
goes through.  ``ref`` returns the plain PyTorch version, ``cuda`` the
kernel launcher (which raises on CPU tensors), and ``auto`` the kernel
module's own entry, which picks the plain version for CPU tensors and the
kernel for CUDA tensors.  The kernel modules are imported lazily, inside
the wrappers, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.backend import ref as R
from repro_torch.backend.config import PRIMITIVES, as_config


@dataclasses.dataclass(frozen=True)
class Primitive:
    """One registry entry: the plain version, the kernel launcher and the
    device-resolved ``auto`` entry."""

    name: str
    ref: Callable
    cuda: Callable
    auto: Callable


def _kernel(module: str, fn: str) -> Callable:
    def call(*args):
        import importlib
        mod = importlib.import_module(f"repro_torch.kernels.{module}")
        return getattr(mod, fn)(*args)
    call.__name__ = f"{module}.{fn}"
    return call


_REGISTRY: dict[str, Primitive] = {
    p.name: p for p in (
        Primitive("crc16_tag", R.crc16_tag,
                  _kernel("crc16", "crc16_tag_cuda"),
                  _kernel("crc16", "crc16_tag")),
        Primitive("acl_match", R.acl_match,
                  _kernel("acl_match", "acl_match_cuda"),
                  _kernel("acl_match", "acl_match")),
        Primitive("maglev_select", R.maglev_select,
                  _kernel("maglev", "maglev_select_cuda"),
                  _kernel("maglev", "maglev_select")),
        Primitive("payload_store", R.payload_store,
                  _kernel("payload_store", "payload_store_cuda"),
                  _kernel("payload_store", "payload_store")),
        Primitive("payload_fetch", R.payload_fetch,
                  _kernel("payload_fetch", "payload_fetch_cuda"),
                  _kernel("payload_fetch", "payload_fetch")),
        Primitive("paged_attention", R.paged_decode_attention,
                  _kernel("paged_attention", "paged_decode_attention_cuda"),
                  _kernel("paged_attention", "paged_decode_attention")),
        Primitive("split_control", R.split_control,
                  _kernel("split_control", "split_control_cuda"),
                  _kernel("split_control", "split_control")),
        Primitive("merge_stage", R.merge_stage,
                  _kernel("merge_stage", "merge_stage_cuda"),
                  _kernel("merge_stage", "merge_stage")),
        Primitive("nf_chain", R.nf_chain,
                  _kernel("nf_chain", "nf_chain_cuda"),
                  _kernel("nf_chain", "nf_chain")),
        Primitive("merge_payload", R.merge_payload,
                  _kernel("merge_payload", "merge_payload_cuda"),
                  _kernel("merge_payload", "merge_payload")),
    )
}

assert tuple(_REGISTRY) == PRIMITIVES, (tuple(_REGISTRY), PRIMITIVES)


def primitive(name: str) -> Primitive:
    if name not in _REGISTRY:
        raise KeyError(f"unknown primitive {name!r} (have {PRIMITIVES})")
    return _REGISTRY[name]


def dispatch(name: str, backend=None) -> Callable:
    """Resolve one primitive to the callable its backend selects."""
    prim = primitive(name)
    return getattr(prim, as_config(backend).mode(name))
