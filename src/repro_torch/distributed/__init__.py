"""Distribution layer: sharding rules, pipeline parallelism, collectives
(port of ``repro.distributed``).

Two consumers sit on top of this package:

  * the model-parallel side — ``sharding.Rules`` lays the LM's parameters,
    batches, caches and optimizer state out over a ``("pod",) "data",
    "model"`` DTensor mesh (``launch/mesh.py``), ``launch/train.py``
    trains under it and ``pipeline.py`` runs GPipe stages over a mesh
    axis;
  * the dataplane side — ``switchsim/fabric.py`` shards the engine's flat
    pipe axis over logical devices (DESIGN.md §12).

**Logical devices** stand in for the reference's forced host devices.
The reference's ``force_host_devices(n)`` makes XLA expose ``n`` devices
on one CPU, so CPU-only hosts run real sharded programs.  Torch has no
such count, so this module keeps a process-wide count of logical devices
that the fabric sees: logical device ``i`` runs on physical device
``i % visible`` of the type the run names (the CPU, or
``cuda:(i % torch.cuda.device_count())``).  A CPU-only host and a host
with one card both run the fabric's shards that way, each shard its own
program on its own (possibly shared) device.

The count is not locked once read: the fabric reads it at every
``resolve_devices`` call, so a later ``force_host_devices`` takes effect
at the next run, and the reference's ``RuntimeError`` for a late call has
no cause here.  ``jax_backend_initialized`` has no torch meaning (torch
fixes no device count at start-up) and has no counterpart.
"""
from __future__ import annotations

import torch

_forced: int | None = None


def force_host_devices(n: int | None) -> None:
    """Expose ``n`` logical devices to the fabric, whatever the device
    type; ``None`` restores the default (the visible devices of the run's
    type).  Raises ``ValueError`` for ``n < 1``."""
    global _forced
    if n is not None:
        n = int(n)
        if n < 1:
            raise ValueError(f"device count must be >= 1, got {n}")
    _forced = n


def forced_host_devices() -> int | None:
    """The count set by ``force_host_devices``, or None."""
    return _forced


def visible_devices(device_type: str) -> int:
    """Physical devices of ``device_type``: the card count for CUDA, one
    CPU."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def logical_devices(device_type: str) -> int:
    """Logical devices the fabric sees on ``device_type``: the forced count,
    else the visible physical devices."""
    return _forced if _forced is not None else visible_devices(device_type)


def physical_device(i: int, device: torch.device) -> torch.device:
    """The physical device logical device ``i`` runs on: a CUDA run's
    logical devices go round the visible cards starting at ``device``'s
    index; a CPU run's all share the CPU."""
    if device.type != "cuda":
        return device
    first = (device.index if device.index is not None
             else torch.cuda.current_device())
    return torch.device("cuda", (first + i) % torch.cuda.device_count())
