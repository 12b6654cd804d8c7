"""Fabric-scale sharded simulation: the pipe axis across devices (port of
``repro.switchsim.fabric``; DESIGN.md §12).

One ToR switch is 8 per-port pipes on one device (``engine.run_pipes``).
A datacenter fabric is dozens of such switches, and pipes share nothing
(the hardware pipes share nothing either), so the flat pipe axis the
scenario runner already batches on is embarrassingly shardable.

The reference ``shard_map``s its vmapped program over a 1-D
``("switch",)`` mesh.  The port is a single-controller runner instead:

  * ``shard_over_switch`` slices every pipe-leading input (traces, fault
    masks, drain flags) into ``devices`` contiguous shards and puts each
    on the physical device of its logical device
    (``repro_torch.distributed.physical_device``);
  * the engine runs each shard's step loop on its device, the shards in
    lockstep, so where several cards are visible every shard's launches
    of a step go out before any device is waited on and the cards
    overlap; on one card the shards run one after another on its stream;
  * ``gather`` brings the per-pipe outputs together in shard order: host
    tallies concatenated in int64, device tensors on the device the run
    was asked for.

There are no collectives, because the reference has none: every output
carries the pipe axis leading and no shard reads another's state.
``resolve_devices`` is the guarded fallback to replication
(``distributed.sharding.divides_axis``, the same predicate the
model-parallel rules use): when the pipe count does not divide the
requested device count, or fewer logical devices are visible than
requested, the run warns and executes on one device, on the device asked
for — never padded, never crashed.

**Shard-count invariance is the correctness contract**: the same
``ScenarioSpec`` run on 1, 2 or 8 devices gives bit-identical counters,
telemetry and occupancy, because sharding only re-tiles the pipe axis and
every per-pipe step is reduction-free across pipes (cross-pipe sums
happen on the host in int64 after the run, as in the single-device path).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.packet import PacketBatch, map_fields
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import logical_devices, physical_device
from repro_torch.distributed.sharding import divides_axis
from repro_torch.switchsim.faults import FaultArrays

SWITCH_AXIS = "switch"


def fabric_devices(device=DEFAULT_DEVICE) -> int:
    """Logical devices visible to the fabric on ``device``'s type
    (``distributed.force_host_devices`` raises the count)."""
    return logical_devices(resolve_device(device).type)


def resolve_devices(pipes: int, devices: int | None,
                    device=DEFAULT_DEVICE) -> int:
    """Guarded fallback to replication: the device count a ``pipes``-wide
    run will actually shard over.

    Returns ``devices`` when it is usable (>1, visible, and dividing the
    pipe axis); otherwise warns and returns 1, the single-device path.
    Shard-count invariance makes the fallback safe: results are
    bit-identical either way, only the wall clock changes.
    """
    if devices is None or devices <= 1:
        return 1
    avail = fabric_devices(device)
    if devices > avail:
        warnings.warn(
            f"fabric: {devices} devices requested but only {avail} "
            f"visible — running replicated on one device.  Raise the "
            f"logical device count first "
            f"(repro_torch.distributed.force_host_devices({devices})).",
            stacklevel=2)
        return 1
    if not divides_axis(pipes, devices):
        warnings.warn(
            f"fabric: pipe axis of {pipes} does not divide over "
            f"{devices} devices — falling back to replication "
            f"(single device; results are bit-identical by the "
            f"shard-count-invariance contract).",
            stacklevel=2)
        return 1
    return devices


def shard_bounds(pipes: int, devices: int) -> list[tuple[int, int]]:
    """The contiguous ``[lo, hi)`` pipe range of each shard."""
    assert divides_axis(pipes, devices), (pipes, devices)
    per = pipes // devices
    return [(i * per, (i + 1) * per) for i in range(devices)]


def shard_over_switch(traces: PacketBatch, fa: FaultArrays, devices: int,
                      device: torch.device
                      ) -> list[tuple[PacketBatch, FaultArrays]]:
    """Each shard's (traces, fault masks): a contiguous slice of the pipe
    axis, the traces on the physical device of the shard's logical
    device."""
    out = []
    for i, (lo, hi) in enumerate(shard_bounds(fa.pipes, devices)):
        dev = physical_device(i, device)
        out.append((map_fields(lambda n, a: a[lo:hi].to(dev), traces),
                    FaultArrays(server_up=fa.server_up[lo:hi],
                                lb_up=fa.lb_up[lo:hi],
                                drain=fa.drain[lo:hi])))
    return out


def gather(parts: list, device: torch.device):
    """Concatenate per-shard outputs along the pipe axis in shard order:
    numpy arrays on the host, tensors on ``device``, lists, dicts,
    dataclasses and PacketBatches leaf by leaf.  One part passes through
    unchanged (the single-device path)."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, np.ndarray):
        return np.concatenate(parts, axis=0)
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts], dim=0)
    if isinstance(first, list):
        return [x for p in parts for x in p]
    if isinstance(first, dict):
        return {k: gather([p[k] for p in parts], device) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: gather([getattr(p, f.name) for p in parts], device)
            for f in dataclasses.fields(first)})
    raise TypeError(f"cannot gather {type(first).__name__}")
