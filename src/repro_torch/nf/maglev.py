"""Maglev L4 load balancer NF (port of ``repro.nf.maglev``; paper §6.1,
after Eisenbud et al., NSDI'16).

The lookup table is built once at configuration time in numpy (the
permutation fill is sequential; ``_mix64``, ``build_table`` and
``degraded_table`` are copies of the reference's).  Per packet the LB
hashes the 5-tuple, indexes the table and rewrites ``dst_ip`` to the chosen
backend: the ``lb`` stage of the ``nf_chain`` primitive (plain version
``backend/ref.py::maglev_select``; on the card the device code of
``csrc/maglev.cuh`` inside ``csrc/nf_chain.cu``).  Calling a ``MaglevLB``
runs a one-stage chain.

The table is configuration, not per-pipe state, so ``init_state`` returns
one (T,) table shared by every pipe.  With a ``fault_target`` the state
also holds the degraded table, and ``ctx["lb_up"]`` (a 0-d flag in the
host loop, one flag per pipe in the engine) picks live or degraded; the
stage carries both tables and the flag, and each pipe reads the row its
flag picks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backend.ref import LbState, Stage
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import NF

CYCLES = 120.0  # hash + table lookup + rewrite


def _mix64(salt: int, b: int) -> int:
    """Deterministic splitmix64 finalizer over (salt, backend)."""
    x = (b * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) & (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (1 << 64) - 1
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (1 << 64) - 1
    return x ^ (x >> 31)


def build_table(backends: tuple[int, ...], table_size: int) -> np.ndarray:
    """Maglev population: each backend fills preferred slots by (offset, skip)."""
    n = len(backends)
    offset = np.array([_mix64(1, b) % table_size for b in backends])
    skip = np.array([_mix64(2, b) % (table_size - 1) + 1 for b in backends])
    entry = np.full(table_size, -1, np.int32)
    nxt = np.zeros(n, np.int64)
    filled = 0
    while filled < table_size:
        for i in range(n):
            c = (offset[i] + nxt[i] * skip[i]) % table_size
            while entry[c] >= 0:
                nxt[i] += 1
                c = (offset[i] + nxt[i] * skip[i]) % table_size
            entry[c] = i
            nxt[i] += 1
            filled += 1
            if filled == table_size:
                break
    return entry


def degraded_table(backends: tuple[int, ...], table_size: int,
                   dead: int) -> np.ndarray:
    """Lookup table with backend index ``dead`` removed, entries in the
    original backend indexing: the surviving backends re-run the
    population over the same table size, so most surviving slots keep
    their assignment (Maglev's minimal disruption)."""
    surviving = tuple(b for i, b in enumerate(backends) if i != dead)
    orig_idx = np.array([i for i in range(len(backends)) if i != dead],
                        np.int32)
    return orig_idx[build_table(surviving, table_size)]


@dataclasses.dataclass(frozen=True)
class MaglevLB(NF):
    backends: tuple[int, ...] = tuple(0x0A000100 + i for i in range(8))
    table_size: int = 251  # small prime; Maglev paper uses 65537 in prod
    # when >= 0, the state also carries the degraded table with this
    # backend removed, and ``ctx["lb_up"]`` selects live vs degraded
    fault_target: int = -1

    def __post_init__(self):
        if self.fault_target >= len(self.backends):
            raise ValueError(
                f"fault_target {self.fault_target} out of range for "
                f"{len(self.backends)} backends")

    def init_state(self, device=DEFAULT_DEVICE, pipes: int | None = None):
        dev = resolve_device(device)
        state = dict(
            table=torch.from_numpy(
                build_table(self.backends, self.table_size)).to(dev),
            backend_ips=torch.tensor(list(self.backends), dtype=torch.int32,
                                     device=dev),
        )
        if self.fault_target >= 0:
            state["table_down"] = torch.from_numpy(degraded_table(
                self.backends, self.table_size, self.fault_target)).to(dev)
        return state

    def stage(self, state, ctx=None) -> Stage:
        table, up = state["table"], None
        if self.fault_target >= 0 and ctx is not None and "lb_up" in ctx:
            up = torch.as_tensor(ctx["lb_up"], device=table.device)
        return Stage("lb", LbState(
            table=table, backend_ips=state["backend_ips"],
            table_down=None if up is None else state["table_down"], up=up))

    def cycles_of(self, state) -> float:
        return CYCLES
