"""The paper's eight PayloadPark monitoring counters (§5), plus ours.

Same names and order as ``repro.core.counters``.  Counters are int32 (the
reference's code, not its ``ParkState`` docstring, which says int64).
``torch.sum`` of a bool or int32 tensor returns int64, so ``bump`` casts
the amount back to int32 before adding.

Counters may carry leading batch (pipe) dimensions: ``counters[..., i]``.
"""
from __future__ import annotations

import torch

NAMES = (
    "splits",              # Split operations with ENB=1 (stage 2, §5)
    "merges",              # successful Merges
    "explicit_drops",      # OP=drop packets that freed a slot (§6.2.4)
    "disabled_returns",    # packets back from NF server with ENB=0 (stage 1)
    "evictions",           # total payload evictions (expiry reached 0)
    "premature_evictions", # Merge found generation mismatch -> packet dropped
    "skip_small_payload",  # Split disabled: payload < park size (§5)
    "skip_occupied",       # Split disabled: next metadata slot occupied
    "crc_failures",        # Merge-side tag CRC validation failures
    "recirculations",      # packets that took a recirculation pass (§6.2.5)
    "recirc_budget_drops", # recirc candidates denied by the port budget
    "fault_drops",         # packets sent to a down NF server
)
IDX = {n: i for i, n in enumerate(NAMES)}
NUM = len(NAMES)


def zeros(device, lead: tuple[int, ...] = ()) -> torch.Tensor:
    return torch.zeros(lead + (NUM,), dtype=torch.int32, device=device)


def bump(counters: torch.Tensor, name: str, amount) -> torch.Tensor:
    """``counters[..., name] += amount`` (int32; returns a new tensor).

    ``amount`` is a tensor with the counters' leading shape (any integer
    dtype) or a Python int."""
    if not torch.is_tensor(amount):
        amount = torch.tensor(amount, dtype=torch.int32,
                              device=counters.device)
    out = counters.clone()
    out[..., IDX[name]] += amount.to(torch.int32)
    return out


def as_dict(counters: torch.Tensor) -> dict[str, int]:
    vals = [int(v) for v in counters.cpu().tolist()]
    return dict(zip(NAMES, vals))
