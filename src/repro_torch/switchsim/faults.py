"""Fault-injection layer for the engine (copy of
``repro.switchsim.faults``, pure numpy, kept in the port so the port
imports nothing of the reference).

A ``FaultSpec`` describes one fault event; ``resolve`` lowers it to
per-step boolean masks the engine consumes step by step — ``server_up``
(per pipe: is this pipe's NF server reachable at step t?) and ``lb_up``
(is the Maglev fault target alive?) — plus a per-pipe ``drain`` flag.
All-True masks are exact no-ops on the step.

  * ``server`` — the NF server behind pipe ``pipe`` is down for
    ``duration`` steps from ``start``.  Packets sent meanwhile are lost
    (``fault_drops``); their parked payloads either drain (OP=drop
    notifications free the slots at Merge) or leak until eviction.
  * ``lb`` — backend ``backend`` of the Maglev LB dies for the window
    (the LB is not part of this slice; the mask is carried unchanged).

Masks cover the offered trace steps; the engine pads them with True so
drain/warm-up padding always runs healthy.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("none", "server", "lb")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault event (frozen + hashable, like ScenarioSpec).

    ``kind="none"`` (the default) is the healthy run; ``start``/``duration``
    are engine steps; ``pipe`` selects the victim pipe for ``server``
    faults; ``backend`` the victim Maglev backend for ``lb`` faults;
    ``drain`` picks the drain-vs-drop failover rule (server faults only).
    """

    kind: str = "none"
    start: int = 0
    duration: int = 0
    pipe: int = 0
    backend: int = 0
    drain: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (have {FAULT_KINDS})")
        if self.start < 0 or self.duration < 0:
            raise ValueError(
                f"fault start/duration must be >= 0, got "
                f"({self.start}, {self.duration})")
        if self.pipe < 0 or self.backend < 0:
            raise ValueError("fault pipe/backend must be >= 0")

    @property
    def active(self) -> bool:
        return self.kind != "none" and self.duration > 0

    @property
    def end(self) -> int:
        return self.start + self.duration


NO_FAULT = FaultSpec()


@dataclasses.dataclass
class FaultArrays:
    """Lowered per-step masks: ``server_up``/``lb_up`` are (P, S) bool,
    ``drain`` is (P,) bool.  The scenario runner concatenates these along
    the pipe axis exactly like the traces when it batches compile-compatible
    points."""

    server_up: np.ndarray
    lb_up: np.ndarray
    drain: np.ndarray

    @property
    def pipes(self) -> int:
        return self.server_up.shape[0]

    @property
    def steps(self) -> int:
        return self.server_up.shape[1]


def pipe_masks(fault: FaultSpec | None, pipe: int,
               steps: int) -> tuple[np.ndarray, np.ndarray, bool]:
    """Lower one fault event to the masks ONE pipe consumes.

    Returns ``(server_up (S,), lb_up (S,), drain)``.  ``lb`` faults are
    global (every pipe's LB instance watches the same backend machine);
    ``server`` faults hit only the named pipe.
    """
    fault = NO_FAULT if fault is None else fault
    s_up = np.ones(steps, bool)
    l_up = np.ones(steps, bool)
    lo, hi = fault.start, min(fault.end, steps)
    if fault.active and lo < hi:
        if fault.kind == "server" and fault.pipe == pipe:
            s_up[lo:hi] = False
        elif fault.kind == "lb":
            l_up[lo:hi] = False
    return s_up, l_up, bool(fault.drain)


def resolve(faults, pipes: int, steps: int) -> FaultArrays:
    """FaultSpec | FaultArrays | None -> validated FaultArrays."""
    if isinstance(faults, FaultArrays):
        if faults.pipes != pipes or faults.steps != steps:
            raise ValueError(
                f"fault masks shaped {faults.server_up.shape} do not match "
                f"(pipes={pipes}, steps={steps})")
        return faults
    rows = [pipe_masks(faults, p, steps) for p in range(pipes)]
    return FaultArrays(
        server_up=np.stack([r[0] for r in rows]),
        lb_up=np.stack([r[1] for r in rows]),
        drain=np.array([r[2] for r in rows], bool),
    )


def concat(arrays: list[FaultArrays]) -> FaultArrays:
    """Stack per-scenario masks along the pipe axis (runner batching)."""
    return FaultArrays(
        server_up=np.concatenate([a.server_up for a in arrays], axis=0),
        lb_up=np.concatenate([a.lb_up for a in arrays], axis=0),
        drain=np.concatenate([a.drain for a in arrays], axis=0),
    )
