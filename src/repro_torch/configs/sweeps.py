"""Run-shape presets for the scenario matrix (copy of
``repro.configs.sweeps``, kept in the port so the port imports nothing of
the reference).

A ``RunShape`` fixes the trace geometry every scenario in a sweep shares —
packet count, chunk (per-step packets), in-flight window and payload-buffer
capacity.  Two presets exist:

  * ``FULL`` — the paper-scale evaluation grid (nightly CI, local runs);
  * ``TINY`` — the CI smoke geometry, small enough that every benchmark
    finishes in seconds on a CPU runner while still exercising multi-chunk
    timelines (8 steps) and a non-degenerate recirculation lane.

Scenario factories (repro_torch.scenarios.matrix) take ``tiny: bool`` and pick
one of these, so "what does --tiny mean" is defined in exactly one place
instead of per-bench argument mangling.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RunShape:
    """Trace geometry shared by the scenarios of one sweep."""

    packets: int   # offered packets per scenario point
    chunk: int     # packets per engine step (must divide packets)
    window: int    # in-flight chunks between Split and Merge
    pmax: int      # PacketBatch payload-buffer capacity (bytes)

    def __post_init__(self):
        if self.packets % self.chunk:
            raise ValueError(
                f"packets ({self.packets}) must be a multiple of "
                f"chunk ({self.chunk})")

    @property
    def steps(self) -> int:
        return self.packets // self.chunk


FULL = RunShape(packets=16384, chunk=256, window=2, pmax=2048)
TINY = RunShape(packets=512, chunk=64, window=2, pmax=512)


def shape(tiny: bool) -> RunShape:
    return TINY if tiny else FULL
