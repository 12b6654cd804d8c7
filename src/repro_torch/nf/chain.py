"""NF chain composition and the Explicit-Drop integration point (port of
``repro.nf.chain``; paper §1 "FW-NAT", §6.2.4, §7 "FW-NAT-LB").

A chain is an ordered tuple of NFs (``Firewall``, ``Nat``, ``MaglevLB``,
``MacSwap``), each touching headers only.  ``run`` turns each NF and its
state into a stage (``nf.stage(state, ctx)``: kind, state tensors,
constants) and makes one ``nf_chain`` dispatch for the whole chain: the
plain version (``backend/ref.py::nf_chain``) on CPU tensors, one launch of
the CUDA kernel ``csrc/nf_chain.cu`` on the card.  Each NF called alone
(``NF.__call__``: ``(state, pkts) -> (state, pkts, drop_mask, cycles)``)
runs a one-stage chain, so there is one code path per NF.  The cycle
costs are added on the host.  ``to_explicit_drops`` turns chain-dropped,
parked packets into truncated OP=drop notifications so Merge frees their
slots at once.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import trace
from repro_torch.backend.ref import NF_FIELDS
from repro_torch.backend.registry import dispatch
from repro_torch.core.packet import OP_DROP, PacketBatch, dead_batch
from repro_torch.device import DEFAULT_DEVICE


class NF:
    """What the four NFs share: calling one runs it as a one-stage chain,
    and a stateless NF keeps its state.  Each NF also gives ``stage(state,
    ctx)``, its ``nf_chain`` stage, and ``cycles_of(state)``, its CPU cycle
    cost per packet."""

    def next_state(self, state, new):
        """The NF's state after ``nf_chain`` returned ``new`` for it."""
        return state

    def __call__(self, state, pkts: PacketBatch, backend=None, ctx=None):
        """``(state, pkts) -> (state, pkts, drop_mask, cycles)``."""
        (state,), out, drop, cycles = Chain((self,)).run(
            (state,), pkts, backend=backend, ctx=ctx)
        return state, out, drop, cycles


@dataclasses.dataclass(frozen=True)
class Chain:
    nfs: tuple  # NF dataclasses (Firewall, Nat, MaglevLB, MacSwap)

    def init_state(self, device=DEFAULT_DEVICE,
                   pipes: int | None = None) -> tuple:
        return tuple(nf.init_state(device, pipes) for nf in self.nfs)

    def stages(self, states: tuple, ctx=None) -> tuple:
        """The ``nf_chain`` stages of the NFs with these states."""
        return tuple(nf.stage(st, ctx) for nf, st in zip(self.nfs, states))

    def run(self, states: tuple, pkts: PacketBatch, backend=None, ctx=None):
        """Returns (new_states, pkts_out, dropped_by_chain, total_cycles).
        ``backend`` selects the ``nf_chain`` implementation; the
        fault-injection ``ctx`` dict reaches every NF's stage."""
        fields, dropped, new = dispatch("nf_chain", backend)(
            tuple(getattr(pkts, f) for f in NF_FIELDS),
            self.stages(states, ctx))
        total_cycles = 0.0
        new_states = []
        for nf, st, s in zip(self.nfs, states, new):
            total_cycles += nf.cycles_of(st)
            new_states.append(nf.next_state(st, s))
        out = pkts.replace(**dict(zip(NF_FIELDS, fields)))
        return tuple(new_states), out, dropped, total_cycles

    def state_counters(self, states: tuple) -> dict:
        """The NF-private counters carried in chain state (e.g. NAT's
        ``nat_stale_hits``), as a flat name -> tensor dict."""
        out: dict = {}
        for nf, st in zip(self.nfs, states):
            fn = getattr(nf, "state_counters", None)
            if fn is None:
                continue
            for name, val in fn(st).items():
                if name in out:
                    raise ValueError(f"duplicate NF counter {name!r}")
                out[name] = val
        return out

    def cycle_costs(self, backend=None,
                    device=DEFAULT_DEVICE) -> tuple[float, ...]:
        """Per-NF CPU cycle costs in chain order, probed by running each NF
        on one dead packet through the same backend dispatch (each probe
        an ``nf_probe`` span of the recorder, ``repro_torch.trace``)."""
        probe = dead_batch(1, 16, device=device)
        costs = []
        for nf in self.nfs:
            with trace.span("nf_probe"):
                _, _, _, cycles = nf(nf.init_state(device), probe,
                                     backend=backend)
            costs.append(float(cycles))
        return tuple(costs)


def to_explicit_drops(pkts: PacketBatch, dropped) -> PacketBatch:
    """Convert chain-dropped, parked packets into OP=drop notifications
    (paper §6.2.4: change the opcode, truncate the payload, send back)."""
    notify = dropped & pkts.pp_valid & (pkts.pp_enb == 1)
    return pkts.replace(
        alive=pkts.alive | notify,
        payload_len=torch.where(notify, 0, pkts.payload_len).to(torch.int32),
        payload=torch.where(notify[..., None], 0,
                            pkts.payload).to(torch.uint8),
        pp_op=torch.where(notify, OP_DROP, pkts.pp_op).to(torch.int32),
    )
