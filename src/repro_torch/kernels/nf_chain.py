"""nf_chain on the card: CUDA kernel ``csrc/nf_chain.cu``.

The NF chain's whole header pass in one launch, one block per pipe: the
firewall's match (the device code of ``csrc/acl_match.cuh``), NAT's insert
walk and rewrite, the LB's selection (``csrc/maglev.cuh``) and the MAC
swap, stage after stage in chain order.  On the chain's path it stands for
the TPU kernels ``repro/kernels/acl_match/kernel.py::acl_match_kernel`` and
``repro/kernels/maglev/kernel.py::maglev_kernel``, and for the reference's
``lax.scan`` over NAT's packets.  Bound by bytes: each NAT table read and
written once, the header fields the stages read (``NF_READS``) read once
and those they write (``NF_WRITES``) written once, and the drops.

NAT's walk runs in waves of packets whose probe windows are disjoint
(``backend/ref.py::nat_waves`` is its schedule), 64 packets at a time,
over arrival-order chunks of ``NAT_WAVE_CHUNK`` packets.  The stages reach
the kernel as descriptors of ``DESC_WORDS`` int64 words (kind,
``DESC_PTRS`` device pointers, ``DESC_VALS`` constants), at most
``MAX_STAGES`` a launch; a longer chain runs as consecutive launches over
slices of it, each taking the last one's fields and drops.  A NAT table of
at most ``MAX_SHARED`` bytes (12 per slot) is walked in shared memory, a
larger one in device memory on the output copy.

``nf_chain_cuda`` launches the kernel and raises on CPU tensors;
``nf_chain`` is the ``auto`` entry, which takes the plain version
(``nf_chain_plain``) only because its tensors lie on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import trace
from repro_torch.backend.ref import (NAT_PROBE_DEPTH, NF_FIELDS, NF_KINDS,
                                     NF_WRITES, NatState)
from repro_torch.backend.ref import nf_chain as nf_chain_plain
from repro_torch.kernels.build import (check, launch_counter, library,
                                       require_cuda, stream_handle)

COUNT = launch_counter("nf_chain")

MAX_STAGES = 8       # kMaxStages in csrc/nf_chain.cu
DESC_PTRS = 8        # device pointers of a stage descriptor
DESC_VALS = 6        # constants of a stage descriptor
DESC_WORDS = 1 + DESC_PTRS + DESC_VALS
# dynamic shared memory for a staged NAT table: the block's 227 KB less
# the kernel's static shared memory (kStaticShared: the wave schedule of a
# chunk and a 1 KB rule tile), so capacities up to 17664 are staged
MAX_SHARED = 232448 - 20480

__all__ = ["COUNT", "MAX_STAGES", "nf_chain", "nf_chain_cuda",
           "nf_chain_plain"]


def _words(kind: str, ptrs=(), vals=()) -> list[int]:
    ptrs, vals = list(ptrs), list(vals)
    return ([NF_KINDS.index(kind)] + ptrs + [0] * (DESC_PTRS - len(ptrs))
            + vals + [0] * (DESC_VALS - len(vals)))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _stage(st, lead: tuple, keep: list):
    """(descriptor words, new state, shared bytes) of one stage; the
    tensors the descriptor points at are appended to ``keep``.  The words
    follow ``StageDesc`` in csrc/nf_chain.cu."""
    if st.kind == "fw":
        rules = st.state.rules
        if rules.dim() != 1:
            raise ValueError(f"nf_chain: fw rules must be (R,), got "
                             f"{tuple(rules.shape)}")
        rules = rules.to(torch.int32).contiguous()
        keep.append(rules)
        return _words("fw", [rules.data_ptr()], [rules.numel()]), st.state, 0
    if st.kind == "nat":
        c = st.consts
        cap = c.capacity
        if not NAT_PROBE_DEPTH <= cap < 1 << 31:
            raise ValueError(f"nf_chain: NAT capacity {cap} is outside "
                             f"[{NAT_PROBE_DEPTH}, 2**31)")
        ins = NatState(*(t.to(torch.int32).contiguous() for t in st.state))
        tables = (ins.key_ip, ins.key_port, ins.exp)
        if (any(tuple(t.shape) != (*lead, cap) for t in tables)
                or tuple(ins.stale_hits.shape) != lead):
            raise ValueError(
                f"nf_chain: NAT tables {[tuple(t.shape) for t in ins]} do "
                f"not match packets of leading shape {lead} and capacity "
                f"{cap}")
        outs = NatState(*(torch.empty_like(t) for t in ins))
        keep.extend(ins)
        staged = 12 * cap <= MAX_SHARED
        ptrs = [t.data_ptr() for t in (*tables, outs.key_ip, outs.key_port,
                                       outs.exp, ins.stale_hits,
                                       outs.stale_hits)]
        vals = [cap, c.base_port, c.max_exp, c.nat_ip, int(staged)]
        return (_words("nat", ptrs, vals), outs,
                12 * cap if staged else 0)
    if st.kind == "lb":
        lb = st.state
        if (lb.table.dim() != 1 or lb.backend_ips.dim() != 1
                or lb.table.numel() == 0):
            raise ValueError(f"nf_chain: lb needs a non-empty (T,) table "
                             f"and (NB,) backend_ips, got "
                             f"{tuple(lb.table.shape)} and "
                             f"{tuple(lb.backend_ips.shape)}")
        cols = [lb.table.to(torch.int32).contiguous(),
                lb.backend_ips.to(torch.int32).contiguous()]
        stride = 0
        if lb.up is not None:
            if tuple(lb.table_down.shape) != tuple(lb.table.shape):
                raise ValueError(f"nf_chain: degraded table "
                                 f"{tuple(lb.table_down.shape)} is not (T,)")
            if lb.up.dim() and tuple(lb.up.shape) != lead:
                raise ValueError(f"nf_chain: lb_up {tuple(lb.up.shape)} is "
                                 f"neither 0-d nor one flag per pipe {lead}")
            stride = 1 if lb.up.dim() else 0
            cols += [lb.table_down.to(torch.int32).contiguous(),
                     lb.up.to(torch.bool).contiguous()]
        else:
            cols += [None, None]
        keep.extend(c for c in cols if c is not None)
        return (_words("lb", [_ptr(c) for c in cols],
                       [lb.table.numel(), stride]), st.state, 0)
    if st.kind == "macswap":
        return _words("macswap"), st.state, 0
    raise ValueError(f"nf_chain: unknown stage kind {st.kind!r} "
                     f"(have {NF_KINDS})")


def _launch(fields, dropped, stages, dev):
    """One launch over at most ``MAX_STAGES`` stages.  A field that none
    of them writes is its own output: the kernel neither copies nor
    writes it, and the caller gets the tensor back as the plain version
    gives it."""
    shape = tuple(fields[0].shape)
    lead, b = shape[:-1], shape[-1]
    keep, words, states, smem = [], [], [], 0
    for st in stages:
        w, new, shared = _stage(st, lead, keep)
        words += w
        states.append(new)
        smem = max(smem, shared)
    written = {f for st in stages for f in NF_WRITES[st.kind]}
    out = [torch.empty_like(t) if f in written else t
           for f, t in zip(NF_FIELDS, fields)]
    drop_out = torch.empty(shape, dtype=torch.bool, device=dev)
    pipes = math.prod(lead)
    if pipes == 0:  # nothing to run: every output is empty
        return out, drop_out, states
    desc = (ctypes.c_int64 * max(len(words), 1))(*words)
    rc = library().pp_nf_chain(
        *(f.data_ptr() for f in fields), *(f.data_ptr() for f in out),
        _ptr(dropped), drop_out.data_ptr(), ctypes.addressof(desc),
        len(stages), pipes, b, smem, stream_handle(dev))
    check("nf_chain", rc)
    trace.count(COUNT)
    return out, drop_out, states


def nf_chain_cuda(fields: tuple, stages: tuple):
    """The ``NF_FIELDS`` header tensors (..., B) and ``Stage`` tuples on the
    card -> ``(fields, dropped, states)`` as ``nf_chain_plain`` returns
    them: new tensors for the fields the stages write and for the NAT
    tables, the others as they came in."""
    if len(fields) != len(NF_FIELDS):
        raise ValueError(f"nf_chain: {len(fields)} header fields, want "
                         f"{NF_FIELDS}")
    shape = tuple(fields[0].shape)
    if len(shape) == 0 or any(tuple(f.shape) != shape for f in fields):
        raise ValueError(f"nf_chain: header fields must share one (..., B) "
                         f"shape, got {[tuple(f.shape) for f in fields]}")
    state_tensors = [t for st in stages for t in st.state if t is not None]
    dev = require_cuda("nf_chain", *fields, *state_tensors)
    cur = [fields[0].to(torch.bool).contiguous()] + \
        [f.to(torch.int32).contiguous() for f in fields[1:]]
    dropped, states = None, []
    for lo in range(0, max(len(stages), 1), MAX_STAGES):
        cur, dropped, new = _launch(cur, dropped,
                                    stages[lo:lo + MAX_STAGES], dev)
        states += new
    return tuple(cur), dropped, tuple(states)


def nf_chain(fields: tuple, stages: tuple):
    fn = nf_chain_plain if fields[0].device.type == "cpu" else nf_chain_cuda
    return fn(fields, stages)
