"""Device time and idle gaps put down to the engine's host spans.

``repro_torch.trace`` records the engine's phases as spans on the clock
that ``torch.profiler`` stamps its events with (CLOCK_REALTIME, ns since the
Unix epoch).  A span block is a run of scenario runs profiled with device
activity alone while the recorder is on (``trace_span_block``); from it:

* every device operation goes to a host phase: the outermost span under
  ``step`` (``recirc``, ``split``, ``nf_chain``, ``merge``) that was open
  when the host launched it (the CUDA runtime call the profiler links to
  it by correlation id), else the ``setup``, ``step``, ``finish`` or
  ``run_pipes`` span open then, else ``outside run_pipes`` (the harness's
  own work between runs).  An operation with no linked launch goes by the
  span open at its start (``device_by_layer``);
* every idle gap of the device within the block's wall is divided among
  the innermost spans open during it, in proportion to the overlap, and
  named by the span that held most of it and the operation that ended it
  (``idle_by_span``, ``idle_gaps``);
* the per-layer numbers (``metrics``): the host's time to issue a step,
  the idle inside steps and at a run's edges, the host's waits for the
  card a run, and each layer's device ms a step;
* the clock check (``clock_check``): each custom kernel's launches inside
  the span of the layer that issues it.

The block reads ``repro_torch.trace``; a program without it gives no
block (``trace_span_block`` returns None).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

OUTSIDE = "outside run_pipes"
ROOT = "run_pipes"
OUTER = ("step", "setup", "finish", ROOT)   # where an op outside a layer goes
LAYERS = ("recirc", "split", "nf_chain", "merge")
# each custom kernel and the spans that launch it (recirc_fn's retry Split
# launches split_control inside ``recirc``)
KERNEL_SPANS = {"split_control_kernel": ("split", "recirc"),
                "merge_stage_kernel": ("merge",),
                "nf_chain_kernel": ("nf_chain",)}


def now_ns() -> int:
    """The profiler's and the recorder's clock."""
    return time.clock_gettime_ns(time.CLOCK_REALTIME)


@dataclasses.dataclass
class SpanBlock:
    """A span block: the recorder's spans, the device operations as
    (start ns, end ns, launch ns or None, name), the block's wall on the
    same clock, the recorder's counter increments and the runs."""

    spans: list
    ops: list
    t0_ns: int
    t1_ns: int
    counters: dict
    runs: int

    @property
    def wall_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    @property
    def steps(self) -> int:
        return sum(s.name == "step" for s in self.spans)


def trace_span_block(run, n_traces: int, dev, runs: int):
    """Profile ``runs`` scenario runs with device activity alone while the
    recorder records spans; a ``SpanBlock``, or None for a program without
    the recorder."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import sync

    sync(dev)
    # without a card there is no device activity to profile
    with (profile(activities=[ProfilerActivity.CUDA]) if dev.type == "cuda"
          else contextlib.nullcontext()) as prof:
        with trace.recording() as rec:
            t0 = now_ns()
            for k in range(runs):
                run(k % n_traces)
            sync(dev)
            t1 = now_ns()
    launch, device = {}, []
    for e in prof.profiler.kineto_results.events() if prof else ():
        if e.device_type() == DeviceType.CUDA:
            device.append(e)
        elif e.correlation_id():
            launch[e.correlation_id()] = e.start_ns()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(),
            launch.get(e.correlation_id()), e.name()) for e in device]
    return SpanBlock(spans=rec.spans, ops=ops, t0_ns=t0, t1_ns=t1,
                     counters=rec.counters, runs=rec.runs)


# --------------------------------------------------------------------------
# the host's timeline
# --------------------------------------------------------------------------

def timeline(spans: list) -> tuple[list, list]:
    """The host's timeline cut wherever a span opens or closes: (the cuts,
    the innermost span open from each cut to the next, -1 for none)."""
    edges = []
    for i, s in enumerate(spans):
        edges.append((s.start_ns, 1, i))
        edges.append((s.end_ns, 0, -i))    # at a tie: inner spans close first
    edges.sort()
    cuts, inner, stack = [], [], []
    for t, opens, key in edges:
        if opens:
            stack.append(key)
        else:
            stack.remove(-key)
        top = stack[-1] if stack else -1
        if cuts and cuts[-1] == t:
            inner[-1] = top
        else:
            cuts.append(t)
            inner.append(top)
    return cuts, inner


def innermost_at(cuts: list, inner: list, t: int) -> int:
    k = bisect.bisect_right(cuts, t) - 1
    return inner[k] if k >= 0 else -1


def layers_of(spans: list) -> list:
    """For each span, the phase an operation launched inside it is put
    down to: the outermost span under a ``step``, else the nearest
    ``step``, ``setup``, ``finish`` or ``run_pipes``, else ``outside
    run_pipes``."""
    out = []
    for i in range(len(spans)):
        chain = []
        while i >= 0:
            chain.append(spans[i])
            i = spans[i].parent
        under_step = [s for s in chain if s.parent >= 0
                      and spans[s.parent].name == "step"]
        outer = [s for s in chain if s.name in OUTER]
        out.append(under_step[0].name if under_step
                   else outer[0].name if outer else OUTSIDE)
    return out


def in_steps_of(spans: list) -> list:
    """For each span, whether it is a ``step`` or lies inside one."""
    out = []
    for s in spans:
        out.append(s.name == "step" or (s.parent >= 0 and out[s.parent]))
    return out


# --------------------------------------------------------------------------
# what the block reads
# --------------------------------------------------------------------------

def device_by_layer(block: SpanBlock) -> dict:
    """Device seconds of the block's operations by the phase they are put
    down to (``layers_of``), by launch time where the launch is linked."""
    cuts, inner = timeline(block.spans)
    layer = layers_of(block.spans)
    out: dict = {}
    for s, e, launch, _ in block.ops:
        i = innermost_at(cuts, inner, s if launch is None else launch)
        name = layer[i] if i >= 0 else OUTSIDE
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def busy_intervals(block: SpanBlock) -> list:
    """The union of the device's operations within the block's wall, as
    sorted disjoint (start ns, end ns, name of the op that opened it)."""
    out = []
    for s, e, _, name in sorted(block.ops):
        s, e = max(s, block.t0_ns), min(e, block.t1_ns)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, name])
    return out


def gaps(block: SpanBlock) -> list:
    """The device's idle gaps within the block's wall: (start ns, end ns,
    the op that ended it, or None for the block's end)."""
    out, end = [], block.t0_ns
    for s, e, name in busy_intervals(block):
        if s > end:
            out.append((end, s, name))
        end = e
    if block.t1_ns > end:
        out.append((end, block.t1_ns, None))
    return out


def _overlaps(cuts, inner, a, b):
    """(innermost span, ns) over the host's timeline from a to b."""
    k = max(bisect.bisect_right(cuts, a) - 1, 0)
    if not cuts or a < cuts[0]:
        yield -1, min(b, cuts[0] if cuts else b) - a
    while k < len(cuts) and cuts[k] < b:
        lo = max(a, cuts[k])
        hi = min(b, cuts[k + 1]) if k + 1 < len(cuts) else b
        if hi > lo:
            yield inner[k], hi - lo
        k += 1


def idle_by_span(block: SpanBlock) -> dict:
    """The block's idle seconds by the innermost span open during them
    (``-1``: none, the harness between runs), each gap divided by
    overlap."""
    cuts, inner = timeline(block.spans)
    out: dict = {}
    for a, b, _ in gaps(block):
        for i, ns in _overlaps(cuts, inner, a, b):
            out[i] = out.get(i, 0.0) + ns / 1e9
    return out


def idle_gaps(block: SpanBlock, top: int = 10) -> list:
    """The ``top`` largest sums of idle seconds by label: the span that
    held most of a gap (its name, or ``outside run_pipes``), then ``before
    <op>`` for the operation that ended it."""
    cuts, inner = timeline(block.spans)
    by_label: dict = {}
    for a, b, op in gaps(block):
        held: dict = {}
        for i, ns in _overlaps(cuts, inner, a, b):
            held[i] = held.get(i, 0) + ns
        i = max(held, key=held.get)
        label = (block.spans[i].name if i >= 0 else OUTSIDE) + (
            f" before {op[:100]}" if op else " at the block's end")
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in by_label.items()),
                  key=lambda kv: -kv[1])[:top]


def idle_split(block: SpanBlock) -> tuple[float, float]:
    """Idle seconds (inside steps, at the edges: ``setup``, ``finish``,
    the root and outside ``run_pipes``)."""
    in_steps = in_steps_of(block.spans)
    steps = edges = 0.0
    for i, sec in idle_by_span(block).items():
        if i >= 0 and in_steps[i]:
            steps += sec
        else:
            edges += sec
    return steps, edges


def host_ms_per_run(block: SpanBlock) -> dict:
    """Host milliseconds a run in each span name (nested spans counted in
    each of theirs)."""
    out: dict = {}
    for s in block.spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return {k: v / max(block.runs, 1) for k, v in out.items()}


def metrics(block: SpanBlock) -> dict:
    """The per-layer numbers of a span block, by the names a harness
    would print them under."""
    steps = [s.end_ns - s.start_ns for s in block.spans if s.name == "step"]
    if not steps or not block.ops:
        return {}
    wall = block.wall_s
    in_steps, at_edges = idle_split(block)
    dev = device_by_layer(block)
    out = {"host.step_issue_ms": sum(steps) / len(steps) / 1e6,
           "device.idle_in_steps_pct": 100.0 * in_steps / wall,
           "device.idle_at_edges_pct": 100.0 * at_edges / wall,
           "engine.host_syncs_per_run":
               block.counters.get("host_syncs", 0) / block.runs}
    for name in LAYERS:
        if name in dev:
            out[f"{name}.device_ms_per_step"] = 1e3 * dev[name] / len(steps)
    return out


def idle_pct(block: SpanBlock) -> float:
    """The block's own idle share: 100 x (1 - device busy / wall)."""
    busy = sum(e - s for s, e, _ in busy_intervals(block)) / 1e9
    return 100.0 * (1.0 - busy / block.wall_s)


def clock_check(block: SpanBlock) -> dict:
    """For each custom kernel: its launches, the share of them that fall
    inside a span that issues it, and the least distance (ns) from such a
    launch to its span's start and to its span's end: the two clocks'
    offset lies within (-to_start, +to_end)."""
    from portbench.harness import base_name

    cuts, inner = timeline(block.spans)
    out = {}
    for kernel, names in KERNEL_SPANS.items():
        inside, n, to_start, to_end = 0, 0, None, None
        for _, _, launch, op in block.ops:
            if launch is None or base_name(op) != kernel:
                continue
            n += 1
            i = innermost_at(cuts, inner, launch)
            while i >= 0 and block.spans[i].name not in names:
                i = block.spans[i].parent
            if i < 0:
                continue
            inside += 1
            s = block.spans[i]
            d0, d1 = launch - s.start_ns, s.end_ns - launch
            to_start = d0 if to_start is None else min(to_start, d0)
            to_end = d1 if to_end is None else min(to_end, d1)
        out[kernel] = dict(launches=n, inside_share=inside / n if n else None,
                           to_start_ns=to_start, to_end_ns=to_end)
    return out
