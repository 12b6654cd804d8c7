"""In-memory spans and counters of the port's own phases.

The engine marks its phases with ``span(name)`` (``switchsim/engine.py``:
``run_pipes``, ``setup``, ``step`` and, inside a step, ``recirc``,
``split``, ``nf_chain`` and ``merge``, then ``finish``) and counts events
with ``count(name, n)``: the kernel launches (``launches.<kernel>``,
``kernels/build.py``) and the host's waits for the card (``host_syncs``).

* Counters are always on: a plain int add into ``COUNTERS``.
* Spans are recorded only inside ``recording()``.  Outside it ``span``
  returns one shared no-op context and allocates nothing, so the marks cost
  a function call when nobody records.
* A span is stamped on the clock that ``torch.profiler`` stamps its events
  with (CLOCK_REALTIME, ns since the Unix epoch), so a device trace taken
  while spans record can put each device operation down to the host phase
  that launched it and each idle gap to what the host was doing.  Nothing
  reads the clock for any other purpose: no result depends on it.

Spans are kept in memory and handed back when ``recording()`` exits; there
is no file exporter.  One thread records at a time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["COUNTERS", "ROOT", "Recording", "Span", "count", "recording",
           "span"]

COUNTERS: dict[str, int] = {}
ROOT = "run_pipes"     # a span of this name opens a new run


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded span: ``parent`` is the index of the enclosing span in
    the recording (-1 for none) and ``run`` the ordinal of the enclosing
    ``run_pipes`` call within the recording (-1 outside any)."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    run: int


@dataclasses.dataclass
class Recording:
    """What a ``recording()`` block recorded: its spans in the order they
    opened, the counters' increments and the ``run_pipes`` calls."""

    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    runs: int = 0
    _open: list = dataclasses.field(default_factory=list)   # [rec, ...]
    _stack: list = dataclasses.field(default_factory=list)  # span indices


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_REC: Recording | None = None


class _Span:
    __slots__ = ("rec", "name")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        parent = stack[-1] if stack else -1
        if self.name == ROOT:
            run = rec.runs
            rec.runs += 1
        else:
            run = rec._open[parent][4] if stack else -1
        stack.append(len(rec._open))
        rec._open.append([self.name, parent,
                          time.clock_gettime_ns(time.CLOCK_REALTIME), 0, run])
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec._open[rec._stack.pop()][3] = time.clock_gettime_ns(
            time.CLOCK_REALTIME)
        return False


def span(name: str):
    """A context manager marking one phase of the host's work."""
    rec = _REC
    return _NO_SPAN if rec is None else _Span(rec, name)


@contextlib.contextmanager
def recording():
    """Record spans while the block runs.  Yields a ``Recording`` that is
    filled when the block exits: its spans, each counter's increment over
    the block, and the number of ``run_pipes`` calls."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    before = dict(COUNTERS)
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None
        rec.spans = [Span(*r) for r in rec._open]
        rec.counters = {k: v - before.get(k, 0) for k, v in COUNTERS.items()
                        if v != before.get(k, 0)}
        rec._open, rec._stack = [], []
