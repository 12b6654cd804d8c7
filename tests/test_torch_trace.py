"""The port's span and counter recorder (``repro_torch.trace``) and the
engine's spans: nothing recorded or allocated with recording off; the span
tree of a ``run_pipes`` call (a root, ``setup``, one ``step`` a step with
its ``split`` / ``nf_chain`` / ``merge`` and, with the lane, two
``recirc``, then ``finish``); ``host_syncs`` against a hand count of the
sites that wait for the card; results bit-identical with recording on and
off; the kernels' launch counts as counters of the recorder."""
import dataclasses
import datetime
import tracemalloc
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import distributed as D  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.core.packet import map_fields  # noqa: E402
from repro_torch.core.park import ParkConfig  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.nf.chain import Chain  # noqa: E402
from repro_torch.nf.firewall import Firewall  # noqa: E402
from repro_torch.nf.maglev import MaglevLB  # noqa: E402
from repro_torch.nf.nat import Nat  # noqa: E402
from repro_torch.switchsim import engine as E  # noqa: E402
from repro_torch.switchsim.stream import run_stream  # noqa: E402
from repro_torch.switchsim.telemetry import TEL_FIELDS  # noqa: E402
from repro_torch.traffic.generator import enterprise, steer_pipes  # noqa: E402

PIPES, CHUNK, WINDOW, PMAX = 2, 32, 2, 512


@pytest.fixture(scope="module")
def traces():
    pkts = enterprise().make_batch(7, 512, pmax=PMAX, device="cpu")
    shards, _ = steer_pipes(pkts, PIPES, chunk=CHUNK)
    return map_fields(lambda n, a: a.reshape(
        (PIPES, a.shape[1] // CHUNK, CHUNK) + a.shape[2:]), shards)


def _rules(traces):
    return tuple(int(v) for v in torch.unique(traces.src_ip)[:5].tolist())


CHAINS = {
    "fw_nat": lambda rules: Chain((Firewall(rules=rules), Nat())),
    "fw_nat_lb": lambda rules: Chain((Firewall(rules=rules), Nat(),
                                      MaglevLB(backends=(1, 2, 3),
                                               table_size=13))),
    "fw": lambda rules: Chain((Firewall(rules=rules),)),
}
# NF-private counters each chain carries (one wait for the card each)
NF_COUNTERS = {"fw_nat": 1, "fw_nat_lb": 1, "fw": 0}


def _run(traces, chain="fw_nat", lane=False, **kw):
    cfg = ParkConfig(capacity=64, max_exp=2, pmax=PMAX, recirculation=lane,
                     recirc_frac=0.25)
    return E.run_pipes(cfg, CHAINS[chain](_rules(traces)), traces,
                       window=WINDOW, device="cpu", **kw)


def _same_result(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("merged", "sent", "state"):
            if x is None:
                assert y is None
                continue
            for g in dataclasses.fields(x):
                assert torch.equal(getattr(x, g.name), getattr(y, g.name)), \
                    (f.name, g.name)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        elif f.name in ("telemetry",):
            assert x.as_dict() == y.as_dict()
        elif f.name == "per_pipe_telemetry":
            assert [t.as_dict() for t in x] == [t.as_dict() for t in y]
        else:
            assert x == y, f.name


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

def test_recording_off_records_and_allocates_nothing(traces, monkeypatch):
    """Off, ``span`` hands back one shared no-op context: no span object is
    made during a whole ``run_pipes`` call, and a loop of spans allocates
    no memory."""
    assert trace.span("step") is trace.span("split")

    def no_span(*a):
        raise AssertionError("a span was made with recording off")

    monkeypatch.setattr(trace, "_Span", no_span)
    _run(traces, lane=True)
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("step"):
                with trace.span("split"):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename == trace.__file__]
    assert grown == []


def test_recording_hands_back_spans_counters_and_runs():
    with trace.recording() as rec:
        trace.count("test_trace.events", 3)
        with trace.span(trace.ROOT):
            with trace.span("setup"):
                pass
            with trace.span("step"):
                trace.count("test_trace.events")
        with trace.span("after"):
            pass
        with trace.span(trace.ROOT):
            pass
    assert rec.counters == {"test_trace.events": 4}
    assert rec.runs == 2
    assert [(s.name, s.parent, s.run) for s in rec.spans] == [
        ("run_pipes", -1, 0), ("setup", 0, 0), ("step", 0, 0),
        ("after", -1, -1), ("run_pipes", -1, 1)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert trace.span("x") is trace.span("y")        # off again
    with pytest.raises(RuntimeError, match="already open"):
        with trace.recording():
            with trace.recording():
                pass


def test_spans_stamp_the_profilers_clock():
    """Spans are stamped in ns since the Unix epoch, as the profiler's
    events are."""
    def epoch_ns():
        return int(datetime.datetime.now(datetime.timezone.utc)
                   .timestamp() * 1e9)

    t0 = epoch_ns()
    with trace.recording() as rec:
        with trace.span("x"):
            pass
    t1 = epoch_ns()
    s = rec.spans[0]
    assert t0 - 10**6 <= s.start_ns <= s.end_ns <= t1 + 10**6


# --------------------------------------------------------------------------
# the engine's spans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lane", (False, True), ids=("no_lane", "lane"))
def test_run_pipes_span_tree(traces, lane):
    steps = traces.src_ip.shape[1] + WINDOW + (1 if lane else 0)
    with trace.recording() as rec:
        _run(traces, lane=lane)
    spans = rec.spans
    assert rec.runs == 1 and all(s.run == 0 for s in spans)
    root = spans[0]
    assert (root.name, root.parent) == (trace.ROOT, -1)
    top = [s.name for s in spans if s.parent == 0]
    assert top == ["setup"] + ["step"] * steps + ["finish"]
    names = Counter(s.name for s in spans)
    assert names == Counter({trace.ROOT: 1, "setup": 1, "finish": 1,
                             "step": steps, "split": steps,
                             "nf_chain": steps, "merge": steps,
                             **({"recirc": 2 * steps} if lane else {})})
    step_ids = [i for i, s in enumerate(spans) if s.name == "step"]
    want = (["recirc", "split", "recirc"] if lane else ["split"]) + \
        ["nf_chain", "merge"]
    for i in step_ids:
        assert [s.name for s in spans if s.parent == i] == want
    # every span lies within its parent, and siblings in order
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    ends = [spans[i].end_ns for i in step_ids]
    assert ends == sorted(ends)


def test_run_stream_and_cycle_probes_have_their_spans(traces):
    """``run_stream`` steps through ``scan_step`` and gets its ``step``
    spans with no ``run_pipes`` root; each NF's cycle-cost probe is an
    ``nf_probe`` span."""
    from repro_torch.traffic.stream import MaterializedSource
    trace0 = map_fields(lambda n, a: a[0], traces)
    chain = CHAINS["fw_nat"](_rules(traces))
    cfg = ParkConfig(capacity=64, max_exp=2, pmax=PMAX)
    with trace.recording() as rec:
        run_stream(cfg, chain, MaterializedSource(trace0), window=WINDOW,
                   segment_len=4, device="cpu")
        chain.cycle_costs(device="cpu")
    names = Counter(s.name for s in rec.spans)
    assert rec.runs == 0
    assert names["step"] == trace0.src_ip.shape[0] + WINDOW
    assert names["split"] == names["merge"] == names["step"]
    assert names["nf_probe"] == 2
    assert all(s.run == -1 for s in rec.spans)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_host_syncs_count_every_wait_for_the_card(traces, chain):
    """One per tally brought to the host (the link telemetry's fields and
    the occupancy), one per NF-private counter, one for the switch's
    counters."""
    with trace.recording() as rec:
        _run(traces, chain=chain)
    want = len(TEL_FIELDS) + 1 + NF_COUNTERS[chain] + 1
    assert rec.counters["host_syncs"] == want == (
        13 if chain != "fw" else 12)


def test_host_syncs_of_a_sharded_run(traces):
    """With two shards each shard brings its own tallies and NF counters
    to the host; the switch's counters come once, gathered."""
    saved = D.forced_host_devices()
    D.force_host_devices(2)
    try:
        with trace.recording() as rec:
            res = _run(traces, devices=2)
    finally:
        D.force_host_devices(saved)
    assert rec.counters["host_syncs"] == 2 * (len(TEL_FIELDS) + 1 + 1) + 1
    assert Counter(s.name for s in rec.spans)["step"] == 2 * (
        traces.src_ip.shape[1] + WINDOW)
    _same_result(res, _run(traces))


@pytest.mark.parametrize("lane", (False, True), ids=("no_lane", "lane"))
def test_results_bit_identical_with_recording_on_and_off(traces, lane):
    off = _run(traces, lane=lane, collect_sent=True)
    with trace.recording():
        on = _run(traces, lane=lane, collect_sent=True)
    _same_result(on, off)


# --------------------------------------------------------------------------
# one counter registry
# --------------------------------------------------------------------------

def test_launch_counts_are_counters_of_the_recorder():
    from repro_torch.kernels import KERNELS, nf_chain
    assert sorted(launch_counts()) == sorted(KERNELS)
    assert trace.COUNTERS[nf_chain.COUNT] == launch_counts()["nf_chain"]
    trace.count(nf_chain.COUNT, 5)
    trace.count("host_syncs_probe_of_this_test", 2)
    try:
        assert launch_counts()["nf_chain"] >= 5
        reset_launch_counts()
        assert set(launch_counts().values()) == {0}
        assert trace.COUNTERS["host_syncs_probe_of_this_test"] == 2
    finally:
        del trace.COUNTERS["host_syncs_probe_of_this_test"]


def test_a_recording_sees_the_launch_counters_move():
    from repro_torch.kernels import split_control
    with trace.recording() as rec:
        trace.count(split_control.COUNT)
    assert rec.counters == {split_control.COUNT: 1}
