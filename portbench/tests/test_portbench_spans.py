"""``portbench.spans`` on a synthetic span block: device operations go to
the outermost span under ``step`` open at their launch, an idle gap is
divided among the spans it overlaps, the idle inside steps and at the
edges add up to the block's idle share, the gaps are named by span; and on
the CPU a real span block of the engine holds its spans and no device
event."""
from __future__ import annotations

import pytest
import torch

from portbench import spans as S
from repro_torch.trace import Span

# one run (ns): setup 0-10, a step 10-60 (split 15-30 with a nested span
# 18-22, nf_chain 30-40, merge 40-55), finish 60-100; the harness then
# works outside run_pipes until the block ends at 120
SPANS = [Span("run_pipes", -1, 0, 100, 0),      # 0
         Span("setup", 0, 0, 10, 0),            # 1
         Span("step", 0, 10, 60, 0),            # 2
         Span("split", 2, 15, 30, 0),           # 3
         Span("inner", 3, 18, 22, 0),           # 4
         Span("nf_chain", 2, 30, 40, 0),        # 5
         Span("merge", 2, 40, 55, 0),           # 6
         Span("finish", 0, 60, 100, 0)]         # 7


def block(ops, t0=0, t1=120, counters=None):
    return S.SpanBlock(spans=SPANS, ops=ops, t0_ns=t0, t1_ns=t1,
                       counters=counters or {}, runs=1)


def test_a_device_op_goes_to_the_outermost_span_under_step_at_its_launch():
    b = block([(20, 45, 19, "a split kernel"),       # launched in inner
               (45, 50, 12, "a tally"),              # in step, no layer
               (50, 52, 35, "nf_chain_kernel"),
               (52, 58, 41, "merge_stage_kernel"),
               (62, 64, 61, "Memcpy DtoH"),
               (1, 2, 5, "Memcpy HtoD"),
               (110, 112, None, "no launch linked"),  # by its start
               (70, 71, None, "no launch, in finish")])
    got = S.device_by_layer(b)
    assert got == pytest.approx({"split": 25e-9, "step": 5e-9,
                                 "nf_chain": 2e-9, "merge": 6e-9,
                                 "finish": 3e-9, "setup": 1e-9,
                                 S.OUTSIDE: 2e-9})
    assert sum(got.values()) == pytest.approx(
        sum(e - s for s, e, _, _ in b.ops) / 1e9)


def test_an_idle_gap_over_two_spans_is_split_by_overlap():
    # busy 0-45 and 65-120: one gap 45-65 over merge (45-55), the step
    # outside its layers (55-60) and finish (60-65)
    b = block([(0, 45, 1, "x"), (65, 120, 101, "y")])
    assert S.gaps(b) == [(45, 65, "y")]
    idle = S.idle_by_span(b)
    assert idle == pytest.approx({6: 10e-9, 2: 5e-9, 7: 5e-9})
    assert S.idle_gaps(b) == [["merge before y", pytest.approx(20e-9)]]


def test_idle_in_steps_and_at_edges_add_up_to_the_blocks_idle_share():
    b = block([(3, 8, 2, "h2d"), (16, 26, 15, "split"), (33, 36, 31, "nf"),
               (44, 50, 41, "merge"), (66, 70, 62, "d2h")],
              counters={"host_syncs": 13})
    in_steps, at_edges = S.idle_split(b)
    # steps: 10-16, 26-33, 36-44, 50-60; edges: 0-3, 8-10, 60-66, 70-120
    assert in_steps == pytest.approx(31e-9)
    assert at_edges == pytest.approx(61e-9)
    m = S.metrics(b)
    assert m["device.idle_in_steps_pct"] + m["device.idle_at_edges_pct"] == \
        pytest.approx(S.idle_pct(b))
    assert S.idle_pct(b) == pytest.approx(100 * 92 / 120)
    assert m["host.step_issue_ms"] == pytest.approx(50e-6)
    assert m["engine.host_syncs_per_run"] == 13
    assert m["split.device_ms_per_step"] == pytest.approx(10e-6)
    assert "recirc.device_ms_per_step" not in m
    # the last gap, 70-120, lies 30 ns in finish and 20 ns outside
    labels = [label for label, _ in S.idle_gaps(b)]
    assert labels[0] == "finish at the block's end"
    assert all(label.split(" before ")[0] in {s.name for s in SPANS}
               | {S.OUTSIDE} for label in labels[1:])


def test_ops_past_the_blocks_wall_are_clipped():
    b = block([(-10, 5, None, "before"), (115, 130, 110, "after")])
    assert S.busy_intervals(b) == [[0, 5, "before"], [115, 120, "after"]]
    assert S.idle_pct(b) == pytest.approx(100 * 110 / 120)


def test_clock_check_finds_each_kernels_launches_in_its_spans():
    b = block([(20, 21, 16, "void split_control_kernel<4>(int*)"),
               (22, 23, 29, "split_control_kernel(int*)"),
               (31, 32, 33, "nf_chain_kernel"),
               (41, 42, 44, "merge_stage_kernel"),
               (61, 62, 58, "merge_stage_kernel")])   # outside merge
    got = S.clock_check(b)
    assert got["split_control_kernel"] == dict(
        launches=2, inside_share=1.0, to_start_ns=1, to_end_ns=1)
    assert got["nf_chain_kernel"]["inside_share"] == 1.0
    assert got["merge_stage_kernel"] == dict(
        launches=2, inside_share=0.5, to_start_ns=4, to_end_ns=11)


def test_a_span_block_of_the_engine_on_the_cpu():
    """The block records the engine's spans and counters; without a card
    the profiler holds no device event, so nothing is read."""
    from portbench import generator, harness
    from portbench.tests.fixtures import tiny, tiny_mix
    from repro_torch.core.packet import PacketBatch
    from repro_torch.switchsim.engine import run_pipes

    config, mix = tiny("pod_chain_dc"), tiny_mix("datacenter")
    dev = torch.device("cpu")
    traces, rules = generator.draw(config, mix, 2**31 + 7, dev)
    cfg, chain = harness.build_program(config, mix, rules)
    batches = [PacketBatch(**t) for t in traces]

    def run(i):
        return run_pipes(cfg, chain, batches[i], window=config["window"],
                         device=dev)

    b = S.trace_span_block(run, len(batches), dev, 2)
    assert b.runs == 2 and b.counters["host_syncs"] == 26
    assert b.steps == 2 * (mix["steps"] + config["window"] + 1)
    assert [s.name for s in b.spans if s.parent == -1] == ["run_pipes"] * 2
    assert b.t0_ns <= b.spans[0].start_ns <= b.spans[-1].end_ns <= b.t1_ns
    assert b.ops == [] and S.metrics(b) == {}
