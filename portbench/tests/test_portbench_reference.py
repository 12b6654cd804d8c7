"""The plain reference against the port's plain engine, bit for bit; the
control (NAT's walk read from a stale table) against the reference; the
roofline counts against the table size."""
from __future__ import annotations

import pytest
import torch

from portbench import generator, harness, roofline
from portbench.reference import dataplane as ref
from portbench.tests.fixtures import tiny, tiny_mix

CASES = (("pod_fw_nat", "enterprise"), ("pod_chain_dc", "datacenter"))


def _draw(config_name, mix_name, seed=2**31 + 11, **over):
    config, mix = tiny(config_name, **over), tiny_mix(mix_name)
    traces, rules = generator.draw(config, mix, seed, "cpu")
    return config, mix, traces, rules


def _program(config, mix, rules, trace):
    from repro_torch.core.packet import PacketBatch
    from repro_torch.switchsim.engine import run_pipes

    cfg, chain = harness.build_program(config, mix, rules)
    return run_pipes(cfg, chain, PacketBatch(**trace),
                     window=config["window"], backend="ref", device="cpu")


@pytest.mark.parametrize("config_name,mix_name", CASES)
def test_reference_matches_port_engine(config_name, mix_name):
    config, mix, traces, rules = _draw(config_name, mix_name)
    sw, chain = harness.build_reference(config, mix, rules)
    for trace in traces:
        res = _program(config, mix, rules, trace)
        got = harness.diff(harness.program_output(res),
                           ref.run(sw, chain, trace))
        assert got == dict.fromkeys(harness.CHECK_NAMES, 0)
        # the traffic exercises what the cell's layers do
        c = res.counters
        assert c["splits"] and c["merges"] and c["skip_small_payload"]
        assert c["skip_occupied"]
        assert res.telemetry.from_server_pkts < res.telemetry.to_server_pkts
        if config["recirculation"]:
            assert c["recirculations"] and c["recirc_budget_drops"]


@pytest.mark.parametrize("config_name,mix_name", CASES)
def test_control_breaks_the_comparison(config_name, mix_name):
    """The control (every packet of a NAT call reads the table as the call
    found it) is not correct."""
    config, mix, traces, rules = _draw(config_name, mix_name)
    sw, chain = harness.build_reference(config, mix, rules)
    res = _program(config, mix, rules, traces[0])
    want = ref.run(sw, chain, traces[0])
    assert not any(harness.diff(harness.program_output(res), want).values())
    control = ref.run(sw, chain, traces[0], sequential_nat=False)
    got = harness.diff(control, want)
    assert got["merged_rows_wrong"] > 0


@pytest.mark.parametrize("config_name,mix_name", CASES)
def test_roofline_counts_do_not_depend_on_table_size(config_name, mix_name):
    """Packets that fare the same in a 1024-row and a 4096-row table are
    counted the same work."""
    needs = []
    for capacity in (1024, 4096):
        config, mix, traces, rules = _draw(
            config_name, mix_name, capacity=capacity, nat_capacity=4096)
        res = _program(config, mix, rules, traces[0])
        assert res.state.meta_exp.shape[-1] == capacity
        t = res.telemetry.as_dict()
        needs.append((roofline.split_need(res.counters, t),
                      roofline.merge_need(res.counters, t),
                      roofline.nf_chain_need(t, config["chain"],
                                             config["fw_rules"])))
    assert needs[0] == needs[1]
    assert all(b > 0 for b, _ in needs[0])


@pytest.mark.parametrize("config_name,mix_name", CASES)
def test_payload_bytes_equal_what_the_stages_moved(monkeypatch, config_name,
                                                   mix_name):
    """The parked and restored payload bytes that the roofline reads from
    the link telemetry equal the bytes each stage took from or gave back
    to its packets, summed at the stages themselves."""
    from repro_torch.switchsim import engine

    moved = dict(parked=0, restored=0)

    def watch(name, kind, sign):
        real = getattr(engine, name)

        def stage(cfg, state, pkts, backend=None):
            state, out = real(cfg, state, pkts, backend=backend)
            kept = pkts.alive & out.alive
            moved[kind] += sign * int(torch.where(
                kept, out.payload_len - pkts.payload_len, 0).sum())
            return state, out
        monkeypatch.setattr(engine, name, stage)

    watch("split_fn", "parked", -1)
    watch("recirc_fn", "parked", -1)
    watch("merge_fn", "restored", 1)
    config, mix, traces, rules = _draw(config_name, mix_name)
    res = _program(config, mix, rules, traces[0])
    t = res.telemetry.as_dict()
    c = res.counters
    assert c["explicit_drops"] + c["premature_evictions"] \
        + c["crc_failures"] == 0
    assert moved["parked"] > 0 and moved["restored"] > 0
    assert roofline.parked_bytes(t) == moved["parked"]
    assert roofline.restored_bytes(t) == moved["restored"]
    if config["recirculation"]:
        # continuations append past a first pass's 160 B
        assert moved["parked"] > 160 * c["splits"]


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_exact_counts_sum_to_the_packets():
    for probs in ([0.10, 0.12, 0.08, 0.12, 0.18, 0.40],
                  [0.35, 0.10, 0.05, 0.05, 0.10, 0.35]):
        counts = generator.exact_counts(probs, 2560)
        assert sum(counts) == 2560
        assert all(abs(c - p * 2560) < 1 for c, p in zip(counts, probs))


def test_seed_fixes_the_traces_and_only_reorders_sizes():
    config, mix = tiny("pod_fw_nat"), tiny_mix("enterprise")
    a, rules_a = generator.draw(config, mix, 2**33 + 1, "cpu")
    b, rules_b = generator.draw(config, mix, 2**33 + 1, "cpu")
    c, _ = generator.draw(config, mix, 2**33 + 2, "cpu")
    assert rules_a == rules_b
    for n in ref.FIELDS:
        assert torch.equal(a[0][n], b[0][n])
    assert not torch.equal(a[0]["payload_len"], c[0]["payload_len"])
    for x, y in ((a[0], c[0]), (a[0], a[1])):
        for p in range(config["pipes"]):
            assert torch.equal(x["payload_len"][p].flatten().sort().values,
                               y["payload_len"][p].flatten().sort().values)
