"""The port's scenario matrix against the reference: family expansion, spec
checks, the runner on the reference's own prepared points (bit-identical
results), batching, the oracle, and the host-model and resource copies."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.scenarios as JS  # noqa: E402
from repro.core.park import ParkConfig as JParkConfig  # noqa: E402
from repro.hostmodel import nic as JNic  # noqa: E402
from repro.hostmodel import pcie as JPcie  # noqa: E402
from repro.hostmodel import server as JServer  # noqa: E402
from repro.switchsim import faults as JF  # noqa: E402
from repro.switchsim import resources as JRes  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.configs import sweeps as TSweeps  # noqa: E402
from repro_torch.core.packet import to_time_major  # noqa: E402
from repro_torch.core.park import ParkConfig as TParkConfig  # noqa: E402
from repro_torch.hostmodel import nic as TNic  # noqa: E402
from repro_torch.hostmodel import pcie as TPcie  # noqa: E402
from repro_torch.hostmodel import server as TServer  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.switchsim import engine as TE  # noqa: E402
from repro_torch.switchsim import faults as TF  # noqa: E402
from repro_torch.switchsim import resources as TRes  # noqa: E402
from repro_torch.switchsim.telemetry import LinkTelemetry as TTel  # noqa: E402
from repro_torch.traffic import generator as TG  # noqa: E402

FAMILIES = ("pipeline", "recirc", "hostmodel_sizes", "hostmodel_servers",
            "chain", "adversarial")
MINI = dict(name="m", packets=128, chunk=32, capacity=64, pmax=512)


def _fields(spec) -> dict:
    d = spec.as_dict()
    d.pop("backend")
    return d


@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("fam", FAMILIES)
def test_family_expands_like_reference(fam, tiny):
    want, got = JS.family(fam, tiny=tiny), TS.family(fam, tiny=tiny)
    assert [s.name for s in got] == [s.name for s in want]
    assert [_fields(s) for s in got] == [_fields(s) for s in want]
    assert all(s.backend == "auto" for s in got)


def test_registry_and_shapes_match_reference():
    assert set(TS.names()) == set(JS.names())
    from repro.configs import sweeps as JSweeps
    for tiny in (True, False):
        assert dataclasses.asdict(TSweeps.shape(tiny)) == \
            dataclasses.asdict(JSweeps.shape(tiny))
    with pytest.raises(KeyError, match="chain"):
        TS.family("bogus")


BAD_SPECS = {
    "packets_not_multiple_of_chunk": dict(packets=100),
    "unknown_workload": dict(workload=("bogus",)),
    "unknown_nf": dict(chain=("fw", "bogus")),
    "no_pipes": dict(pipes=0),
    "no_devices": dict(devices=0),
    "rules_cover_pool": dict(flows=16, fw_rules=20),
    "nat_capacity_without_nat": dict(chain=("fw",), nat_capacity=64),
    "unknown_backend": dict(backend="bogus"),
    "lb_fault_without_lb": dict(fault=dict(kind="lb", duration=2)),
    "flows_with_adversarial": dict(
        flows=16, workload=("adversarial", "enterprise", 0.5, 4)),
    "flows_with_churn": dict(flows=16, workload=("churn", 64, 128)),
    "attack_fraction_past_one": dict(
        workload=("adversarial", "enterprise", 1.5, 4)),
    "churn_pool_of_one": dict(workload=("churn", 1, 128)),
    "fault_past_trace": dict(fault=dict(kind="server", start=3,
                                        duration=2)),
    "fault_pipe_out_of_range": dict(pipes=2, fault=dict(kind="server",
                                                        pipe=2, duration=1)),
}


def _spec(pkg, **kw):
    if isinstance(kw.get("fault"), dict):
        kw["fault"] = (JF if pkg is JS else TF).FaultSpec(**kw["fault"])
    return pkg.ScenarioSpec(**{**MINI, **kw})


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_checks_raise_where_the_reference_does(case):
    with pytest.raises(ValueError):
        _spec(JS, **BAD_SPECS[case])
    with pytest.raises(ValueError):
        _spec(TS, **BAD_SPECS[case])


@pytest.mark.parametrize("kw", [
    dict(devices=2),
], ids=["devices"])
def test_later_slices_raise(kw):
    # the reference takes them, and since the fabric slice so does the port
    assert _fields(_spec(TS, **kw)) == _fields(_spec(JS, **kw))


@pytest.mark.parametrize("kw", [
    dict(workload=("adversarial", "enterprise", 0.5, 4)),
    dict(workload=("adversarial", "datacenter", 0.25, 32)),
    dict(workload=("churn", 64, 128)),
], ids=["adversarial", "adversarial_datacenter", "churn"])
def test_adversarial_and_churn_specs_match_reference(kw):
    assert _fields(_spec(TS, **kw)) == _fields(_spec(JS, **kw))
    want = JS.resolve_workload(kw["workload"])
    got = TS.resolve_workload(kw["workload"])
    assert got.name == want.name
    assert np.array_equal(got.sizes, want.sizes)
    assert np.array_equal(got.probs, want.probs)


def test_good_specs_pass_both_checks():
    for kw in (dict(), dict(flows=32, chain=("fw", "nat", "lb")),
               dict(chain=("fw", "nat", "lb"),
                    fault=dict(kind="lb", backend=3, start=1, duration=2)),
               dict(pipes=2, fault=dict(kind="server", pipe=1, duration=1))):
        assert _fields(_spec(TS, **kw)) == _fields(_spec(JS, **kw))


def test_make_packets_is_seeded_and_flow_constrained():
    spec = _spec(TS, flows=32)
    a, b = TS.make_packets(spec), TS.make_packets(spec)
    for k, v in CV.as_numpy(a).items():
        assert np.array_equal(v, CV.as_numpy(b)[k]), k
    assert torch.unique(a.src_ip).numel() <= 32
    # recirc on/off pairs compare the same offered packets
    c = TS.make_packets(_spec(TS, flows=32, recirc=True, capacity=32))
    assert torch.equal(a.payload, c.payload)
    ips, _ = TG.flow_pool(32, device="cpu")
    rules = TS.spec.firewall_rules(_spec(TS, flows=32, fw_rules=3), a)
    assert rules == tuple(ips[:3].tolist())


# --------------------------------------------------------------------------
# the runner on the reference's prepared points
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_results():
    return {fam: JS.run_matrix(JS.family(fam, tiny=True))
            for fam in ("chain", "recirc")}


def _assert_same_point(j, t):
    assert t.spec.name == j.spec.name
    assert t.counters == j.counters
    assert t.telemetry.as_dict() == j.telemetry.as_dict()
    assert t.per_pipe_counters == j.per_pipe_counters
    assert [x.as_dict() for x in t.per_pipe_telemetry] == \
        [x.as_dict() for x in j.per_pipe_telemetry]
    assert t.nf_counters == j.nf_counters
    assert t.per_pipe_nf_counters == j.per_pipe_nf_counters
    assert t.peak_occupancy == j.peak_occupancy
    assert t.per_pipe_peak_occupancy == j.per_pipe_peak_occupancy
    assert np.array_equal(np.asarray(t.per_pipe_occ_series),
                          np.asarray(j.per_pipe_occ_series))
    assert t.gain == j.gain
    assert t.nf_cycles == j.nf_cycles
    assert t.steer_stats == j.steer_stats


@pytest.mark.parametrize("fam", ["chain", "recirc"])
def test_run_prepared_matches_reference_run_matrix(ref_results, fam):
    ref = ref_results[fam]
    got = TS.run_prepared([CV.prepared(r.prepared) for r in ref],
                          device="cpu")
    assert [r.group_size for r in got] == [r.group_size for r in ref]
    for j, t in zip(ref, got):
        _assert_same_point(j, t)
        assert TS.default_rows(t, fam) == JS.default_rows(j, fam)
    assert all(v == 0 for v in launch_counts().values())


def test_chain_direction_holds_on_reference_points(ref_results):
    got = {r.spec.name: r.gain["goodput_gain"] for r in TS.run_prepared(
        [CV.prepared(r.prepared) for r in ref_results["chain"]],
        device="cpu")}
    assert got["datacenter_base"] > 0
    assert got["datacenter_recirc"] > got["datacenter_base"]


def test_prepare_matches_compile_key_groups(ref_results):
    """The port's own points group as the reference's do."""
    for fam in ("chain", "recirc"):
        specs = TS.family(fam, tiny=True)
        keys = []
        for s in specs:
            p = TS.prepare(s)
            keys.append(TS.compile_key(s, p.chain, p.steps))
        sizes = [keys.count(k) for k in keys]
        assert sizes == [r.group_size for r in ref_results[fam]]


def test_batched_group_equals_points_run_alone():
    """Workload, seed and LB-fault timing differ; the chain (same fault
    target) and the geometry do not, so the three run as one call."""
    lb = ("fw", "nat", "lb")
    specs = [_spec(TS, name="a", workload=("fixed", 512), pipes=2, chain=lb,
                   flows=24, fault=dict(kind="lb", backend=2)),
             _spec(TS, name="b", workload=("datacenter",), pipes=2, seed=5,
                   chain=lb, flows=24,
                   fault=dict(kind="lb", backend=2, duration=1)),
             _spec(TS, name="c", workload=("enterprise",), seed=3, chain=lb,
                   flows=24, pipes=2,
                   fault=dict(kind="lb", backend=2, start=1, duration=2))]
    batched = TS.run_matrix(specs, device="cpu")
    assert [r.group_size for r in batched] == [3, 3, 3]
    for spec, res in zip(specs, batched):
        alone = TS.run_matrix([spec], device="cpu")[0]
        assert alone.group_size == 1
        _assert_same_point(res, alone)
        p = TS.prepare(spec)
        solo = TE.run_pipes(spec.park_config(), p.chain, p.traces,
                            window=spec.window, faults=spec.fault,
                            device="cpu")
        assert res.per_pipe_counters == solo.per_pipe_counters
        assert res.telemetry == solo.telemetry


def test_single_pipe_point_equals_run_engine():
    spec = _spec(TS, workload=("datacenter",), chain=("fw", "nat", "lb"),
                 flows=24, recirc=True)
    res = TS.run_matrix([spec], device="cpu")[0]
    pkts = TS.make_packets(spec)
    solo = TE.run_engine(spec.park_config(), TS.build_chain(spec, pkts),
                         to_time_major(pkts, spec.chunk), window=spec.window,
                         device="cpu")
    assert res.counters == solo.counters and res.gain == TE.goodput_gain(solo)
    assert res.peak_occupancy == solo.peak_occupancy


def test_time_runs_records_a_group_wall():
    res = TS.run_matrix([_spec(TS)], time_runs=True, device="cpu")[0]
    assert res.group_wall_s > 0 and res.wall_s == res.group_wall_s


@pytest.mark.parametrize("recirc", [False, True])
def test_verify_oracle_passes_and_catches_tampering(recirc):
    spec = _spec(TS, chain=("fw", "nat", "lb"), flows=24, recirc=recirc,
                 pipes=2, fault=dict(kind="lb", backend=1, duration=2))
    res = TS.run_matrix([spec], device="cpu")[0]
    TS.verify_oracle(res, device="cpu")
    for field, what in (("per_pipe_counters", "counters"),
                        ("per_pipe_nf_counters", "NF counters")):
        bad = dataclasses.replace(res)
        rows = [dict(r) for r in getattr(res, field)]
        key = "splits" if field == "per_pipe_counters" else "nat_stale_hits"
        rows[1][key] += 1
        setattr(bad, field, rows)
        with pytest.raises(TS.OracleMismatch, match=what):
            TS.verify_oracle(bad, device="cpu")
    bad = dataclasses.replace(res, per_pipe_telemetry=[
        res.per_pipe_telemetry[0], dataclasses.replace(
            res.per_pipe_telemetry[1],
            wire_bytes=res.per_pipe_telemetry[1].wire_bytes + 1)])
    with pytest.raises(TS.OracleMismatch, match="telemetry"):
        TS.verify_oracle(bad, device="cpu")


# --------------------------------------------------------------------------
# host model and resource copies
# --------------------------------------------------------------------------

def test_hostmodel_and_resources_match_reference(ref_results):
    links = [(JPcie.PcieLink(), TPcie.PcieLink()),
             (JPcie.PcieLink(gen=4, lanes=16), TPcie.PcieLink(gen=4,
                                                              lanes=16))]
    for r in ref_results["chain"] + ref_results["recirc"]:
        jt = r.telemetry
        tt = TTel(**jt.as_dict())
        for jl, tl in links:
            assert TNic.pcie_reduction(tl, tt) == JNic.pcie_reduction(jl, jt)
            assert TNic.parked_dma(tl, tt).as_dict() == \
                JNic.parked_dma(jl, jt).as_dict()
            assert TNic.baseline_dma(tl, tt).as_dict() == \
                JNic.baseline_dma(jl, jt).as_dict()
            th = TServer.HostModel(link=tl)
            jh = JServer.HostModel(link=jl)
            assert TServer.server_report(th, tt, r.nf_cycles) == \
                JServer.server_report(jh, jt, r.nf_cycles)
    for recirc in (False, True):
        for n in (1, 2, 4, 8):
            jc = JParkConfig(pmax=2048, recirculation=recirc)
            tc = TParkConfig(pmax=2048, recirculation=recirc)
            assert TServer.per_server_capacity(0.4, tc, n) == \
                JServer.per_server_capacity(0.4, jc, n)
            assert TRes.utilization(tc, n).row() == \
                JRes.utilization(jc, n).row()
            assert TRes.capacity_for_memory_fraction(0.25, tc, n) == \
                JRes.capacity_for_memory_fraction(0.25, jc, n)
    for size in (64, 103, 256, 1492):
        assert TPcie.PcieLink().data_gbps_at(size) == \
            JPcie.PcieLink().data_gbps_at(size)
