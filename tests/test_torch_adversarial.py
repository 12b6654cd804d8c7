"""The port's adversarial and churn workloads, the ``adversarial`` scenario
family with its graceful-degradation gates, and the analytic performance
model, against the reference (DESIGN.md §10): integer hashes, constructors
and gates exactly; the runner on the reference's own prepared points at
tiny and full geometry (results and degradation block identical, a gate
the reference fails included); the port's own storm and churn
draws; and how often the family's Split and Merge calls reach the control
kernels' sequential branches."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.scenarios as JS  # noqa: E402
from repro.switchsim import perfmodel as JPM  # noqa: E402
from repro.traffic import generator as JG  # noqa: E402
import repro_torch.scenarios as TS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.backend import registry as REG  # noqa: E402
from repro_torch.switchsim import perfmodel as TPM  # noqa: E402
from repro_torch.switchsim.engine import recirc_slots  # noqa: E402
from repro_torch.traffic import generator as TG  # noqa: E402


# --------------------------------------------------------------------------
# workloads
# --------------------------------------------------------------------------

def test_flow_identity_matches_reference():
    flows = np.concatenate([np.arange(0, 10**6, 37),
                            [0, 1, 127, 10**6, (1 << 31) - 1, -1, -(1 << 31)]])
    flows = flows.astype(np.int32)
    want = JG._flow_identity(jnp.asarray(flows))
    got = TG._flow_identity(torch.from_numpy(flows))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def _workloads(pkg):
    return [pkg.enterprise(), pkg.datacenter(), pkg.fixed(64), pkg.fixed(1492),
            pkg.adversarial("enterprise", 0.25, 8),
            pkg.adversarial("datacenter", 1.0, 64), pkg.churn(64, 32)]


def test_splittable_share_matches_reference():
    for j, t in zip(_workloads(JG), _workloads(TG)):
        for kw in (dict(), dict(min_park_len=100, park_bytes=352),
                   dict(min_park_len=166, park_bytes=160)):
            assert t.splittable_share(**kw) == j.splittable_share(**kw)
        assert t.mean_pkt_bytes == j.mean_pkt_bytes


@pytest.mark.parametrize("base", ["enterprise", "datacenter"])
def test_constructors_match_reference(base):
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        for burst in (1, 8, 64):
            j = JG.adversarial(base, frac, burst)
            t = TG.adversarial(base, frac, burst)
            assert t.name == j.name
            assert np.array_equal(t.sizes, j.sizes)
            assert np.array_equal(t.probs, j.probs)
            assert (t.attack_fraction, t.burst, t.attack_size) == \
                (j.attack_fraction, j.burst, j.attack_size)
    for pool, rotate in ((2, 1), (64, 128), (512, 4096)):
        j, t = JG.churn(pool, rotate, base), TG.churn(pool, rotate, base)
        assert (t.name, t.pool, t.rotate) == (j.name, j.pool, j.rotate)
        assert np.array_equal(t.sizes, j.sizes)
    assert (TG.VICTIM_IP, TG.VICTIM_PORT, TG.ATTACK_SIZE) == \
        (JG.VICTIM_IP, JG.VICTIM_PORT, JG.ATTACK_SIZE)
    for bad in (dict(attack_fraction=-0.1), dict(attack_fraction=1.5),
                dict(burst=0), dict(attack_size=201)):
        with pytest.raises(ValueError):
            JG.adversarial(base, **bad)
        with pytest.raises(ValueError):
            TG.adversarial(base, **bad)
    for bad in ((1, 10), (64, 0)):
        with pytest.raises(ValueError):
            JG.churn(*bad, base=base)
        with pytest.raises(ValueError):
            TG.churn(*bad, base=base)


def test_attack_fraction_zero_is_the_base_workload():
    base = TG.enterprise().make_batch(11, 512, pmax=512, device="cpu")
    zero = TG.adversarial("enterprise", 0.0, 8).make_batch(
        11, 512, pmax=512, device="cpu")
    for k, v in CV.as_numpy(base).items():
        assert np.array_equal(v, CV.as_numpy(zero)[k]), k


def test_attack_slots_are_supersets_across_fractions():
    masks, batches = [], []
    for frac in TS.adversarial.EXHAUST_FRACS + (1.0,):
        wl = TG.adversarial("enterprise", frac, 8)
        pkts = wl.make_batch(5, 1024, pmax=512, device="cpu")
        batches.append(pkts)
        masks.append(pkts.dst_ip == TG.VICTIM_IP)
    for lo, hi in zip(masks, masks[1:]):
        assert bool((lo & ~hi).sum() == 0) and hi.sum() > lo.sum()
    assert [int(m.sum()) for m in masks] == [0, 256, 768, 1024]
    storm = batches[2]
    hit = masks[2]
    assert bool((storm.payload_len[hit] == TG.ATTACK_SIZE - 42).all())
    assert bool((storm.dst_port[hit] == TG.VICTIM_PORT).all())
    # burst slots of 8 rows attack whole
    assert bool((hit.view(-1, 8).all(1) | ~hit.view(-1, 8).any(1)).all())
    # outside the storm, the packets are the base workload's
    base = TG.enterprise().make_batch(5, 1024, pmax=512, device="cpu")
    assert torch.equal(storm.src_ip[~hit], base.src_ip[~hit])
    assert torch.equal(storm.payload[~hit], base.payload[~hit])


def test_churn_windows_overlap_by_half():
    wl = TG.churn(pool=64, rotate=128)
    # the flows a batch from seed 3 draws, from its churn generator
    flows = wl.flows(TG._fold(torch.Generator().manual_seed(3),
                              TG._CHURN_TAG), 1024)
    windows = [set(flows[w * 128:(w + 1) * 128].tolist()) for w in range(8)]
    for w, seen in enumerate(windows):
        assert min(seen) >= 32 * w and max(seen) < 32 * w + 64
    for a, b in zip(windows, windows[1:]):
        assert a & b and max(a & b) < min(b) + 32
    pkts = wl.make_batch(3, 1024, pmax=512, device="cpu")
    ip, port = TG._flow_identity(flows)
    assert torch.equal(pkts.src_ip, ip) and torch.equal(pkts.src_port, port)
    again = wl.make_batch(3, 1024, pmax=512, device="cpu")
    assert torch.equal(again.src_ip, pkts.src_ip)


# --------------------------------------------------------------------------
# the family and its gates on the reference's prepared points
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_points():
    return JS.run_matrix(JS.family("adversarial", tiny=True))


@contextlib.contextmanager
def branch_counts():
    """Runs the block with the plain ``split_control`` and ``merge_stage``
    wrapped to count the Split calls with more eligible packets than table
    slots per pipe and the Merge calls' checked packets on a slot another
    checked packet of the call names (the control kernels' sequential
    branches).  Yields the counts."""
    counts = dict(split_calls=0, split_over_m=0, merge_calls=0,
                  merge_contested=0)

    def split(m, max_exp, max_clk, min_len, *rest):
        alive, plen = rest[-2:]
        counts["split_calls"] += 1
        eligible = (alive & (plen >= min_len)).sum(-1)
        counts["split_over_m"] += int((eligible > m).sum())
        return R.split_control(m, max_exp, max_clk, min_len, *rest)

    def merge(table, exp, gen, ln, alive, valid, enb, op, ti, clk, crc):
        counts["merge_calls"] += 1
        m = exp.shape[-1]
        checked = alive & valid & (enb == 1) & (R.crc16_tag(ti, clk) == crc)
        slot = torch.where(ti < 0, ti.long() + m, ti.long()).clamp(0, m - 1)
        slot = torch.where(checked, slot, -1 - torch.arange(slot.shape[-1]))
        srt = torch.sort(slot, -1).values
        counts["merge_contested"] += int(
            ((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)).sum())
        return R.merge_stage(table, exp, gen, ln, alive, valid, enb, op, ti,
                             clk, crc)

    saved = dict(REG._REGISTRY)
    for name, fn in (("split_control", split), ("merge_stage", merge)):
        REG._REGISTRY[name] = dataclasses.replace(saved[name], ref=fn,
                                                  auto=fn)
    try:
        yield counts
    finally:
        REG._REGISTRY.update(saved)


def carried_across(ref_results):
    """The port's runner on the reference's prepared points, with the
    kernel-branch counts of ``branch_counts``."""
    with branch_counts() as counts:
        got = TS.run_prepared([CV.prepared(r.prepared)
                               for r in ref_results], device="cpu")
    return got, counts


def assert_same_points(got, ref_results):
    assert [r.spec.name for r in got] == [r.spec.name for r in ref_results]
    assert [r.group_size for r in got] == [r.group_size for r in ref_results]
    for j, t in zip(ref_results, got):
        assert t.counters == j.counters, j.spec.name
        assert t.telemetry.as_dict() == j.telemetry.as_dict()
        assert t.per_pipe_counters == j.per_pipe_counters
        assert t.nf_counters == j.nf_counters
        assert t.per_pipe_nf_counters == j.per_pipe_nf_counters
        assert t.per_pipe_peak_occupancy == j.per_pipe_peak_occupancy
        assert np.array_equal(np.asarray(t.per_pipe_occ_series),
                              np.asarray(j.per_pipe_occ_series))
        assert t.gain == j.gain
        assert TS.degradation_metrics(t) == JS.degradation_metrics(j)
        assert TS.default_rows(t, "adversarial") == \
            JS.default_rows(j, "adversarial")
    assert TS.degradation_block(got) == JS.degradation_block(ref_results)


@pytest.fixture(scope="module")
def port_points(ref_points):
    return carried_across(ref_points)


@pytest.fixture(scope="module")
def full_points():
    """The reference's 11 full-geometry points (seed 0) and the port's
    runner on them, with its kernel-branch counts."""
    ref = JS.run_matrix(JS.family("adversarial"))
    return ref, *carried_across(ref)


def test_run_prepared_matches_reference(ref_points, port_points):
    got, _ = port_points
    assert_same_points(got, ref_points)
    assert TS.degradation_block(got)["ok"]


def test_run_prepared_matches_reference_at_full_geometry(full_points):
    ref, got, _ = full_points
    assert_same_points(got, ref)
    metrics = {r.spec.name: TS.degradation_metrics(r) for r in got}
    assert metrics["failover_drain"]["recovery_steps"] == 3


def test_failover_gate_the_reference_fails_fails_alike_in_the_port():
    """On seed 2 of the full geometry the reference's own
    ``failover_drain`` misses its ``recovery_steps <= 8`` gate (ROADMAP
    C0f): carried across, the port gives the same metrics and the same
    failing gate."""
    points = [dataclasses.replace(s, seed=2)
              for s in JS.family("adversarial")
              if s.name.startswith("failover")]
    ref = JS.run_matrix(points)
    got, _ = carried_across(ref)
    assert_same_points(got, ref)
    block = TS.degradation_block(got)
    drain = block["scenarios"]["failover_drain"]
    assert drain["metrics"]["recovery_steps"] == 12
    assert [g["metric"] for g in drain["gates"] if not g["ok"]] == \
        ["recovery_steps"]
    assert not block["ok"]


def test_family_reaches_no_sequential_kernel_branch(port_points,
                                                    full_points):
    """Counted on the tiny and the full points: no Split call has more
    eligible packets than slots (``csrc/split_control.cu``'s lists and
    per-slot walk) and no Merge call has a contested slot
    (``csrc/merge_stage.cu``'s walk).  The storm spoofs sources and
    shrinks packets but writes no PayloadPark tag.  At full geometry the
    first also holds by construction: no point recirculates and a Split
    call takes one chunk, at most the capacity."""
    for _, counts in (port_points, full_points[1:]):
        assert counts["split_calls"] == counts["merge_calls"] > 0
        assert counts["split_over_m"] == 0 and counts["merge_contested"] == 0
    for spec in TS.family("adversarial"):
        assert not spec.recirc
        assert spec.chunk + recirc_slots(spec.park_config(),
                                         spec.chunk) <= spec.capacity


def test_bounds_for_matches_reference():
    for tiny in (True, False):
        for j, t in zip(JS.family("adversarial", tiny=tiny),
                        TS.family("adversarial", tiny=tiny)):
            assert TS.bounds_for(t) == JS.bounds_for(j)
    other = TS.family("chain", tiny=True)[0]
    with pytest.raises(ValueError, match="no degradation gate"):
        TS.bounds_for(other)


def test_a_false_gate_fails_the_block(port_points):
    got, _ = port_points
    leak = got[0]
    occ = np.array(leak.per_pipe_occ_series, copy=True)
    occ[:, -1] = 3  # three leaked slots past the drain
    bad = dataclasses.replace(leak, per_pipe_occ_series=occ)
    block = TS.degradation_block([bad] + got[1:])
    assert not block["ok"]
    gates = block["scenarios"][leak.spec.name]["gates"]
    assert [g["metric"] for g in gates if not g["ok"]] == ["occ_final"]
    assert all(g["ok"] for name, sc in block["scenarios"].items()
               if name != leak.spec.name for g in sc["gates"])
    churn = next(r for r in got if r.spec.name.startswith("churn"))
    quiet = dataclasses.replace(churn, nf_counters={})
    with pytest.raises(ValueError, match="not computed"):
        TS.degradation_block([quiet])


# --------------------------------------------------------------------------
# the analytic performance model
# --------------------------------------------------------------------------

def _as_dict(x):
    return dataclasses.asdict(x)


def test_perfmodel_matches_reference_over_a_grid():
    models = [(JPM.ServerModel(), TPM.ServerModel()),
              (JPM.ServerModel(link_gbps=100.0, cores_per_nf=2),
               TPM.ServerModel(link_gbps=100.0, cores_per_nf=2))]
    digests = []
    for j, t in zip(_workloads(JG), _workloads(TG)):
        for parking, pass_bytes, park in ((False, None, 160),
                                          (True, None, 160),
                                          (True, 160, 352)):
            args = (j.sizes, j.probs, park, 160, parking, pass_bytes)
            jd, td = JPM.digest(*args), TPM.digest(*args)
            assert _as_dict(td) == _as_dict(jd)
            digests.append((jd, td))
    jd = JPM.measured_digest(4096, 3_600_000, 2_100_000, 0.6, 0.1)
    td = TPM.measured_digest(4096, 3_600_000, 2_100_000, 0.6, 0.1)
    assert _as_dict(td) == _as_dict(jd)
    digests.append((jd, td))
    assert _as_dict(TPM.measured_digest(0, 0, 0, 0.0)) == \
        _as_dict(JPM.measured_digest(0, 0, 0, 0.0))
    for jm, tm in models:
        for jd, td in digests:
            for cycles in (50, [50, 300], [570.0]):
                for gbps in (1.0, 10.0, 40.0, 120.0):
                    jo = JPM.evaluate(jm, jd, cycles, gbps)
                    to = TPM.evaluate(tm, td, cycles, gbps)
                    assert _as_dict(to) == _as_dict(jo)
                    assert _as_dict(TPM.scale_pipes(to, 8)) == \
                        _as_dict(JPM.scale_pipes(jo, 8))
                    jh = JPM.evaluate_host(jm, jd, cycles, gbps)
                    th = TPM.evaluate_host(tm, td, cycles, gbps)
                    assert _as_dict(th) == _as_dict(jh)
            for kw in (dict(), dict(table_capacity=4096, max_exp=2,
                                    parking=True),
                       dict(table_capacity=64, max_exp=1, parking=True,
                            nf_latency_us=60.0)):
                assert _as_dict(TPM.peak_goodput(tm, td, [300], **kw)) == \
                    _as_dict(JPM.peak_goodput(jm, jd, [300], **kw))
