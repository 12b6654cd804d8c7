"""The port's streaming driver against the reference (DESIGN.md §13): the
integer hashes, the load schedule, the latency model and the reservoir bit
for bit; ``run_stream`` on the reference's own traces (``MaterializedSource``)
equal to the reference's ``run_stream``; the engine entry points on
sources; and, on the port alone, segmentation invariance, the replay
oracle, the one-segment-at-a-time pull and the synthetic source's purity.
Geometry: the reference streaming bench's TINY (32 steps x chunk 64, pmax
512, capacity 256, window 2, segment 8, reservoir 512).  Every comparison
is exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.park import ParkConfig as JCfg  # noqa: E402
from repro.nf.chain import Chain as JChain  # noqa: E402
from repro.nf.nat import Nat as JNat  # noqa: E402
from repro.switchsim import engine as JE  # noqa: E402
from repro.switchsim import results as JR  # noqa: E402
from repro.switchsim import stream as JSS  # noqa: E402
from repro.traffic import stream as JTS  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.core.packet import map_fields  # noqa: E402
from repro_torch.core.park import ParkConfig as TCfg  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.nf.chain import Chain as TChain  # noqa: E402
from repro_torch.nf.nat import Nat as TNat  # noqa: E402
from repro_torch.switchsim import engine as TE  # noqa: E402
from repro_torch.switchsim import results as TR  # noqa: E402
from repro_torch.switchsim import stream as TSS  # noqa: E402
from repro_torch.traffic import stream as TTS  # noqa: E402

TINY = dict(steps=32, chunk=64, pmax=512, capacity=256, window=2,
            segment_len=8, reservoir=512, flows=10_000, load_period=32)
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF, 0x9E3779B9, 12345, 10**6], np.uint32)


def _cfgs(recirc: bool):
    kw = dict(capacity=TINY["capacity"], max_exp=2, pmax=TINY["pmax"],
              recirculation=recirc, recirc_frac=0.25)
    return JCfg(**kw), TCfg(**kw)


@pytest.fixture(scope="module")
def ref_trace():
    """The reference bench's TINY synthetic trace, drawn by the reference
    (jax.random) and carried across as arrays."""
    src = JTS.SyntheticSource(
        steps=TINY["steps"], chunk=TINY["chunk"], pmax=TINY["pmax"], seed=0,
        flows=TINY["flows"], load=JTS.DiurnalLoad(period=TINY["load_period"]))
    trace = src.materialize()
    return trace, CV.packet_batch(trace, "cpu")


def _port_source(steps=TINY["steps"], seed=0):
    return TTS.SyntheticSource(
        steps=steps, chunk=TINY["chunk"], pmax=TINY["pmax"], seed=seed,
        flows=TINY["flows"], load=TTS.DiurnalLoad(period=TINY["load_period"]))


def _same_stream(j, t):
    assert t.counters == j.counters
    assert t.telemetry.as_dict() == j.telemetry.as_dict()
    assert t.nf_counters == j.nf_counters
    assert t.peak_occupancy == j.peak_occupancy
    assert t.latency == j.latency
    assert t.occ_segments == j.occ_segments
    assert (t.steps, t.segments, t.segment_len) == \
        (j.steps, j.segments, j.segment_len)


# --------------------------------------------------------------------------
# integer hashes, the load schedule, the latency model, the reservoir
# --------------------------------------------------------------------------

def test_splitmix32_matches_reference_on_edges_and_random_words():
    rand = np.random.default_rng(0).integers(0, 1 << 32, 4096,
                                             dtype=np.uint64)
    for xs in (EDGES, rand.astype(np.uint32)):
        want = np.asarray(JTS.splitmix32(jnp.asarray(xs))).astype(np.int64)
        got = TTS.splitmix32(torch.from_numpy(xs.astype(np.int64)))
        assert np.array_equal(got.numpy(), want)
    # int32 bit patterns hash as their uint32 values
    neg = torch.tensor([-1, -(1 << 31)], dtype=torch.int32)
    assert torch.equal(TTS.splitmix32(neg),
                       TTS.splitmix32(torch.tensor([0xFFFFFFFF, 1 << 31])))


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF, 1 << 31])
def test_flow_pool_identity_matches_reference(seed):
    flows = np.concatenate([np.arange(0, 10**6, 61),
                            [0, 1, 10**6 - 1, 10**6, (1 << 31) - 1]])
    flows = flows.astype(np.int32)
    want = JTS.FlowPool(10**6, seed=seed).identity(jnp.asarray(flows))
    got = TTS.FlowPool(10**6, seed=seed).identity(torch.from_numpy(flows))
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        TTS.FlowPool(0)


@pytest.mark.parametrize("period,chunk", [(512, 256), (32, 64)])
def test_diurnal_offered_matches_reference_over_four_days(period, chunk):
    ts = np.arange(4 * period, dtype=np.int32)
    want = np.asarray(JTS.DiurnalLoad(period=period).offered(
        jnp.asarray(ts), chunk))
    got = TTS.DiurnalLoad(period=period).offered(torch.from_numpy(ts), chunk)
    assert np.array_equal(got.numpy(), want)
    assert [int(TTS.DiurnalLoad(period=period).offered(t, chunk))
            for t in (0, period // 4, period // 2)] == \
        [int(want[0]), int(want[period // 4]), int(want[period // 2])]


def test_diurnal_load_checks_match_reference():
    for kw in (dict(period=0), dict(base=0.1, amplitude=0.25),
               dict(base=0.9, amplitude=0.25)):
        with pytest.raises(ValueError):
            JTS.DiurnalLoad(**kw)
        with pytest.raises(ValueError):
            TTS.DiurnalLoad(**kw)


def test_step_ns_and_sojourn_match_reference():
    for w in range(0, 9):
        assert TSS.step_ns_for(w) == JSS.step_ns_for(w)
    plen = np.array([0, 42, 49, 208, 1000, 1492, 2048 + 49], np.int32)
    for w, rec in ((1, 0), (2, 0), (2, 1), (3, 1)):
        sns = JSS.step_ns_for(w)
        want = np.asarray(JSS.sojourn_ns(jnp.asarray(plen), rec, w, sns))
        got = TSS.sojourn_ns(torch.from_numpy(plen), rec, w, sns)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    assert TSS.step_ns_for(2) == 15_000
    assert int(TSS.sojourn_ns(1000, 1, 2, 15_000)) == 45_800


@pytest.mark.parametrize("n0", [0, 500, 511, 512, 513, 5000, (1 << 24) + 3])
def test_reservoir_insert_matches_reference_across_k(n0):
    rng = np.random.default_rng(n0)
    k, rows, seed = 512, 80, 0x5EED
    vals = rng.integers(0, 1 << 20, k).astype(np.int32)
    jv, jn = jnp.asarray(vals), jnp.int32(n0)
    tv, tn = torch.from_numpy(vals.copy()), torch.tensor(n0)
    for step in range(6):
        sample = rng.integers(0, 1 << 20, rows).astype(np.int32)
        alive = rng.random(rows) < (0.3 + 0.1 * step)
        jv, jn = JSS._reservoir_insert(jv, jn, jnp.asarray(sample),
                                       jnp.asarray(alive), seed)
        tv, tn = TSS._reservoir_insert(tv, tn, torch.from_numpy(sample),
                                       torch.from_numpy(alive), seed)
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert int(tn) == int(jn)


def test_quantiles_and_occupancy_summaries_match_reference():
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 90_000, 300).astype(np.int32)
    for n in (0, 1, 7, 299, 300, 10_000):
        assert TSS._quantiles_us(vals, n) == JSS._quantiles_us(vals, n)
    occ = rng.integers(0, 256, 17).astype(np.int64)
    assert TSS._occ_summary(40, occ) == JSS._occ_summary(40, occ)


def test_flat_summary_latency_block_matches_reference():
    tel = dict(wire_pkts=3, wire_bytes=900, to_server_pkts=3,
               to_server_bytes=500, from_server_pkts=2, from_server_bytes=300,
               recirc_pkts=0, recirc_bytes=0, merged_pkts=2,
               merged_bytes=700)
    lat = dict(samples=9, reservoir=4, p50_us=30.1, p99_us=31.0,
               p999_us=31.2)
    from repro.switchsim.telemetry import LinkTelemetry as JTel
    from repro_torch.switchsim.telemetry import LinkTelemetry as TTel
    for kw in (dict(latency=lat), dict(latency={"samples": 0}), {}):
        assert TR.flat_summary({"splits": 4}, TTel(**tel),
                               peak_occupancy=5, **kw) == \
            JR.flat_summary({"splits": 4}, JTel(**tel), peak_occupancy=5,
                            **kw)


# --------------------------------------------------------------------------
# run_stream and the engine on the reference's own traces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("recirc,window,backend", [
    (False, 2, "ref"), (True, 1, "ref"), (True, 2, "pallas_interpret")])
def test_run_stream_matches_reference(ref_trace, recirc, window, backend):
    jtrace, ttrace = ref_trace
    jcfg, tcfg = _cfgs(recirc)
    kw = dict(window=window, segment_len=TINY["segment_len"],
              reservoir=TINY["reservoir"])
    want = JSS.run_stream(jcfg, JChain((JNat(),)),
                          JTS.MaterializedSource(jtrace), backend=backend,
                          **kw)
    got = TSS.run_stream(tcfg, TChain((TNat(),)),
                         TTS.MaterializedSource(ttrace), device="cpu", **kw)
    _same_stream(want, got)
    assert got.summary() == want.summary()
    assert all(v == 0 for v in launch_counts().values())


def test_engine_entry_points_on_sources_match_reference(ref_trace):
    jtrace, ttrace = ref_trace
    jcfg, tcfg = _cfgs(True)
    jch, tch = JChain((JNat(),)), TChain((TNat(),))
    want = JE.run_engine(jcfg, jch, JTS.MaterializedSource(jtrace), window=2)
    got = TE.run_engine(tcfg, tch, TTS.MaterializedSource(ttrace), window=2,
                        device="cpu")
    assert got.counters == want.counters
    assert got.telemetry.as_dict() == want.telemetry.as_dict()
    assert got.nf_counters == want.nf_counters
    assert np.array_equal(np.asarray(got.occ_series),
                          np.asarray(want.occ_series))
    # a sequence of per-pipe sources, and a single source as one pipe
    half = TINY["steps"] // 2
    jsrc = [JTS.MaterializedSource(jtrace).segment(s, half)
            for s in (0, half)]
    tsrc = [TTS.MaterializedSource(ttrace).segment(s, half)
            for s in (0, half)]
    want = JE.run_pipes(jcfg, jch, [JTS.MaterializedSource(x) for x in jsrc],
                        window=2)
    got = TE.run_pipes(tcfg, tch, [TTS.MaterializedSource(x) for x in tsrc],
                       window=2, device="cpu")
    assert got.per_pipe_counters == want.per_pipe_counters
    assert [t.as_dict() for t in got.per_pipe_telemetry] == \
        [t.as_dict() for t in want.per_pipe_telemetry]
    assert got.per_pipe_nf_counters == want.per_pipe_nf_counters
    one = TE.run_pipes(tcfg, tch, TTS.MaterializedSource(tsrc[0]), window=2,
                       device="cpu")
    assert one.counters == got.per_pipe_counters[0]
    with pytest.raises(TypeError, match="sequence of TraceSources"):
        TE.run_pipes(tcfg, tch, object(), device="cpu")


# --------------------------------------------------------------------------
# the port's own stream
# --------------------------------------------------------------------------

def test_segmentation_invariance():
    """Segment lengths 4, 6, 5 (not a multiple of the window) and the whole
    trace give one result, the reservoir included."""
    _, cfg = _cfgs(True)
    src = _port_source(steps=24)
    runs = [TSS.run_stream(cfg, TChain((TNat(),)), src, window=2,
                           segment_len=n, reservoir=64, device="cpu")
            for n in (4, 6, 5, 24)]
    for other in runs[1:]:
        assert other.counters == runs[0].counters
        assert other.telemetry == runs[0].telemetry
        assert other.nf_counters == runs[0].nf_counters
        assert other.latency == runs[0].latency
        assert other.peak_occupancy == runs[0].peak_occupancy
    assert [r.segments for r in runs] == [6, 4, 5, 1]
    assert runs[0].latency["samples"] > 64  # the reservoir overflowed


@pytest.mark.parametrize("recirc", [False, True])
def test_replay_oracle_passes_and_catches_a_doctored_run(monkeypatch,
                                                         recirc):
    _, cfg = _cfgs(recirc)
    chain = TChain((TNat(),))
    rep = TSS.replay_oracle(cfg, chain, _port_source(), window=2,
                            segment_len=6, segments=3, device="cpu")
    assert rep["steps"] == 18 and rep["packets"] == 18 * TINY["chunk"]
    assert rep["segments"] == 3
    real = TSS.run_pipes

    def doctored(*a, **kw):
        res = real(*a, **kw)
        res.counters = dict(res.counters, splits=res.counters["splits"] + 1)
        return res

    monkeypatch.setattr(TSS, "run_pipes", doctored)
    with pytest.raises(TSS.StreamOracleMismatch, match="counters.splits"):
        TSS.replay_oracle(cfg, chain, _port_source(), window=2,
                          segment_len=6, segments=3, device="cpu")


def test_driver_pulls_one_segment_at_a_time(monkeypatch):
    src = _port_source(steps=40)
    calls = []
    orig = TTS.SyntheticSource.segment

    def spy(self, start, count):
        calls.append((start, count))
        return orig(self, start, count)

    monkeypatch.setattr(TTS.SyntheticSource, "segment", spy)
    _, cfg = _cfgs(True)
    res = TSS.run_stream(cfg, TChain((TNat(),)), src, window=2,
                         segment_len=8, device="cpu")
    assert calls == [(s, 8) for s in range(0, 40, 8)]
    assert res.steps == 40 and res.segments == 5
    assert not hasattr(res, "merged") and not hasattr(res, "occ_series")
    assert [s["start"] for s in res.occ_segments] == [0, 8, 16, 24, 32, 40]
    assert all(set(s) == {"start", "steps", "min", "mean", "max", "last"}
               for s in res.occ_segments)


def test_synthetic_source_is_pure():
    src = _port_source(steps=12)
    whole = src.materialize()
    part = src.segment(5, 4)
    again = _port_source(steps=12).segment(5, 4)
    for k, v in CV.as_numpy(part).items():
        assert np.array_equal(v, CV.as_numpy(whole)[k][5:9]), k
        assert np.array_equal(v, CV.as_numpy(again)[k]), k
    short = dataclasses.replace(src, steps=6).materialize()
    for k, v in CV.as_numpy(short).items():
        assert np.array_equal(v, CV.as_numpy(whole)[k][:6]), k
    for t in range(12):
        offered = int(src.load.offered(t, src.chunk))
        assert int(whole.alive[t].sum()) == offered
        for k, v in CV.as_numpy(whole).items():
            assert not v[t, offered:].any(), (t, k)  # dead tails all zero
    other = _port_source(steps=12, seed=1).materialize()
    assert not torch.equal(other.payload, whole.payload)
    assert not torch.equal(other.src_ip, whole.src_ip)
    assert whole.src_ip.device.type == "cpu"
    assert src.materialize(0).src_ip.shape == (0, TINY["chunk"])
    with pytest.raises(ValueError, match="outside"):
        src.segment(10, 3)


def test_as_source_spellings():
    src = _port_source(steps=4)
    assert TTS.as_source(src) is src
    trace = src.materialize()
    ms = TTS.as_source(trace)
    assert isinstance(ms, TTS.MaterializedSource)
    assert (ms.steps, ms.chunk, ms.pmax) == (4, TINY["chunk"], TINY["pmax"])
    flat = TTS.MaterializedSource.from_flat(
        TTS.MaterializedSource(trace).segment(0, 4), TINY["chunk"])
    assert flat.steps == 4
    with pytest.raises(ValueError, match="explicit chunk"):
        TTS.as_source(map_fields(lambda n, a: a[0], trace))
    with pytest.raises(TypeError, match="TraceSource or PacketBatch"):
        TTS.as_source([1, 2, 3])


def test_int32_guard_and_device_checks(monkeypatch):
    _, cfg = _cfgs(False)
    chain = TChain((TNat(),))
    big = TTS.SyntheticSource(steps=2**20, chunk=1024, pmax=2048, seed=0)
    with pytest.raises(ValueError, match="int32 telemetry"):
        TSS.run_stream(cfg, chain, big, window=2, segment_len=2**20,
                       device="cpu")
    jcfg, _ = _cfgs(False)
    jbig = JTS.SyntheticSource(steps=2**20, chunk=1024, pmax=2048, seed=0)
    with pytest.raises(ValueError, match="int32 telemetry"):
        JSS.run_stream(jcfg, JChain((JNat(),)), jbig, window=2,
                       segment_len=2**20)
    for bad in (dict(segment_len=0), dict(reservoir=0)):
        with pytest.raises(ValueError):
            TSS.run_stream(cfg, chain, _port_source(steps=2), device="cpu",
                           **bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSS.run_stream(cfg, chain, _port_source(steps=2), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSS.replay_oracle(cfg, chain, _port_source(steps=2))
