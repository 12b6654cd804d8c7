"""The port's engine against the reference engine (``backend="ref"``) at the
TINY geometry on the same numpy traces, and against its own host loop:
counters, per-pipe counters, telemetry, NF counters, occupancy series and
merged wire bytes, exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.sweeps import TINY  # noqa: E402
from repro.core import packet as JK  # noqa: E402
from repro.core import park as JP  # noqa: E402
from repro.nf.chain import Chain as JChain  # noqa: E402
from repro.nf.firewall import Firewall as JFw  # noqa: E402
from repro.nf.nat import Nat as JNat  # noqa: E402
from repro.switchsim import engine as JE  # noqa: E402
from repro.switchsim import faults as JF  # noqa: E402
from repro.traffic import generator as JG  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.core import packet as TK  # noqa: E402
from repro_torch.core import park as TP  # noqa: E402
from repro_torch.nf.chain import Chain as TChain  # noqa: E402
from repro_torch.nf.firewall import Firewall as TFw  # noqa: E402
from repro_torch.nf.nat import Nat as TNat  # noqa: E402
from repro_torch.switchsim import engine as TE  # noqa: E402
from repro_torch.switchsim import faults as TF  # noqa: E402
from repro_torch.switchsim import simulate as TS  # noqa: E402
from repro_torch.traffic import generator as TG  # noqa: E402

PIPES = 2
FAULTS = {
    "healthy": None,
    "drain": dict(kind="server", start=1, duration=2, pipe=1, drain=True),
    "drop": dict(kind="server", start=1, duration=2, pipe=1, drain=False),
}


def _jfault(name):
    return None if FAULTS[name] is None else JF.FaultSpec(**FAULTS[name])


def _tfault(name):
    return None if FAULTS[name] is None else TF.FaultSpec(**FAULTS[name])


@pytest.fixture(scope="module")
def packets():
    rng = np.random.default_rng(2020)
    return CV.numpy_packets(rng, TINY.packets, TINY.pmax, n_ips=120,
                            n_ports=4)


@pytest.fixture(scope="module")
def setups(packets):
    """(jax cfg, torch cfg, jax chain, torch chain) per recirc mode."""
    rules = tuple(int(v) for v in np.unique(packets["src_ip"])[:20])
    out = {}
    for recirc in (False, True):
        kw = dict(capacity=256, max_exp=2, pmax=TINY.pmax,
                  recirculation=recirc)
        out[recirc] = (JP.ParkConfig(**kw), TP.ParkConfig(**kw),
                       JChain((JFw(rules=rules), JNat())),
                       TChain((TFw(rules=rules), TNat())))
    return out


@pytest.fixture(scope="module")
def traces(packets):
    jp = JK.PacketBatch(**{k: jnp.asarray(v) for k, v in packets.items()})
    tp = CV.packet_batch(packets, "cpu")
    js, jstats = JG.steer_pipes(jp, PIPES, chunk=TINY.chunk)
    ts, tstats = TG.steer_pipes(tp, PIPES, chunk=TINY.chunk)
    assert jstats == tstats
    jtr = jax.tree.map(lambda a: a.reshape(
        (PIPES, a.shape[1] // TINY.chunk, TINY.chunk) + a.shape[2:]), js)
    return jp, tp, jtr, TK.to_time_major(ts, TINY.chunk)


def _flat(n, a):
    """(..., chunk[, pmax]) -> (N[, pmax])."""
    return a.reshape((-1, a.shape[-1]) if n == "payload" else (-1,))


def _wire(merged_j, merged_t):
    ja = JK.wire_bytes(JK.PacketBatch(**{
        n: _flat(n, getattr(merged_j, n)) for n in TK.FIELDS}))
    return ja, TK.wire_bytes(TK.map_fields(_flat, merged_t))


def assert_same_run(jr, tr, per_pipe):
    assert jr.counters == tr.counters
    assert jr.telemetry.as_dict() == tr.telemetry.as_dict()
    assert jr.nf_counters == tr.nf_counters
    assert np.array_equal(np.asarray(jr.occ_series), tr.occ_series)
    assert jr.peak_occupancy == tr.peak_occupancy
    if per_pipe:
        assert jr.per_pipe_counters == tr.per_pipe_counters
        assert [t.as_dict() for t in jr.per_pipe_telemetry] == \
            [t.as_dict() for t in tr.per_pipe_telemetry]
        assert jr.per_pipe_nf_counters == tr.per_pipe_nf_counters
        assert jr.per_pipe_peak_occupancy == tr.per_pipe_peak_occupancy
    (jb, jl), (tb, tl) = _wire(jr.merged, tr.merged)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert JE.goodput_gain(jr) == TE.goodput_gain(tr)


def test_steering_and_flow_hash_parity(traces, packets):
    jp, tp, jtr, ttr = traces
    assert np.array_equal(np.asarray(JG.flow_hash(jp)),
                          TG.flow_hash(tp).numpy())
    for k, v in CV.as_numpy(ttr).items():
        assert np.array_equal(np.asarray(getattr(jtr, k)), v), k
    assert JG.pipe_trace_steps(TINY.packets, PIPES, TINY.chunk) == \
        TG.pipe_trace_steps(TINY.packets, PIPES, TINY.chunk) == \
        ttr.src_ip.shape[1]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("recirc", [False, True])
def test_run_pipes_parity(setups, traces, recirc, fault):
    jcfg, tcfg, jch, tch = setups[recirc]
    _, _, jtr, ttr = traces
    jr = JE.run_pipes(jcfg, jch, jtr, window=TINY.window, backend="ref",
                      faults=_jfault(fault))
    tr = TE.run_pipes(tcfg, tch, ttr, window=TINY.window,
                      faults=_tfault(fault), device="cpu")
    assert_same_run(jr, tr, per_pipe=True)
    assert tr.counters["splits"] > 0 and tr.counters["merges"] > 0
    if fault != "healthy":
        assert tr.counters["fault_drops"] > 0
    if recirc:
        assert tr.counters["recirculations"] > 0


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("recirc", [False, True])
def test_run_engine_parity(setups, traces, recirc, explicit):
    jcfg, tcfg, jch, tch = setups[recirc]
    jp, tp, _, _ = traces
    jr = JE.run_engine(jcfg, jch, JK.to_time_major(jp, TINY.chunk),
                       window=TINY.window, backend="ref",
                       explicit_drops=explicit, collect_sent=True)
    tr = TE.run_engine(tcfg, tch, TK.to_time_major(tp, TINY.chunk),
                       window=TINY.window, explicit_drops=explicit,
                       collect_sent=True, device="cpu")
    assert_same_run(jr, tr, per_pipe=False)
    for k, v in CV.as_numpy(tr.sent).items():
        assert np.array_equal(np.asarray(getattr(jr.sent, k)), v), k
    for k, v in CV.as_numpy(tr.state).items():
        assert np.array_equal(np.asarray(getattr(jr.state, k)), v), k


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("recirc", [False, True])
def test_engine_matches_loop(setups, traces, recirc, fault):
    _, tcfg, _, tch = setups[recirc]
    _, tp, _, _ = traces
    kw = dict(window=TINY.window, chunk=TINY.chunk, faults=_tfault(fault),
              device="cpu")
    loop = TS.simulate_loop(tcfg, tch, tp, **kw)
    eng = TS.simulate(tcfg, tch, tp, **kw)
    assert loop.counters == eng.counters
    assert loop.telemetry == eng.telemetry
    assert loop.nf_counters == eng.nf_counters
    assert len(loop.merged) == len(eng.merged)
    for a, b in zip(loop.merged, eng.merged):
        for k, v in CV.as_numpy(a).items():
            assert np.array_equal(v, CV.as_numpy(b)[k]), k


def test_run_pipes_rejects_what_is_not_ported(setups, traces):
    _, tcfg, _, tch = setups[False]
    _, tp, _, ttr = traces
    # two devices with one visible: the reference's warning, then the
    # single-device run
    with pytest.warns(UserWarning, match="only 1 visible"):
        two = TE.run_pipes(tcfg, tch, ttr, devices=2, device="cpu")
    assert two.counters == TE.run_pipes(tcfg, tch, ttr,
                                        device="cpu").counters
    # a sequence of sources takes time-major (T, chunk) traces, as the
    # reference's does: a (P, T, chunk) batch in it is refused
    with pytest.raises(ValueError):
        TE.run_pipes(tcfg, tch, [ttr], device="cpu")
    with pytest.raises(TypeError):
        TE.run_pipes(tcfg, tch, object(), device="cpu")
    with pytest.raises(TypeError):
        TE.run_engine(tcfg, tch, object(), device="cpu")


@pytest.mark.parametrize("name", ["fixed", "enterprise", "datacenter"])
def test_workloads_draw_their_sizes_from_a_seed(name):
    wl = TG.fixed(300) if name == "fixed" else getattr(TG, name)()
    ref = JG.fixed(300) if name == "fixed" else getattr(JG, name)()
    assert np.array_equal(wl.sizes, ref.sizes)
    assert wl.mean_pkt_bytes == ref.mean_pkt_bytes
    a = wl.make_batch(3, 512, pmax=2048, device="cpu")
    b = wl.make_batch(3, 512, pmax=2048, device="cpu")
    for k, v in CV.as_numpy(a).items():
        assert np.array_equal(v, CV.as_numpy(b)[k]), k
    lens = a.payload_len.numpy() + 42
    assert set(lens.tolist()) <= set(int(s) for s in wl.sizes)


def test_flow_pool_is_seeded_and_distinct():
    ips, ports = TG.flow_pool(1024, seed=7, device="cpu")
    again, _ = TG.flow_pool(1024, seed=7, device="cpu")
    assert torch.equal(ips, again)
    assert torch.unique(ips).numel() == 1024
    assert int(ports.min()) >= 1024 and int(ports.max()) < 65536
