"""Split / recirculation / Merge of the port against the reference on the
same numpy packets: every ParkState field, every PacketBatch field and the
wire bytes, exactly, across several steps of state."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import packet as JK  # noqa: E402
from repro.core import park as JP  # noqa: E402
from repro.nf.chain import to_explicit_drops as j_explicit  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.core import counters as TC  # noqa: E402
from repro_torch.core import packet as TK  # noqa: E402
from repro_torch.core import park as TP  # noqa: E402
from repro_torch.nf.chain import to_explicit_drops as t_explicit  # noqa: E402

PMAX = 512


def jbatch(d):
    return JK.PacketBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_same(j, t, what):
    a, b = CV.as_numpy(j), CV.as_numpy(t)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: field {k}"


def assert_wire(j, t):
    ja, jl = JK.wire_bytes(j)
    ta, tl = TK.wire_bytes(t)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    assert np.array_equal(np.asarray(jl), tl.numpy())


def corrupt(d, rng, capacity):
    """Flip CRCs and plant out-of-range tags whose CRC is valid, on some
    parked packets returning from the server."""
    d = {k: np.array(v) for k, v in d.items()}
    parked = np.flatnonzero(d["pp_enb"] == 1)
    if len(parked) < 4:
        return d
    flip = rng.choice(parked, 2, replace=False)
    d["pp_crc"][flip] ^= 1
    rest = np.setdiff1d(parked, flip)
    oob = rng.choice(rest, 2, replace=False)
    d["pp_ti"][oob] = [capacity + 3, -1]
    crc = JP.crc16_tag(jnp.asarray(d["pp_ti"][oob]),
                       jnp.asarray(d["pp_clk"][oob]), backend="ref")
    d["pp_crc"][oob] = np.asarray(crc)
    return d


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("max_exp", [1, 2])
@pytest.mark.parametrize("recirc", [False, True])
def test_split_recirc_merge_parity(recirc, max_exp, explicit):
    rng = np.random.default_rng(100 * recirc + 10 * max_exp + explicit)
    kw = dict(capacity=16, max_exp=max_exp, pmax=PMAX, recirculation=recirc)
    jcfg, tcfg = JP.ParkConfig(**kw), TP.ParkConfig(**kw)
    js, ts = JP.init_state(jcfg), TP.init_state(tcfg, device="cpu")
    inflight = []
    for step in range(5):
        d = CV.numpy_packets(rng, 24, PMAX, alive_frac=0.9)
        js, jo = JP.split(jcfg, js, jbatch(d), backend="ref")
        ts, to = TP.split_fn(tcfg, ts, CV.packet_batch(d, "cpu"))
        assert_same(js, ts, f"split state {step}")
        assert_same(jo, to, f"split out {step}")
        if recirc:
            js, jo = JP.recirc(jcfg, js, jo, backend="ref")
            ts, to = TP.recirc_fn(tcfg, ts, to)
            assert_same(js, ts, f"recirc state {step}")
            assert_same(jo, to, f"recirc out {step}")
        drop = rng.random(24) < 0.3
        if explicit:
            jo = j_explicit(jo, jnp.asarray(drop))
            to = t_explicit(to, torch.from_numpy(drop))
        inflight.append(corrupt(CV.as_numpy(jo), rng, 16))
        if len(inflight) > 1:  # one step in flight
            back = inflight.pop(0)
            js, jm = JP.merge(jcfg, js, jbatch(back), backend="ref")
            ts, tm = TP.merge_fn(tcfg, ts, CV.packet_batch(back, "cpu"))
            assert_same(js, ts, f"merge state {step}")
            assert_same(jm, tm, f"merge out {step}")
            assert_wire(jm, tm)
    ctr = TC.as_dict(ts.counters)
    assert ctr["splits"] > 0 and ctr["crc_failures"] > 0
    assert ts.counters.dtype == torch.int32
    assert TP.stats(ts) == JP.stats(js)


def test_split_merge_with_pipe_axis_matches_per_pipe_reference():
    rng = np.random.default_rng(7)
    kw = dict(capacity=32, max_exp=2, pmax=PMAX)
    jcfg, tcfg = JP.ParkConfig(**kw), TP.ParkConfig(**kw)
    pipes = 3
    ds = [CV.numpy_packets(rng, 16, PMAX) for _ in range(pipes)]
    stacked = {k: np.stack([d[k] for d in ds]) for k in ds[0]}
    ts = TP.init_state(tcfg, device="cpu", pipes=pipes)
    ts, to = TP.split_fn(tcfg, ts, CV.packet_batch(stacked, "cpu"))
    ts, tm = TP.merge_fn(tcfg, ts, to)
    for p in range(pipes):
        js, jo = JP.split(jcfg, JP.init_state(jcfg), jbatch(ds[p]),
                          backend="ref")
        js, jm = JP.merge(jcfg, js, jo, backend="ref")
        pick = TK.map_fields(lambda n, a: a[p], tm)
        assert_same(jm, pick, f"pipe {p}")
        st = TP.ParkState(**{f.name: getattr(ts, f.name)[p]
                             for f in dataclasses.fields(TP.ParkState)})
        assert_same(js, st, f"pipe {p} state")


def test_packet_helpers_parity():
    rng = np.random.default_rng(3)
    d = CV.numpy_packets(rng, 12, 64)
    d["pp_valid"][::2] = True
    d["pp_enb"][::3] = 1
    d["pp_ti"] = rng.integers(0, 1 << 16, 12).astype(np.int32)
    jp, tp = jbatch(d), CV.packet_batch(d, "cpu")
    assert_wire(jp, tp)
    idx = np.array([0, 12, 5, 5, 11], np.int32)
    assert_same(JK.gather_rows(jp, jnp.asarray(idx)),
                TK.gather_rows(tp, torch.from_numpy(idx)), "gather_rows")
    assert_same(JK.from_time_major(JK.to_time_major(jp, 4)),
                TK.from_time_major(TK.to_time_major(tp, 4)), "time major")
    assert_same(JK.dead_batch(3, 64), TK.dead_batch(3, 64, "cpu"), "dead")


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TP.init_state(TP.ParkConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        TK.dead_batch(4, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        TK.make_udp_batch(0, 4, 100)


def test_make_udp_batch_is_seeded_and_canonical():
    a = TK.make_udp_batch(5, 32, torch.arange(42, 74), pmax=64, device="cpu")
    b = TK.make_udp_batch(5, 32, torch.arange(42, 74), pmax=64, device="cpu")
    assert_same(a, b, "same seed")
    live = torch.arange(64)[None, :] < a.payload_len[:, None]
    assert not a.payload[~live].any()
    assert tuple(a.payload.shape) == (32, 64)


def test_state_carried_across_from_the_reference_continues_identically():
    rng = np.random.default_rng(21)
    kw = dict(capacity=16, max_exp=2, pmax=PMAX, recirculation=True)
    jcfg, tcfg = JP.ParkConfig(**kw), TP.ParkConfig(**kw)
    js = JP.init_state(jcfg)
    for _ in range(3):
        js, jo = JP.split(jcfg, js, jbatch(CV.numpy_packets(rng, 24, PMAX)),
                          backend="ref")
    ts = CV.park_state(js, "cpu")
    assert_same(js, ts, "carried state")
    d = CV.numpy_packets(rng, 24, PMAX)
    js, jo = JP.split(jcfg, js, jbatch(d), backend="ref")
    ts, to = TP.split_fn(tcfg, ts, CV.packet_batch(d, "cpu"))
    js, jm = JP.merge(jcfg, js, jo, backend="ref")
    ts, tm = TP.merge_fn(tcfg, ts, to)
    assert_same(js, ts, "state after")
    assert_same(jm, tm, "merged after")
