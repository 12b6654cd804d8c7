"""Firewall, NAT and the chain helpers of the port against the reference on
the same numpy packets and state, exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import packet as JK  # noqa: E402
from repro.nf import chain as JC  # noqa: E402
from repro.nf.firewall import Firewall as JFw  # noqa: E402
from repro.nf.nat import Nat as JNat  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.nf import chain as TC  # noqa: E402
from repro_torch.nf.firewall import Firewall as TFw  # noqa: E402
from repro_torch.nf.nat import Nat as TNat  # noqa: E402
from repro_torch.nf.nat import _hash as t_hash  # noqa: E402

PMAX = 64


def jbatch(d):
    return JK.PacketBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_same(j, t, what):
    a, b = CV.as_numpy(j), CV.as_numpy(t)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: field {k}"


def assert_nat_state(js, ts):
    for k in ("key_ip", "key_port", "exp", "stale_hits"):
        assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), k


@pytest.mark.parametrize("n_rules", [1, 20])
def test_firewall_parity(n_rules):
    rng = np.random.default_rng(n_rules)
    d = CV.numpy_packets(rng, 200, PMAX, n_ips=60, alive_frac=0.9)
    rules = tuple(int(v) for v in np.unique(d["src_ip"])[:n_rules])
    jfw, tfw = JFw(rules=rules), TFw(rules=rules)
    _, jo, jd, jc = jfw(jfw.init_state(), jbatch(d), backend="ref")
    _, to, td, tc = tfw(tfw.init_state("cpu"), CV.packet_batch(d, "cpu"))
    assert_same(jo, to, "firewall out")
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert jc == tc and td.any()


def test_nat_hash_parity():
    rng = np.random.default_rng(0)
    ip = rng.integers(-(1 << 31), (1 << 31) - 1, 4096).astype(np.int32)
    port = rng.integers(0, 65536, 4096).astype(np.int32)
    from repro.nf.nat import _hash as j_hash
    want = np.asarray(j_hash(jnp.asarray(ip), jnp.asarray(port), 1 << 14))
    got = t_hash(torch.from_numpy(ip), torch.from_numpy(port), 1 << 14)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("capacity,n_ips,n_ports", [
    (8, 6, 4),         # exhausted table: CLOCK aging and stale hits
    (64, 40, 2),       # repeat flows, mostly hits
    (1 << 14, 1 << 20, 1 << 10),  # the default table, mostly inserts
])
def test_nat_parity_over_several_batches(capacity, n_ips, n_ports):
    rng = np.random.default_rng(capacity)
    jn, tn = JNat(capacity=capacity), TNat(capacity=capacity)
    js, ts = jn.init_state(), tn.init_state("cpu")
    stale = 0
    for _ in range(6):
        d = CV.numpy_packets(rng, 48, PMAX, n_ips=n_ips, n_ports=n_ports,
                             alive_frac=0.9)
        js, jo, jd, _ = jn(js, jbatch(d), backend="ref")
        ts, to, td, _ = tn(ts, CV.packet_batch(d, "cpu"))
        assert_same(jo, to, "nat out")
        assert np.array_equal(np.asarray(jd), td.numpy())
        assert_nat_state(js, ts)
        stale = int(ts["stale_hits"])
    if capacity == 8:
        assert stale > 0, "the exhausted table should see stale mappings"


def test_nat_with_pipe_axis_matches_per_pipe_reference():
    rng = np.random.default_rng(11)
    jn, tn = JNat(capacity=8), TNat(capacity=8)
    ds = [CV.numpy_packets(rng, 32, PMAX, n_ips=6, n_ports=3)
          for _ in range(3)]
    stacked = {k: np.stack([d[k] for d in ds]) for k in ds[0]}
    ts, to, td, _ = tn(tn.init_state("cpu", pipes=3),
                       CV.packet_batch(stacked, "cpu"))
    for p in range(3):
        js, jo, jd, _ = jn(jn.init_state(), jbatch(ds[p]), backend="ref")
        assert np.array_equal(np.asarray(jo.src_port), to.src_port[p].numpy())
        assert np.array_equal(np.asarray(jd), td[p].numpy())
        assert_nat_state(js, {k: v[p] for k, v in ts.items()})


def test_chain_and_explicit_drops_parity():
    rng = np.random.default_rng(5)
    d = CV.numpy_packets(rng, 64, PMAX, n_ips=30, n_ports=4)
    d["pp_valid"][:] = True
    d["pp_enb"] = (rng.random(64) < 0.5).astype(np.int32)
    rules = tuple(int(v) for v in np.unique(d["src_ip"])[:5])
    jch = JC.Chain((JFw(rules=rules), JNat(capacity=8)))
    tch = TC.Chain((TFw(rules=rules), TNat(capacity=8)))
    jst, jo, jd, jcyc = jch.run(jch.init_state(), jbatch(d), backend="ref")
    tst, to, td, tcyc = tch.run(tch.init_state("cpu"),
                                CV.packet_batch(d, "cpu"))
    assert_same(jo, to, "chain out")
    assert np.array_equal(np.asarray(jd), td.numpy()) and jcyc == tcyc
    assert_same(JC.to_explicit_drops(jo, jd), TC.to_explicit_drops(to, td),
                "explicit drops")
    assert {k: int(v) for k, v in jch.state_counters(jst).items()} == \
        {k: int(v) for k, v in tch.state_counters(tst).items()}
    assert jch.cycle_costs(backend="ref") == tch.cycle_costs(device="cpu")


def test_convert_carries_chain_state_across():
    rng = np.random.default_rng(9)
    jch = JC.Chain((JFw(rules=(1, 2)), JNat(capacity=8)))
    tch = TC.Chain((TFw(rules=(1, 2)), TNat(capacity=8)))
    d = CV.numpy_packets(rng, 32, PMAX, n_ips=8, n_ports=2)
    jst, _, _, _ = jch.run(jch.init_state(), jbatch(d), backend="ref")
    tst = CV.chain_states(tch.nfs, jst, "cpu")
    d2 = CV.numpy_packets(rng, 32, PMAX, n_ips=8, n_ports=2)
    _, jo, _, _ = jch.run(jst, jbatch(d2), backend="ref")
    _, to, _, _ = tch.run(tst, CV.packet_batch(d2, "cpu"))
    assert_same(jo, to, "after carried state")
    assert jax.tree.leaves(jst)  # the reference state was non-trivial
