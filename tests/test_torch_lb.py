"""The port's Maglev LB, MAC swapper and the FW -> NAT -> LB chain against the
reference on the same numpy inputs, exactly: lookup tables, per-packet
selection with shared and per-pipe (live or degraded) tables, chain
conversion, and the engine at the TINY geometry with an LB fault."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.backend import dispatch as jdispatch  # noqa: E402
from repro.configs.sweeps import TINY  # noqa: E402
from repro.core import packet as JK  # noqa: E402
from repro.core import park as JP  # noqa: E402
from repro.nf import maglev as JM  # noqa: E402
from repro.nf.chain import Chain as JChain  # noqa: E402
from repro.nf.firewall import Firewall as JFw  # noqa: E402
from repro.nf.macswap import NF_HEAVY  # noqa: E402
from repro.nf.macswap import MacSwap as JMac  # noqa: E402
from repro.nf.nat import Nat as JNat  # noqa: E402
from repro.switchsim import engine as JE  # noqa: E402
from repro.switchsim import faults as JF  # noqa: E402
from repro.traffic import generator as JG  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.core import packet as TK  # noqa: E402
from repro_torch.core import park as TP  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.nf import maglev as TM  # noqa: E402
from repro_torch.nf.chain import Chain as TChain  # noqa: E402
from repro_torch.nf.firewall import Firewall as TFw  # noqa: E402
from repro_torch.nf.macswap import MacSwap as TMac  # noqa: E402
from repro_torch.nf.nat import Nat as TNat  # noqa: E402
from repro_torch.switchsim import engine as TE  # noqa: E402
from repro_torch.switchsim import faults as TF  # noqa: E402
from repro_torch.traffic import generator as TG  # noqa: E402

PMAX = 64
PIPES = 2
LB_FAULT = dict(kind="lb", backend=3, start=1, duration=3)


def jbatch(d):
    return JK.PacketBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_same(j, t, what):
    a, b = CV.as_numpy(j), CV.as_numpy(t)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: field {k}"


def pipe_packets(seed, pipes, b, alive_frac=0.8):
    """(pipes, b) numpy packets, stacked field by field."""
    rng = np.random.default_rng(seed)
    per = [CV.numpy_packets(rng, b, PMAX, alive_frac=alive_frac)
           for _ in range(pipes)]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


# --------------------------------------------------------------------------
# lookup tables and the selection primitive
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [251, 1021])
def test_tables_equal_reference(size):
    lb = JM.MaglevLB()
    assert np.array_equal(TM.build_table(lb.backends, size),
                          JM.build_table(lb.backends, size))
    for dead in (0, 3, 7):
        want = JM.degraded_table(lb.backends, size, dead)
        got = TM.degraded_table(lb.backends, size, dead)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert dead not in set(got.tolist())
    assert [TM._mix64(s, b) for s in (1, 2) for b in range(9)] == \
        [JM._mix64(s, b) for s in (1, 2) for b in range(9)]


@pytest.mark.parametrize("b", [5, 300])
def test_plain_maglev_select_with_per_pipe_table(b):
    rng = np.random.default_rng(b)
    f = [rng.integers(-(1 << 31), (1 << 31) - 1, (3, b)).astype(np.int32)
         for _ in range(5)]
    live = JM.build_table(JM.MaglevLB().backends, 251)
    tables = np.stack([live, JM.degraded_table(JM.MaglevLB().backends, 251,
                                               3), live])
    bips = rng.integers(0, 1 << 30, 8).astype(np.int32)
    got = R.maglev_select(*(torch.from_numpy(a) for a in f),
                          torch.from_numpy(tables), torch.from_numpy(bips))
    shared = R.maglev_select(*(torch.from_numpy(a) for a in f),
                             torch.from_numpy(live), torch.from_numpy(bips))
    for p in range(3):
        want = np.asarray(jdispatch("maglev_select", "ref")(
            *(jnp.asarray(a[p]) for a in f), jnp.asarray(tables[p]),
            jnp.asarray(bips)))
        assert np.array_equal(got[p].numpy(), want)
        want_live = np.asarray(jdispatch("maglev_select", "ref")(
            *(jnp.asarray(a[p]) for a in f), jnp.asarray(live),
            jnp.asarray(bips)))
        assert np.array_equal(shared[p].numpy(), want_live)
    assert not torch.equal(got[1], shared[1])  # the degraded row was read


# --------------------------------------------------------------------------
# the NFs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("up", [True, False])
@pytest.mark.parametrize("fault_target", [-1, 3])
def test_maglev_lb_scalar_flag(fault_target, up):
    d = CV.numpy_packets(np.random.default_rng(7), 300, PMAX, alive_frac=0.8)
    jlb, tlb = JM.MaglevLB(fault_target=fault_target), \
        TM.MaglevLB(fault_target=fault_target)
    jst, tst = jlb.init_state(), tlb.init_state("cpu")
    assert set(jst) == set(tst)
    for k in jst:
        assert np.array_equal(np.asarray(jst[k]), tst[k].numpy()), k
    _, jo, jd, jc = jlb(jst, jbatch(d), backend="ref",
                        ctx={"lb_up": jnp.asarray(up)})
    _, to, td, tc = tlb(tst, CV.packet_batch(d, "cpu"),
                        ctx={"lb_up": torch.tensor(up)})
    assert_same(jo, to, "lb out")
    assert np.array_equal(np.asarray(jd), td.numpy()) and jc == tc
    dead_ip = JM.MaglevLB().backends[3]
    hit_dead = bool((to.dst_ip[to.alive] == dead_ip).any())
    assert hit_dead == (fault_target < 0 or up)


@pytest.mark.parametrize("fault_target", [-1, 3])
def test_maglev_lb_per_pipe_flag(fault_target):
    """The engine hands the LB one flag per pipe; the reference vmaps."""
    d = pipe_packets(11, 3, 200)
    up = np.array([True, False, True])
    jlb, tlb = JM.MaglevLB(fault_target=fault_target), \
        TM.MaglevLB(fault_target=fault_target)
    jst = jlb.init_state()

    def one(pk, u):
        return jlb(jst, pk, backend="ref", ctx={"lb_up": u})[1]

    jo = jax.vmap(one)(jbatch(d), jnp.asarray(up))
    _, to, td, _ = tlb(tlb.init_state("cpu", 3), CV.packet_batch(d, "cpu"),
                       ctx={"lb_up": torch.from_numpy(up)})
    assert_same(jo, to, "lb out per pipe")
    assert not td.any()


def test_macswap_parity():
    d = CV.numpy_packets(np.random.default_rng(3), 100, PMAX, alive_frac=0.7)
    jm, tm = JMac(cycles=NF_HEAVY), TMac(cycles=NF_HEAVY)
    _, jo, jd, jc = jm(jm.init_state(), jbatch(d))
    _, to, td, tc = tm(tm.init_state("cpu"), CV.packet_batch(d, "cpu"))
    assert_same(jo, to, "macswap out")
    assert np.array_equal(np.asarray(jd), td.numpy()) and jc == tc
    assert tm.init_state("cpu") == () and TMac().cycles == JMac().cycles


def _ref_chain(rules):
    return JChain((JFw(rules=rules), JNat(capacity=512, max_exp=3),
                   JM.MaglevLB(table_size=1021, fault_target=3),
                   JMac(cycles=NF_HEAVY)))


def test_convert_chain_and_states_for_all_four_nfs():
    rules = (5, 9, 11)
    src = _ref_chain(rules)
    port = CV.chain(src)
    assert port == TChain((TFw(rules=rules), TNat(capacity=512, max_exp=3),
                           TM.MaglevLB(table_size=1021, fault_target=3),
                           TMac(cycles=NF_HEAVY)))
    assert port.cycle_costs(device="cpu") == src.cycle_costs(backend="ref")
    # per-pipe reference states (as the vmapped engine keeps them) and
    # single ones both convert; shared configuration keeps one row
    jst = src.init_state()
    per_pipe = jax.tree.map(lambda a: jnp.stack([a, a]), jst)
    for states in (jst, per_pipe):
        got = CV.chain_states(port.nfs, states, "cpu")
        want = port.init_state("cpu")
        assert torch.equal(got[0], want[0])
        lead = np.asarray(states[1]["key_ip"]).shape[:-1]
        for k in want[1]:
            assert tuple(got[1][k].shape) == lead + tuple(want[1][k].shape)
        assert set(got[2]) == {"table", "backend_ips", "table_down"}
        for k in want[2]:
            assert torch.equal(got[2][k], want[2][k]), k
        assert got[3] == ()
    with pytest.raises(TypeError):
        CV.chain(JChain((object(),)))


# --------------------------------------------------------------------------
# FW -> NAT -> LB through the engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traces():
    rng = np.random.default_rng(2006)
    d = CV.numpy_packets(rng, TINY.packets, TINY.pmax, n_ips=120, n_ports=4)
    jp = jbatch(d)
    tp = CV.packet_batch(d, "cpu")
    js, _ = JG.steer_pipes(jp, PIPES, chunk=TINY.chunk)
    ts, _ = TG.steer_pipes(tp, PIPES, chunk=TINY.chunk)
    jtr = jax.tree.map(lambda a: a.reshape(
        (PIPES, a.shape[1] // TINY.chunk, TINY.chunk) + a.shape[2:]), js)
    rules = tuple(int(v) for v in np.unique(d["src_ip"])[:20])
    return rules, jtr, TK.to_time_major(ts, TINY.chunk)


def _wire_np(merged, flat):
    m = TK.map_fields(lambda n, a: a.reshape(
        (-1, a.shape[-1]) if n == "payload" else (-1,)), merged)
    return [x.numpy() for x in TK.wire_bytes(m)] if flat else m


@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("recirc", [False, True])
def test_fw_nat_lb_run_pipes_parity(traces, recirc, fault):
    rules, jtr, ttr = traces
    kw = dict(capacity=256, max_exp=4, pmax=TINY.pmax, recirculation=recirc)
    target = 3 if fault else -1
    jch = JChain((JFw(rules=rules), JNat(),
                  JM.MaglevLB(fault_target=target)))
    tch = CV.chain(jch)
    jr = JE.run_pipes(JP.ParkConfig(**kw), jch, jtr, window=TINY.window,
                      backend="ref",
                      faults=JF.FaultSpec(**LB_FAULT) if fault else None)
    tr = TE.run_pipes(TP.ParkConfig(**kw), tch, ttr, window=TINY.window,
                      faults=TF.FaultSpec(**LB_FAULT) if fault else None,
                      device="cpu")
    assert jr.counters == tr.counters
    assert jr.per_pipe_counters == tr.per_pipe_counters
    assert [t.as_dict() for t in jr.per_pipe_telemetry] == \
        [t.as_dict() for t in tr.per_pipe_telemetry]
    assert jr.nf_counters == tr.nf_counters
    assert jr.per_pipe_nf_counters == tr.per_pipe_nf_counters
    assert np.array_equal(np.asarray(jr.per_pipe_occ_series),
                          tr.per_pipe_occ_series)
    assert jr.per_pipe_peak_occupancy == tr.per_pipe_peak_occupancy
    jm = JK.PacketBatch(**{n: np.asarray(getattr(jr.merged, n)).reshape(
        (-1, TINY.pmax) if n == "payload" else (-1,)) for n in TK.FIELDS})
    jb, jl = JK.wire_bytes(jm)
    tb, tl = _wire_np(tr.merged, flat=True)
    assert np.array_equal(np.asarray(jb), tb)
    assert np.array_equal(np.asarray(jl), tl)
    assert JE.goodput_gain(jr) == TE.goodput_gain(tr)
    if recirc:
        assert tr.counters["recirculations"] > 0
    dst = _wire_np(tr.merged, flat=False)
    dead_ip = TM.MaglevLB().backends[3]
    hit_dead = (dst.dst_ip[dst.alive] == dead_ip).sum()
    # healthy runs balance onto every backend; during the fault the dead
    # one is skipped, and it serves again after the window
    assert hit_dead > 0
    assert all(v == 0 for v in launch_counts().values())


def test_lb_fault_changes_only_the_fault_window(traces):
    rules, _, ttr = traces
    cfg = TP.ParkConfig(capacity=256, max_exp=4, pmax=TINY.pmax)
    ch = TChain((TFw(rules=rules), TNat(), TM.MaglevLB(fault_target=3)))
    healthy = TE.run_pipes(cfg, ch, ttr, window=TINY.window, device="cpu")
    faulted = TE.run_pipes(cfg, ch, ttr, window=TINY.window, device="cpu",
                           faults=TF.FaultSpec(**LB_FAULT))
    # merged chunk k is the chunk the chain served at step k
    differ = (healthy.merged.dst_ip != faulted.merged.dst_ip).any(dim=-1)
    served = sorted(set(torch.nonzero(differ)[:, 1].tolist()))
    start, end = LB_FAULT["start"], LB_FAULT["start"] + LB_FAULT["duration"]
    assert served and all(start <= k < end for k in served)
    assert healthy.counters == faulted.counters
    assert healthy.telemetry == faulted.telemetry
