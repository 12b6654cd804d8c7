"""The NF chain's header pass as the port runs it, one ``nf_chain`` dispatch
per ``Chain.run``, against the reference's ``Chain.run`` on the same numpy
packets over several successive batches (so state carries across),
compared exactly: headers, drops, NAT tables and ``stale_hits``.  Also the
plain ``nat_insert`` against the reference's NAT ``lax.scan``, the chain
against its NFs run one by one, and the CUDA launcher's descriptors and
slicing, reachable without a card."""
import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import packet as JK  # noqa: E402
from repro.nf.chain import Chain as JChain  # noqa: E402
from repro.nf.firewall import Firewall as JFw  # noqa: E402
from repro.nf.macswap import MacSwap as JMac  # noqa: E402
from repro.nf.maglev import MaglevLB as JLb  # noqa: E402
from repro.nf.nat import Nat as JNat  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.backend import dispatch as tdispatch  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.nf.chain import Chain as TChain  # noqa: E402
from repro_torch.nf.firewall import Firewall as TFw  # noqa: E402
from repro_torch.nf.macswap import MacSwap as TMac  # noqa: E402
from repro_torch.nf.maglev import MaglevLB as TLb  # noqa: E402
from repro_torch.nf.nat import Nat as TNat  # noqa: E402

PMAX = 16
RULES = (1, 2, 3)  # blocked source addresses, drawn from the packets' pool


def jbatch(d):
    return JK.PacketBatch(**{k: jnp.asarray(v) for k, v in d.items()})


def assert_same(j, t, what):
    a, b = CV.as_numpy(j), CV.as_numpy(t)
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: field {k}"


def nfs(kinds, capacity, fault_target):
    """(reference NFs, port NFs) of the chain ``kinds``."""
    make = dict(
        fw=lambda m: m(rules=RULES),
        nat=lambda m: m(capacity=capacity),
        lb=lambda m: m(fault_target=fault_target),
        macswap=lambda m: m())
    ref = dict(fw=JFw, nat=JNat, lb=JLb, macswap=JMac)
    port = dict(fw=TFw, nat=TNat, lb=TLb, macswap=TMac)
    return (tuple(make[k](ref[k]) for k in kinds),
            tuple(make[k](port[k]) for k in kinds))


def batches(seed, n, pipes, b, n_ips, n_ports):
    """``n`` batches of numpy packets, (b,) or (pipes, b) each, from a
    small flow pool so flows repeat within and across batches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        per = [CV.numpy_packets(rng, b, PMAX, n_ips=n_ips, n_ports=n_ports,
                                alive_frac=0.85)
               for _ in range(pipes or 1)]
        out.append(per[0] if pipes is None
                   else {k: np.stack([p[k] for p in per]) for k in per[0]})
    return out


def lb_flags(mode, step, pipes):
    """The LB's ``lb_up`` at one batch: absent, 0-d (alternating) or one
    flag per pipe (a mix that changes each batch)."""
    if mode is None:
        return None
    if mode == "0d":
        return np.bool_(step % 2 == 0)
    return (np.arange(pipes) + step) % 3 != 0


def flag_at(up, p):
    if up is None or up.ndim == 0:
        return up
    return up[p]


# name: kinds, capacity, (n_ips, n_ports), pipes, fault_target, lb_up mode,
# the reference's backend for the firewall and the LB
CASES = {
    "fw,nat cap 8 (exhaustion, CLOCK aging, stale hits)":
        (("fw", "nat"), 8, (6, 4), None, -1, None, "ref"),
    "fw,nat cap 16, 3 pipes": (("fw", "nat"), 16, (10, 3), 3, -1, None, "ref"),
    "fw,nat cap 64, repeated flows":
        (("fw", "nat"), 64, (20, 2), 2, -1, None, "ref"),
    "fw,nat,lb cap 64, lb_up absent":
        (("fw", "nat", "lb"), 64, (30, 4), 2, 3, None, "ref"),
    "fw,nat,lb cap 16, lb_up 0-d":
        (("fw", "nat", "lb"), 16, (12, 3), None, 3, "0d", "ref"),
    "fw,nat,lb cap 64, lb_up per pipe":
        (("fw", "nat", "lb"), 64, (30, 4), 3, 3, "pipe", "ref"),
    "fw,nat,lb cap 64, lb_up per pipe, Pallas interpret":
        (("fw", "nat", "lb"), 64, (30, 4), 3, 3, "pipe", "pallas_interpret"),
    "fw,nat,lb no fault target, lb_up per pipe ignored":
        (("fw", "nat", "lb"), 16, (12, 3), 2, -1, "pipe", "ref"),
    "nat cap 8": (("nat",), 8, (5, 3), None, -1, None, "ref"),
    "nat cap 16, 2 pipes": (("nat",), 16, (9, 3), 2, -1, None, "ref"),
    "macswap": (("macswap",), 8, (8, 8), 2, -1, None, "ref"),
    "fw,nat,lb,macswap,nat cap 16": (("fw", "nat", "lb", "macswap", "nat"),
                                     16, (12, 3), None, 3, "0d", "ref"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_chain_run_matches_reference(name):
    kinds, cap, (n_ips, n_ports), pipes, fault, mode, jback = CASES[name]
    jnfs, tnfs = nfs(kinds, cap, fault)
    jch, tch = JChain(jnfs), TChain(tnfs)
    jst = [jch.init_state() for _ in range(pipes or 1)]
    tst = tch.init_state("cpu", pipes)
    evidence = dict(stale=0, dropped=0, repeats=0)
    for step, d in enumerate(batches(list(CASES).index(name), 4, pipes, 24,
                                     n_ips, n_ports)):
        up = lb_flags(mode, step, pipes or 1)
        tctx = None if up is None else {"lb_up": torch.from_numpy(
            np.asarray(up))}
        tst, to, td, tcyc = tch.run(tst, CV.packet_batch(d, "cpu"),
                                    ctx=tctx)
        for p in range(pipes or 1):
            dp = d if pipes is None else {k: v[p] for k, v in d.items()}
            u = flag_at(up, p)
            jctx = None if u is None else {"lb_up": jnp.asarray(u)}
            jst[p], jo, jd, jcyc = jch.run(jst[p], jbatch(dp),
                                           backend=jback, ctx=jctx)
            sel = (lambda t: t) if pipes is None else (lambda t: t[p])
            jn, tn = CV.as_numpy(jo), CV.as_numpy(to)
            for k in jn:
                assert np.array_equal(jn[k], sel(tn[k])), \
                    f"{name} step {step} pipe {p}: field {k}"
            assert np.array_equal(np.asarray(jd), sel(td).numpy())
            assert jcyc == tcyc
            for nf, js, ts in zip(tnfs, jst[p], tst):
                if isinstance(nf, TNat):
                    for k in ("key_ip", "key_port", "exp", "stale_hits"):
                        assert np.array_equal(np.asarray(js[k]),
                                              sel(ts[k]).numpy()), k
            keys = set()
            for ip, port, a in zip(dp["src_ip"], dp["src_port"],
                                   dp["alive"]):
                evidence["repeats"] += a and (ip, port) in keys
                keys.add((ip, port))
        evidence["dropped"] += int(td.sum())
        evidence["stale"] = sum(int(s["stale_hits"].sum()) for s in tst
                                if isinstance(s, dict) and "stale_hits" in s)
    assert evidence["repeats"] > 0, "no flow repeated inside a batch"
    if "nat" in kinds and cap == 8:
        assert evidence["stale"] > 0, "the small table saw no stale hit"
    if "fw" in kinds or ("nat" in kinds and cap == 8):
        assert evidence["dropped"] > 0


# --------------------------------------------------------------------------
# the plain nat_insert against the reference's lax.scan
# --------------------------------------------------------------------------

def _insert_vs_reference(d, state, cap, per_pipe):
    """R.nat_insert on ``d`` against the reference NAT on each pipe."""
    nat = JNat(capacity=cap)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    ts = {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}
    mapped, stale_hit, kip, kport, kexp = R.nat_insert(
        t["src_ip"], t["src_port"], t["alive"], ts["key_ip"],
        ts["key_port"], ts["exp"], cap, nat.base_port, nat.max_exp)
    for p in range(len(per_pipe)):
        sel = per_pipe[p]
        js = {k: jnp.asarray(sel(v)) for k, v in state.items()}
        js, jo, jd, _ = nat(js, jbatch({k: sel(v) for k, v in d.items()}))
        alive = sel(t["alive"])
        ok = alive & (sel(mapped) >= 0)
        assert np.array_equal(np.asarray(jd), (alive & ~ok).numpy())
        assert np.array_equal(np.asarray(jo.src_port), torch.where(
            ok, sel(mapped), sel(t["src_port"])).numpy())
        for k, v in (("key_ip", kip), ("key_port", kport), ("exp", kexp)):
            assert np.array_equal(np.asarray(js[k]), sel(v).numpy()), k
        assert int(js["stale_hits"]) - int(np.asarray(sel(
            state["stale_hits"]))) == int(sel(stale_hit).sum())
    return mapped


def _random_state(rng, lead, cap, n_ips, n_ports):
    """A NAT table with live, aged-out and free slots, keys drawn from the
    packets' flow pool."""
    exp = rng.integers(0, 3, lead + (cap,)).astype(np.int32)
    kip = rng.integers(1, 1 + n_ips, lead + (cap,)).astype(np.int32)
    kport = rng.integers(1024, 1024 + n_ports, lead + (cap,)).astype(np.int32)
    free = rng.random(lead + (cap,)) < 0.3
    kip[free], kport[free] = -1, -1
    return dict(key_ip=kip, key_port=kport, exp=exp,
                stale_hits=np.zeros(lead, np.int32))


@pytest.mark.parametrize("cap", [8, 16, 64])
def test_nat_insert_matches_reference_per_pipe(cap):
    rng = np.random.default_rng(cap)
    d = CV.numpy_packets(rng, 40, PMAX, n_ips=8, n_ports=4, alive_frac=0.8)
    state = _random_state(rng, (), cap, 8, 4)
    _insert_vs_reference(d, state, cap, [lambda v: v])


def test_nat_insert_with_pipe_axis_matches_reference():
    rng = np.random.default_rng(3)
    per = [CV.numpy_packets(rng, 32, PMAX, n_ips=8, n_ports=3,
                            alive_frac=0.8) for _ in range(3)]
    d = {k: np.stack([p[k] for p in per]) for k in per[0]}
    state = _random_state(rng, (3,), 16, 8, 3)
    _insert_vs_reference(d, state, 16,
                         [lambda v, p=p: v[p] for p in range(3)])


def test_nat_insert_window_wraps_at_the_end_of_the_table():
    """Flows that hash into the last 3 slots of a 16-slot table probe
    across its end: their ports are base_port + slot of the wrapped slot,
    as the reference's (h + i) % C gives them."""
    cap, base = 16, TNat().base_port
    rng = np.random.default_rng(5)
    ip = rng.integers(1, 1 << 30, 4096).astype(np.int32)
    port = rng.integers(1024, 65536, 4096).astype(np.int32)
    h = R.nat_hash(torch.from_numpy(ip), torch.from_numpy(port), cap).numpy()
    tail = np.flatnonzero(h >= cap - 3)[:10]
    d = CV.numpy_packets(rng, len(tail), PMAX)
    d["src_ip"], d["src_port"] = ip[tail], port[tail]
    d["alive"][:] = True
    empty = dict(key_ip=np.full(cap, -1, np.int32),
                 key_port=np.full(cap, -1, np.int32),
                 exp=np.zeros(cap, np.int32),
                 stale_hits=np.zeros((), np.int32))
    mapped = _insert_vs_reference(d, empty, cap, [lambda v: v]).numpy()
    assert (mapped >= 0).all() and (mapped - base < 8).any(), mapped


# --------------------------------------------------------------------------
# the kernel's NAT schedule: waves of packets whose probe windows are
# disjoint (ref.nat_waves)
# --------------------------------------------------------------------------

def _flow_packets(rng, lead, b, flows, cap, alive_frac=0.85):
    """(..., b) numpy packets whose (src_ip, src_port) come from ``flows``
    flows, and a NAT table of ``cap`` slots with live, aged-out and free
    slots whose keys come from the same flows."""
    pool_ip = rng.integers(1, 1 << 30, flows).astype(np.int32)
    pool_port = rng.integers(1024, 65536, flows).astype(np.int32)
    per = [CV.numpy_packets(rng, b, PMAX, alive_frac=alive_frac)
           for _ in range(math.prod(lead))]
    d = {k: np.stack([p[k] for p in per]).reshape(lead + per[0][k].shape)
         for k in per[0]}
    pick = rng.integers(0, flows, lead + (b,))
    d["src_ip"], d["src_port"] = pool_ip[pick], pool_port[pick]
    slot_flow = rng.integers(0, flows, lead + (cap,))
    kind = rng.integers(0, 3, lead + (cap,))
    state = dict(
        key_ip=np.where(kind < 2, pool_ip[slot_flow], -1).astype(np.int32),
        key_port=np.where(kind < 2, pool_port[slot_flow], -1).astype(
            np.int32),
        exp=np.where(kind == 0, rng.integers(1, 3, lead + (cap,)), 0).astype(
            np.int32),
        stale_hits=np.zeros(lead, np.int32))
    return d, state


def _walk_by_waves(d, state, cap, waves):
    """``R.nat_insert`` one packet at a time, wave after wave, each wave in
    reverse arrival order, pipe by pipe: (mapped, stale_hit, key_ip,
    key_port, exp) as the whole call returns them."""
    nat = TNat(capacity=cap)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    lead = t["src_ip"].shape[:-1]
    mapped = torch.full(t["src_ip"].shape, -1, dtype=torch.int32)
    stale = torch.zeros(t["src_ip"].shape, dtype=torch.bool)
    tables = [torch.from_numpy(state[k].copy())
              for k in ("key_ip", "key_port", "exp")]
    for p in np.ndindex(*lead):
        w = waves[p].tolist()
        for i in sorted((i for i, v in enumerate(w) if v),
                        key=lambda i: (w[i], -i)):
            one = [t[k][p + (slice(i, i + 1),)]
                   for k in ("src_ip", "src_port", "alive")]
            m, s, *new = R.nat_insert(*one, *(x[p] for x in tables), cap,
                                      nat.base_port, nat.max_exp)
            mapped[p + (i,)], stale[p + (i,)] = m[0], s[0]
            for x, n in zip(tables, new):
                x[p] = n
    return (mapped, stale, *tables)


@pytest.mark.parametrize("pipes", [None, 2])
@pytest.mark.parametrize("flows", [3, 40, 512])
@pytest.mark.parametrize("cap", [8, 12, 16, 64, 4096])
def test_walk_by_waves_equals_nat_insert_and_the_reference(cap, flows,
                                                           pipes):
    """Walking ``nat_waves``'s waves in order, each in reverse arrival
    order, gives exactly ``nat_insert``'s mapped ports, stale hits and
    tables, and the reference NAT's on the same numpy arrays: the packets
    of one wave commute, as the kernel's parallel walk needs."""
    rng = np.random.default_rng(cap * 1000 + flows + (pipes or 0))
    lead = () if pipes is None else (pipes,)
    d, state = _flow_packets(rng, lead, 96, flows, cap)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    waves = R.nat_waves(t["src_ip"], t["src_port"], t["alive"], cap)
    assert torch.equal(waves > 0, t["alive"])
    got = _walk_by_waves(d, state, cap, waves)
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    want = R.nat_insert(t["src_ip"], t["src_port"], t["alive"],
                        ts["key_ip"], ts["key_port"], ts["exp"], cap,
                        TNat().base_port, TNat().max_exp)
    for name, g, w in zip(("mapped", "stale_hit", "key_ip", "key_port",
                           "exp"), got, want):
        assert torch.equal(g, w), name
    per_pipe = ([lambda v: v] if pipes is None
                else [lambda v, p=p: v[p] for p in range(pipes)])
    assert torch.equal(_insert_vs_reference(d, state, cap, per_pipe),
                       want[0])
    if cap < 16:  # every pair of windows overlaps: one live packet a wave
        live = t["alive"].sum(-1)
        assert torch.equal(waves.amax(-1), live)


def _flows_hashing_to(targets, cap, seed=11):
    """One (src_ip, src_port) flow whose NAT hash is each target slot."""
    rng = np.random.default_rng(seed)
    ip = rng.integers(1, 1 << 30, 1 << 16).astype(np.int32)
    port = rng.integers(1024, 65536, 1 << 16).astype(np.int32)
    h = R.nat_hash(torch.from_numpy(ip), torch.from_numpy(port), cap).numpy()
    picks = [int(np.flatnonzero(h == s)[0]) for s in targets]
    return ip[picks], port[picks]


def _waves(ip, port, alive, cap, chunk=R.NAT_WAVE_CHUNK):
    return R.nat_waves(torch.from_numpy(np.asarray(ip, np.int32)),
                       torch.from_numpy(np.asarray(port, np.int32)),
                       torch.from_numpy(np.asarray(alive, bool)), cap,
                       chunk).tolist()


def test_nat_waves_hand_cases():
    cap = 64
    # one flow k times: depth k
    assert _waves([7] * 10, [1234] * 10, [True] * 10, cap) == \
        list(range(1, 11))
    # windows at C - 3 and 2 overlap across the table's end; at C - 3 and
    # 5 they touch nothing in common ((5 - (C - 3)) mod C = 8)
    ip, port = _flows_hashing_to([cap - 3, 2, 5], cap)
    assert _waves(ip[:2], port[:2], [True, True], cap) == [1, 2]
    assert _waves(ip[::2], port[::2], [True, True], cap) == [1, 1]
    # disjoint windows: one wave
    ip, port = _flows_hashing_to([0, 8, 16, 40, 56], cap)
    assert _waves(ip, port, [True] * 5, cap) == [1] * 5
    # a dead packet takes no wave and holds no one back
    assert _waves([7] * 3, [99] * 3, [True, False, True], cap) == [1, 0, 2]
    assert _waves([7] * 3, [99] * 3, [False] * 3, cap) == [0, 0, 0]
    # below 16 slots every pair of windows overlaps, distinct flows or not
    for small in (8, 12):
        ip, port = _flows_hashing_to(range(6), small)
        assert _waves(ip, port, [True] * 6, small) == list(range(1, 7))
    ip, port = _flows_hashing_to([0, 8], 16)  # 16 slots: two disjoint
    assert _waves(ip, port, [True, True], 16) == [1, 1]
    # chunks: the second chunk's waves follow the first one's depth, and a
    # flow repeated across chunks goes on counting
    assert _waves([7] * 300, [1] * 300, [True] * 300, cap) == \
        list(range(1, 301))
    ip, port = _flows_hashing_to([0, 8, 16, 24], cap)
    waves = _waves(list(ip) * 2, list(port) * 2, [True] * 8, cap, chunk=4)
    assert waves == [1] * 4 + [2] * 4
    waves = _waves([5, 5, 5, 6], [1, 1, 1, 2], [True] * 4, 4096, chunk=2)
    assert waves[:2] == [1, 2] and waves[2] == 3


def test_nat_waves_with_a_pipe_axis_are_per_pipe():
    rng = np.random.default_rng(4)
    d, _ = _flow_packets(rng, (3,), 64, 40, 64)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    whole = R.nat_waves(t["src_ip"], t["src_port"], t["alive"], 64)
    for p in range(3):
        assert torch.equal(whole[p], R.nat_waves(
            t["src_ip"][p], t["src_port"][p], t["alive"][p], 64))


def test_kernel_wave_chunk_is_the_plain_versions():
    from pathlib import Path
    src = (Path(R.__file__).parent.parent / "csrc" / "nf_chain.cu").read_text()
    assert f"constexpr int kChunk = {R.NAT_WAVE_CHUNK};" in src


# --------------------------------------------------------------------------
# the port's own pieces: one stage at a time, and longer chains
# --------------------------------------------------------------------------

def _one_by_one(chain, states, pkts, ctx):
    dropped = torch.zeros_like(pkts.alive)
    out_states = []
    for nf, st in zip(chain.nfs, states):
        st, pkts, drop, _ = nf(st, pkts, ctx=ctx)
        dropped |= drop
        out_states.append(st)
    return tuple(out_states), pkts, dropped


def _same_states(a, b):
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("n_nfs", [4, 10])
def test_chain_equals_its_nfs_one_by_one(n_nfs):
    """One ``nf_chain`` over the whole chain equals its NFs' one-stage
    calls in turn; 10 NFs are past the kernel's stage limit, so on the
    card they run as two launches, here through the plain version."""
    from repro_torch.kernels.nf_chain import MAX_STAGES
    kinds = ("fw", "nat", "lb", "macswap", "nat", "fw", "lb", "macswap",
             "nat", "macswap")[:n_nfs]
    assert (n_nfs > MAX_STAGES) == (n_nfs == 10)
    _, tnfs = nfs(kinds, 16, 3)
    chain = TChain(tnfs)
    states = chain.init_state("cpu", 2)
    ctx = {"lb_up": torch.tensor([True, False])}
    for step, d in enumerate(batches(n_nfs, 3, 2, 24, 10, 3)):
        pkts = CV.packet_batch(d, "cpu")
        got = chain.run(states, pkts, ctx=ctx)
        want = _one_by_one(chain, states, pkts, ctx)
        assert_same(want[1], got[1], f"step {step}")
        assert torch.equal(want[2], got[2])
        _same_states(want[0], got[0])
        states = got[0]


def test_chain_run_makes_one_nf_chain_dispatch(monkeypatch):
    from repro_torch.nf import chain as C
    calls = []
    inner = C.dispatch

    def counted(name, backend=None):
        calls.append(name)
        return inner(name, backend)

    monkeypatch.setattr(C, "dispatch", counted)
    _, tnfs = nfs(("fw", "nat", "lb", "macswap"), 16, 3)
    chain = TChain(tnfs)
    d = batches(0, 1, 2, 16, 10, 3)[0]
    chain.run(chain.init_state("cpu", 2), CV.packet_batch(d, "cpu"),
              ctx={"lb_up": torch.tensor([True, False])})
    assert calls == ["nf_chain"]


def test_registry_device_rules_on_cpu():
    _, tnfs = nfs(("fw", "nat"), 16, -1)
    chain = TChain(tnfs)
    pkts = CV.packet_batch(batches(1, 1, None, 16, 10, 3)[0], "cpu")
    fields = tuple(getattr(pkts, f) for f in R.NF_FIELDS)
    stages = chain.stages(chain.init_state("cpu"))
    with pytest.raises(RuntimeError):
        tdispatch("nf_chain", "cuda")(fields, stages)
    auto = tdispatch("nf_chain", "auto")(fields, stages)
    ref = tdispatch("nf_chain", "ref")(fields, stages)
    assert all(torch.equal(a, b) for a, b in zip(auto[0], ref[0]))
    assert launch_counts()["nf_chain"] == 0


# --------------------------------------------------------------------------
# the CUDA launcher's descriptors and slicing, reachable without a card
# --------------------------------------------------------------------------

def _fake_library(monkeypatch, module, calls):
    """Point ``module``'s wrapper at C functions built from
    ``build.SIGNATURES`` (ctypes raises on a count or type the signature
    does not take); ``pp_nf_chain`` also records its stage descriptors,
    read while the call holds them.  The launch counter is restored
    afterwards."""
    from repro_torch.kernels import build

    class Lib:
        pass

    def record(name, args):
        words = None
        if name == "pp_nf_chain":
            n = args[19]
            words = list((ctypes.c_int64 * (module.DESC_WORDS * n))
                         .from_address(args[18])) if n else []
        calls.append((name, args, words))
        return 0

    lib = Lib()
    for name, argtypes in build.SIGNATURES.items():
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
        setattr(lib, name, proto(lambda *a, name=name: record(name, a)))
    monkeypatch.setattr(module, "library", lambda: lib)
    monkeypatch.setattr(module, "require_cuda",
                        lambda name, *t: torch.device("cpu"))
    monkeypatch.setattr(module, "stream_handle", lambda dev: 0)
    monkeypatch.setitem(trace.COUNTERS, module.COUNT,
                        trace.COUNTERS[module.COUNT])


def _stages_and_fields(kinds, cap, pipes, b):
    _, tnfs = nfs(kinds, cap, 3)
    chain = TChain(tnfs)
    pkts = CV.packet_batch(batches(2, 1, pipes, b, 10, 3)[0], "cpu")
    ctx = {"lb_up": torch.ones(pipes, dtype=torch.bool)}
    return (tuple(getattr(pkts, f) for f in R.NF_FIELDS),
            chain.stages(chain.init_state("cpu", pipes), ctx))


@pytest.mark.parametrize("cap,smem", [(16, 192), (16384, 196608),
                                      (32768, 0)])
def test_nf_chain_binding_matches_its_signature(monkeypatch, cap, smem):
    """One launch for a 3-stage chain: 24 arguments, the stage kinds and
    NAT's constants in the descriptors, the table staged in shared memory
    up to MAX_SHARED bytes and walked in device memory past it."""
    from repro_torch.kernels import build
    from repro_torch.kernels import nf_chain as NC
    calls = []
    _fake_library(monkeypatch, NC, calls)
    before = trace.COUNTERS[NC.COUNT]
    fields, stages = _stages_and_fields(("fw", "nat", "lb"), cap, 2, 8)
    out, dropped, states = NC.nf_chain_cuda(fields, stages)
    assert [c[0] for c in calls] == ["pp_nf_chain"]
    name, args, words = calls[0]
    assert len(args) == len(build.SIGNATURES["pp_nf_chain"]) == 24
    assert args[16] is None                       # no earlier drops
    assert args[19:23] == (3, 2, 8, smem)          # stages, pipes, b, smem
    desc = [words[i:i + NC.DESC_WORDS] for i in range(0, len(words),
                                                      NC.DESC_WORDS)]
    assert [w[0] for w in desc] == [0, 1, 2]       # fw, nat, lb
    nat = TNat(capacity=cap)
    assert desc[0][9] == len(RULES)
    assert desc[1][9:14] == [cap, nat.base_port, nat.max_exp, nat.nat_ip,
                             int(smem > 0)]
    assert desc[2][9:11] == [251, 1]               # T, one flag per pipe
    assert trace.COUNTERS[NC.COUNT] == before + 1
    assert [t.dtype for t in out] == [torch.bool] + [torch.int32] * 7
    assert dropped.dtype == torch.bool and tuple(dropped.shape) == (2, 8)
    assert tuple(states[1][0].shape) == (2, cap)
    assert states[1][0] is not stages[1].state[0]  # new tables


def test_nf_chain_cuda_splits_a_long_chain_into_launches(monkeypatch):
    from repro_torch.kernels import nf_chain as NC
    calls = []
    _fake_library(monkeypatch, NC, calls)
    before = trace.COUNTERS[NC.COUNT]
    kinds = ("fw", "nat", "lb", "macswap") * 3
    fields, stages = _stages_and_fields(kinds, 16, 2, 8)
    NC.nf_chain_cuda(fields, stages)
    assert [c[1][19] for c in calls] == [NC.MAX_STAGES, 12 - NC.MAX_STAGES]
    first, second = calls[0][1], calls[1][1]
    assert second[:8] == first[8:16]   # the fields the first launch wrote
    assert second[16] == first[17]     # and its drops
    assert trace.COUNTERS[NC.COUNT] == before + 2
    # a chain without stages writes only the drops, in one launch: every
    # field is its own output
    calls.clear()
    NC.nf_chain_cuda(fields, ())
    assert [c[1][19] for c in calls] == [0]
    assert calls[0][1][8:16] == calls[0][1][:8]


@pytest.mark.parametrize("kinds", [("fw",), ("nat",), ("lb",), ("macswap",),
                                   ("fw", "nat"), ("fw", "nat", "lb")])
def test_fields_no_stage_writes_come_back_as_they_went_in(monkeypatch,
                                                          kinds):
    """The plain version returns new tensors for exactly the fields its
    stages write (``NF_WRITES``) and the others as they came in; the
    launcher hands those others to the kernel as their own outputs (so it
    neither copies nor writes them) and returns them the same way."""
    from repro_torch.kernels import nf_chain as NC
    fields, stages = _stages_and_fields(kinds, 16, 2, 8)
    written = [f in {w for k in kinds for w in R.NF_WRITES[k]}
               for f in R.NF_FIELDS]
    plain = R.nf_chain(fields, stages)[0]
    assert [p is not f for p, f in zip(plain, fields)] == written
    calls = []
    _fake_library(monkeypatch, NC, calls)
    out = NC.nf_chain_cuda(fields, stages)[0]
    args = calls[0][1]
    assert [args[8 + i] != args[i] for i in range(8)] == written
    assert [o is not f for o, f in zip(out, fields)] == written


def test_kernel_hash_constants_are_the_plain_versions():
    """The NAT hash's literals in the CUDA source are those the plain
    version (and the reference) multiply by: a mismatch past the low bits
    shows only in tables larger than 8 slots."""
    from pathlib import Path
    src = (Path(R.__file__).parent.parent / "csrc" / "nf_chain.cu").read_text()
    for name, value in zip(("kNatSeed", "kNatMul1", "kNatMul2"),
                           R.NAT_HASH_CONSTS):
        assert f"constexpr int32_t {name} = {value};" in src, name
    ip = torch.tensor([0, 1, -7, 123456789], dtype=torch.int32)
    port = torch.tensor([0, 2, 65535, 1024], dtype=torch.int32)
    from repro.nf.nat import _hash as j_hash
    for cap in (8, 4096, 32768):
        assert np.array_equal(
            np.asarray(j_hash(jnp.asarray(ip.numpy()),
                              jnp.asarray(port.numpy()), cap)),
            R.nat_hash(ip, port, cap).numpy())


def test_nf_chain_cuda_raises_on_cpu_tensors():
    from repro_torch.kernels import nf_chain as NC
    fields, stages = _stages_and_fields(("fw", "nat"), 16, 2, 8)
    with pytest.raises(RuntimeError):
        NC.nf_chain_cuda(fields, stages)
    assert launch_counts()["nf_chain"] == 0
