"""Split's and Merge's control passes as the port runs them, one primitive
each (``split_control``, ``merge_stage``), against the reference's
``_split_control`` / ``_merge_control`` plus its ``crc16_tag`` and
``payload_fetch`` (``backend="ref"``), on the same numpy inputs, compared
exactly; plus the bindings of the two CUDA launchers, reachable without a
card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backend import dispatch as jdispatch  # noqa: E402
from repro.core import packet as JK  # noqa: E402
from repro.core import park as JP  # noqa: E402
from repro_torch import convert as CV  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.backend import dispatch as tdispatch  # noqa: E402
from repro_torch.core.packet import OP_DROP  # noqa: E402
from repro_torch.core.park import ParkConfig  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402

SPLIT_KEYS = ("enb", "ti", "clk", "evicted", "skip_occupied", "skip_small",
              "park_len")
MERGE_KEYS = ("matched", "premature", "crc_fail", "disabled", "is_drop_op",
              "park_len")
W = 32  # parked row width of the merge cases (a multiple of 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _meta(rng, m, max_exp, max_clk):
    """Random (expiry, generation, length) tables with free and live
    slots."""
    exp = rng.integers(0, max_exp + 1, m).astype(np.int32)
    gen = np.where(exp > 0, rng.integers(1, max_clk, m), 0).astype(np.int32)
    ln = np.where(exp > 0, rng.integers(1, 161, m), 0).astype(np.int32)
    return exp, gen, ln


def _jstate(m, ti, clk, exp, gen, ln, ptable=None):
    ptable = np.zeros((m, W), np.uint8) if ptable is None else ptable
    return JP.ParkState(jnp.int32(ti), jnp.int32(clk), jnp.asarray(exp),
                        jnp.asarray(gen), jnp.asarray(ln),
                        jnp.asarray(ptable), jnp.zeros(16, jnp.int32))


def _jpackets(rng, fields):
    d = CV.numpy_packets(rng, len(fields["alive"]), 8)
    d.update(fields)
    return JK.PacketBatch(**{k: jnp.asarray(v) for k, v in d.items()})


# --------------------------------------------------------------------------
# split_control
# --------------------------------------------------------------------------

SPLIT_CFGS = {"exp1": dict(max_exp=1, max_clk=1 << 16),
              "exp3 clk7": dict(max_exp=3, max_clk=7)}


def _split_case(rng, m, b, cfg, alive_frac=0.85):
    exp, gen, ln = _meta(rng, m, cfg["max_exp"], cfg["max_clk"])
    regs = (int(rng.integers(0, m)), int(rng.integers(0, cfg["max_clk"])))
    pkts = dict(alive=rng.random(b) < alive_frac,
                payload_len=rng.integers(0, 400, b).astype(np.int32))
    return regs, (exp, gen, ln), pkts


def _split_reference(m, cfg, regs, meta, pkts, rng):
    jcfg = JP.ParkConfig(capacity=m, **cfg)
    (ti, clk, *jmeta), d = JP._split_control(
        jcfg, _jstate(m, *regs, *meta), _jpackets(rng, pkts))
    crc = JP.crc16_tag(d["ti"], d["clk"], backend="ref")
    want = {k: np.asarray(d[k]) for k in SPLIT_KEYS}
    want["crc"] = np.asarray(crc)
    return (np.asarray(ti), np.asarray(clk), *map(np.asarray, jmeta)), want


def _split_port(m, cfg, regs, meta, pkts):
    pcfg = ParkConfig(capacity=m, **cfg)
    return tdispatch("split_control", "ref")(
        m, cfg["max_exp"], cfg["max_clk"], pcfg.min_park_len,
        pcfg.pass_bytes, _t(np.int32(regs[0])), _t(np.int32(regs[1])),
        *map(_t, meta), _t(pkts["alive"]), _t(pkts["payload_len"]))


def _same(got, want, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == np.asarray(want).dtype, (what, got.dtype)
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("cfg", list(SPLIT_CFGS))
@pytest.mark.parametrize("b", [8, 32, 96])
@pytest.mark.parametrize("m", [16, 64])
def test_split_control_matches_reference(m, b, cfg):
    rng = np.random.default_rng(1000 * m + b + len(cfg))
    regs, meta, pkts = _split_case(rng, m, b, SPLIT_CFGS[cfg])
    want_state, want = _split_reference(m, SPLIT_CFGS[cfg], regs, meta,
                                        pkts, rng)
    got_state, got = _split_port(m, SPLIT_CFGS[cfg], regs, meta, pkts)
    for i, (g, w) in enumerate(zip(got_state, want_state)):
        _same(g, w, f"state {i}")
    assert set(got) == set(SPLIT_KEYS) | {"crc"}
    for k in got:
        _same(got[k], want[k], k)


def test_split_control_more_eligible_packets_than_slots():
    """96 eligible packets on a 16-slot table: each slot is probed six
    times, claimed, skipped while occupied and evicted in turn."""
    rng = np.random.default_rng(5)
    cfg = dict(max_exp=2, max_clk=1 << 16)
    m, b = 16, 96
    _, meta, _ = _split_case(rng, m, b, cfg)
    pkts = dict(alive=np.ones(b, bool),
                payload_len=rng.integers(160, 400, b).astype(np.int32))
    want_state, want = _split_reference(m, cfg, (3, 9), meta, pkts, rng)
    got_state, got = _split_port(m, cfg, (3, 9), meta, pkts)
    for i, (g, w) in enumerate(zip(got_state, want_state)):
        _same(g, w, f"state {i}")
    for k in got:
        _same(got[k], want[k], k)
    assert want["evicted"].any() and want["skip_occupied"].any()


@pytest.mark.parametrize("m", [16, 64])
def test_split_control_with_pipe_axis_matches_per_pipe_reference(m):
    rng = np.random.default_rng(m)
    cfg = SPLIT_CFGS["exp3 clk7"]
    cases = [_split_case(rng, m, 32, cfg) for _ in range(3)]
    regs = [np.array([c[0][i] for c in cases], np.int32) for i in (0, 1)]
    meta = [np.stack([c[1][i] for c in cases]) for i in range(3)]
    pkts = {k: np.stack([c[2][k] for c in cases]) for k in cases[0][2]}
    pcfg = ParkConfig(capacity=m, **cfg)
    got_state, got = tdispatch("split_control", "ref")(
        m, cfg["max_exp"], cfg["max_clk"], pcfg.min_park_len,
        pcfg.pass_bytes, *map(_t, regs), *map(_t, meta),
        _t(pkts["alive"]), _t(pkts["payload_len"]))
    for p, c in enumerate(cases):
        want_state, want = _split_reference(m, cfg, *c, rng)
        for i, (g, w) in enumerate(zip(got_state, want_state)):
            _same(g[p], w, f"pipe {p} state {i}")
        for k in got:
            _same(got[k][p], want[k], f"pipe {p} {k}")


# --------------------------------------------------------------------------
# split_control's kernel schedule: rounds of distinct slots, and blocks
# that each own a range of slots
# --------------------------------------------------------------------------


def _rounds_case(name):
    """(cfg, m, regs, meta, pkts) of one edge case of the per-slot walk,
    the registers and packets with a leading pipe axis of 3 for
    ``pipe axis``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cfg, m, b = dict(max_exp=2, max_clk=1 << 16), 64, 48
    if name == "heavy wrap":  # each slot probed ~60 times
        cfg, m, b = dict(max_exp=3, max_clk=1 << 16), 16, 1024
    if name == "pipe axis":
        cfg = SPLIT_CFGS["exp3 clk7"]
        cases = [_split_case(rng, 16, 96, cfg) for _ in range(3)]
        regs = [np.array([c[0][i] for c in cases], np.int32) for i in (0, 1)]
        meta = [np.stack([c[1][i] for c in cases]) for i in range(3)]
        pkts = {k: np.stack([c[2][k] for c in cases]) for k in cases[0][2]}
        return cfg, 16, regs, meta, pkts
    regs, meta, pkts = _split_case(rng, m, b, cfg)
    if name == "heavy wrap":
        pkts["payload_len"] = rng.integers(100, 400, b).astype(np.int32)
    if name == "TI at M-1":
        regs = (m - 1, regs[1])
    if name == "CLK one short of max_clk":
        regs = (regs[0], cfg["max_clk"] - 1)
    if name == "all masked":
        pkts["alive"][:] = False
    if name == "ineligible before the first eligible":
        pkts["alive"][:5] = [False, True, True, False, True]
        pkts["payload_len"][:5] = [300, 10, 159, 300, 300]
    return cfg, m, regs, meta, pkts


ROUNDS_CASES = ("distinct slots", "heavy wrap", "TI at M-1",
                "CLK one short of max_clk", "all masked",
                "ineligible before the first eligible", "pipe axis")


@pytest.mark.parametrize("name", ROUNDS_CASES)
def test_split_rounds_equals_the_loop_and_the_reference(name):
    """``ref.split_rounds``, the order of the kernel's per-slot walk,
    equals the plain loop and the reference's ``_split_control`` +
    ``crc16_tag`` bit for bit (per pipe where there is a pipe axis)."""
    from repro_torch.backend import ref as R
    cfg, m, regs, meta, pkts = _rounds_case(name)
    pcfg = ParkConfig(capacity=m, **cfg)
    args = (m, cfg["max_exp"], cfg["max_clk"], pcfg.min_park_len,
            pcfg.pass_bytes, _t(np.int32(regs[0])), _t(np.int32(regs[1])),
            *map(_t, meta), _t(pkts["alive"]), _t(pkts["payload_len"]))
    got_state, got = R.split_rounds(*args)
    loop_state, loop = R.split_control(*args)
    for i, (g, w) in enumerate(zip(got_state, loop_state)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"state {i}"
    assert list(got) == list(loop)
    for k in got:
        assert got[k].dtype == loop[k].dtype and torch.equal(got[k],
                                                             loop[k]), k
    rng = np.random.default_rng(7)
    pipes = range(len(regs[0])) if np.ndim(regs[0]) else [None]
    for p in pipes:
        at = (lambda x: x) if p is None else (lambda x: x[p])
        want_state, want = _split_reference(
            m, cfg, (at(regs[0]), at(regs[1])), [at(x) for x in meta],
            {k: at(v) for k, v in pkts.items()}, rng)
        for i, (g, w) in enumerate(zip(got_state, want_state)):
            _same(at(g), w, f"pipe {p} state {i}")
        for k in got:
            _same(at(got[k]), want[k], f"pipe {p} {k}")
    e = pkts["alive"] & (pkts["payload_len"] >= pcfg.min_park_len)
    if name == "heavy wrap":
        assert e.sum() > 40 * m and got["evicted"].any() \
            and got["skip_occupied"].any()
    if name == "all masked":
        assert not got["enb"].any()
    if name == "ineligible before the first eligible":
        assert not e[:4].any() and e[4]
        assert got["ti"][:4].tolist() == [regs[0]] * 4
        assert got["clk"][:4].tolist() == [regs[1]] * 4


def _kernel_model(m, cfg, regs, meta, pkts):
    """``csrc/split_control.cu`` for one pipe, as its blocks share out the
    work: block r of ``slot_ranges(m)`` walks the packets of each slot it
    owns, k = k0, k0 + M, ... (``(c)``), and writes the tag of the packets
    i with i mod N = r and the decisions of those of them that are not
    eligible (``(d)``).  Returns the outputs and, per output element, the
    blocks that wrote it."""
    from repro_torch.kernels.merge_stage import slot_ranges
    pcfg = ParkConfig(capacity=m, **cfg)
    n, span = slot_ranges(m)
    ti0, clk0 = int(regs[0]), int(regs[1])
    alive, plen = pkts["alive"], pkts["payload_len"]
    b = len(alive)
    e = alive & (plen >= pcfg.min_park_len)
    k = np.cumsum(e)                             # (b) the block scan
    total = int(k[-1]) if b else 0
    pos = np.flatnonzero(e)                      # pos[k - 1] = i
    park = np.minimum(plen, pcfg.pass_bytes)

    def clock(kk):
        return (clk0 - 1 + kk) % (cfg["max_clk"] - 1) + 1 if kk else clk0

    crc = _crc((ti0 + k) % m, [clock(int(kk)) for kk in k])
    out = {key: np.zeros(b, np.int64) for key in SPLIT_KEYS + ("crc",)}
    wrote = {key: [[] for _ in range(b)] for key in out}
    rows = [[] for _ in range(m)]
    tables = [np.array(t) for t in meta]
    for r in range(n):
        for s in range(r * span, min(m, (r + 1) * span)):   # (c)
            ex, g, ln = (int(t[s]) for t in meta)
            kk = (s - ti0 - 1) % m + 1
            while kk <= total:
                i = pos[kk - 1]
                avail = ex <= 1
                for key, v in (("enb", avail), ("evicted", ex == 1),
                               ("skip_occupied", not avail),
                               ("park_len", park[i] if avail else 0)):
                    out[key][i] = v
                    wrote[key][i].append(r)
                ex, g, ln = ((cfg["max_exp"], clock(kk), park[i]) if avail
                             else (ex - 1, g, ln))
                kk += m
            for t, v in zip(tables, (ex, g, ln)):
                t[s] = v
            rows[s].append(r)
        for i in range(r, b, n):                              # (d)
            kk = int(k[i])
            ti, c = (ti0 + kk) % m, clock(kk)
            fields = {"ti": ti, "clk": c, "crc": crc[i],
                      "skip_small": alive[i] and not e[i]}
            if not e[i]:
                fields.update(enb=0, evicted=0, skip_occupied=0,
                              park_len=0)
            for key, v in fields.items():
                out[key][i] = v
                wrote[key][i].append(r)
    regs_out = ((ti0 + total) % m, clock(total))
    return regs_out, tables, out, wrote, rows, (n, span)


@pytest.mark.parametrize("m,b", [(4096, 256), (4100, 300), (16, 1024)])
def test_split_control_blocks_write_each_output_once(m, b):
    """The kernel's ownership: every decision and tag of every packet is
    written by exactly one block (the owner of its slot for an eligible
    packet's decisions, block i mod N for the rest), every table row once
    by its owner, and what the blocks write is the plain version's
    result.  M 4100 has a ragged last range; M 16 under 1024 packets walks
    each slot ~30 times."""
    from repro_torch.backend import ref as R
    cfg = dict(max_exp=3, max_clk=1 << 16)
    rng = np.random.default_rng(m + b)
    regs, meta, pkts = _split_case(rng, m, b, cfg)
    regs_out, tables, out, wrote, rows, (n, span) = _kernel_model(
        m, cfg, regs, meta, pkts)
    pcfg = ParkConfig(capacity=m, **cfg)
    e = pkts["alive"] & (pkts["payload_len"] >= pcfg.min_park_len)
    slot_owner = ((regs[0] + np.cumsum(e)) % m) // span
    for key, per_packet in wrote.items():
        for i, blocks in enumerate(per_packet):
            want = slot_owner[i] if e[i] and key in (
                "enb", "evicted", "skip_occupied", "park_len") else i % n
            assert blocks == [want], (key, i, blocks)
    assert rows == [[s // span] for s in range(m)]
    assert len({s // span for s in range(m)}) == n
    want_state, want = R.split_control(
        m, cfg["max_exp"], cfg["max_clk"], pcfg.min_park_len,
        pcfg.pass_bytes, _t(np.int32(regs[0])), _t(np.int32(regs[1])),
        *map(_t, meta), _t(pkts["alive"]), _t(pkts["payload_len"]))
    assert [int(x) for x in want_state[:2]] == list(regs_out)
    for t, w in zip(tables, want_state[2:]):
        assert np.array_equal(t, w.numpy())
    for key in out:
        assert np.array_equal(out[key], want[key].numpy().astype(np.int64)), \
            key
    if m == 16:
        assert e.sum() > 30 * m


# --------------------------------------------------------------------------
# merge_stage
# --------------------------------------------------------------------------

def _crc(ti, clk):
    return np.asarray(JP.crc16_tag(jnp.asarray(ti, jnp.int32),
                                   jnp.asarray(clk, jnp.int32),
                                   backend="ref")).astype(np.int32)


def _merge_case(rng, m, b):
    """Packets returning to Merge over a table with live slots: honest
    tags (valid CRC, current generation), stale generations, flipped CRCs,
    out-of-range and negative tags with valid CRCs, disabled, dead and
    header-less packets, explicit-drop ops, duplicate tags and a second
    match with pp_clk = 0 after a free."""
    exp, gen, ln = _meta(rng, m, 2, 1 << 16)
    live = np.flatnonzero(exp > 0)
    ptable = rng.integers(0, 256, (m, W)).astype(np.uint8)
    ti = rng.choice(live, b).astype(np.int32)
    clk = gen[ti].copy()
    stale = rng.random(b) < 0.15
    clk[stale] = (clk[stale] + 1) % (1 << 16)
    f = dict(alive=rng.random(b) < 0.9, pp_valid=rng.random(b) < 0.95,
             pp_enb=(rng.random(b) < 0.8).astype(np.int32),
             pp_op=np.where(rng.random(b) < 0.25, OP_DROP, 0).astype(
                 np.int32),
             pp_ti=ti, pp_clk=clk)
    if b >= 8:
        f["pp_ti"][:4] = [m + 3, -1, -m - 2, -m]  # clamped, wraps, both
        f["pp_clk"][:4] = gen[[m - 1, m - 1, 0, 0]]
        f["pp_ti"][5] = f["pp_ti"][4]              # a duplicate tag
        f["pp_clk"][5] = f["pp_clk"][4]
        f["pp_ti"][7] = f["pp_ti"][6]              # matched, then pp_clk 0
        f["pp_clk"][7] = 0
        for i in range(8):
            f["alive"][i] = f["pp_valid"][i] = True
            f["pp_enb"][i] = 1
    f["pp_crc"] = _crc(f["pp_ti"], f["pp_clk"])
    flip = rng.random(b) < 0.1
    flip[:8] = False
    f["pp_crc"][flip] ^= 1
    return (exp, gen, ln), ptable, f


def _merge_reference(m, meta, ptable, f, rng):
    jcfg = JP.ParkConfig(capacity=m, max_exp=2)
    state = _jstate(m, 0, 0, *meta, ptable=ptable)
    pk = _jpackets(rng, f)
    jmeta, d = JP._merge_control(jcfg, state, pk, backend="ref")
    rows, table = jdispatch("payload_fetch", "ref")(
        state.ptable, pk.pp_ti, d["matched"])
    return ([np.asarray(x) for x in jmeta],
            {k: np.asarray(d[k]) for k in MERGE_KEYS},
            np.asarray(rows), np.asarray(table))


_HEADER = ("alive", "pp_valid", "pp_enb", "pp_op", "pp_ti", "pp_clk",
           "pp_crc")


def _merge_port(meta, ptable, f):
    return tdispatch("merge_stage", "ref")(
        _t(ptable), *map(_t, meta), *(_t(f[k]) for k in _HEADER))


def _check_merge(got, want, where=lambda x: x):
    (gmeta, gd, grows, gtable), (wmeta, wd, wrows, wtable) = got, want
    for i, (g, w) in enumerate(zip(gmeta, wmeta)):
        _same(where(g), w, f"meta {i}")
    assert set(gd) == set(MERGE_KEYS)
    for k in MERGE_KEYS:
        _same(where(gd[k]), wd[k], k)
    _same(where(grows), wrows, "parked rows")
    _same(where(gtable), wtable, "table")


@pytest.mark.parametrize("b", [8, 32, 96])
@pytest.mark.parametrize("m", [16, 64])
def test_merge_stage_matches_reference(m, b):
    rng = np.random.default_rng(2000 * m + b)
    meta, ptable, f = _merge_case(rng, m, b)
    want = _merge_reference(m, meta, ptable, f, rng)
    _check_merge(_merge_port(meta, ptable, f), want)
    wd = want[1]
    assert wd["matched"].any() and wd["premature"].any()
    if b > 8:  # at B = 8 every packet is one of the planted tags
        assert wd["crc_fail"].any() and wd["is_drop_op"].any()


@pytest.mark.parametrize("m", [16, 64])
def test_merge_stage_with_pipe_axis_matches_per_pipe_reference(m):
    rng = np.random.default_rng(m + 1)
    cases = [_merge_case(rng, m, 32) for _ in range(3)]
    meta = [np.stack([c[0][i] for c in cases]) for i in range(3)]
    ptable = np.stack([c[1] for c in cases])
    f = {k: np.stack([c[2][k] for c in cases]) for k in _HEADER}
    got = _merge_port(meta, ptable, f)
    for p, c in enumerate(cases):
        _check_merge(got, _merge_reference(m, *c, rng), lambda x: x[p])


def test_merge_stage_second_match_after_free_gets_the_row_too():
    """A packet matches and frees slot 5; a second packet names slot 5
    with pp_clk = 0 and a valid CRC, so it matches the freed slot and
    receives the same row: every row is gathered before any is cleared.
    A third packet with a stale generation on another slot is premature,
    and a clamped out-of-range tag reads the last slot."""
    m = 16
    exp = np.zeros(m, np.int32)
    gen = np.zeros(m, np.int32)
    ln = np.zeros(m, np.int32)
    exp[[5, 9, m - 1]] = 1
    gen[[5, 9, m - 1]] = [41, 42, 43]
    ln[[5, 9, m - 1]] = [160, 161, 162]
    ptable = np.arange(m * W, dtype=np.int64).reshape(m, W).astype(np.uint8)
    ti = np.array([5, 5, 9, m + 4, 3], np.int32)
    clk = np.array([41, 0, 7, 43, 0], np.int32)
    f = dict(alive=np.ones(5, bool), pp_valid=np.ones(5, bool),
             pp_enb=np.ones(5, np.int32),
             pp_op=np.array([0, 0, 0, 0, OP_DROP], np.int32),
             pp_ti=ti, pp_clk=clk, pp_crc=_crc(ti, clk))
    rng = np.random.default_rng(0)
    want = _merge_reference(m, (exp, gen, ln), ptable, f, rng)
    got = _merge_port((exp, gen, ln), ptable, f)
    _check_merge(got, want)
    _, d, rows, table = got
    assert d["matched"].tolist() == [True, True, False, True, True]
    assert d["park_len"].tolist() == [160, 0, 0, 162, 0]
    assert torch.equal(rows[0], rows[1]) and rows[0].any()
    assert torch.equal(rows[3], _t(ptable[m - 1]))
    assert not table[5].any() and not table[3].any()
    assert torch.equal(table[m - 1], _t(ptable[m - 1]))  # no clear past M
    assert d["is_drop_op"].tolist() == [False] * 4 + [True]


def test_merge_stage_all_masked_touches_nothing():
    rng = np.random.default_rng(3)
    meta, ptable, f = _merge_case(rng, 16, 8)
    f["pp_enb"][:] = 0
    got = _merge_port(meta, ptable, f)
    _check_merge(got, _merge_reference(16, meta, ptable, f, rng))
    assert not got[2].any() and np.array_equal(got[3].numpy(), ptable)
    assert got[1]["disabled"].any()


# --------------------------------------------------------------------------
# merge_stage's kernel partition: blocks that each own a range of slots
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 8, 12, 16, 31, 64, 100, 600, 4096, 4100,
                               1 << 17, (1 << 17) + 1, 1 << 20])
def test_merge_stage_slot_ranges_cover_the_table(m):
    """``slot_ranges``: N blocks of ``span`` slots cover [0, M) with no
    empty block; at most 8192 slots a block, whole bitmap words from 32
    slots up; 16 blocks where M splits so, more only past 16 x 8192
    slots; a block's bitmaps and 256 packets' staging fit in shared
    memory up to M = 2**20."""
    from repro_torch.kernels import merge_stage as MS
    n, span = MS.slot_ranges(m)
    assert (n - 1) * span < m <= n * span
    assert span <= MS.MAX_SPAN
    assert span < 32 or span % 32 == 0
    assert n <= max(MS.RANGES, -(-m // MS.MAX_SPAN))
    if m % (32 * MS.RANGES) == 0 and m <= MS.RANGES * MS.MAX_SPAN:
        assert n == MS.RANGES
    assert MS.shared_bytes(256, m) <= MS.MAX_SHARED
    if m == 4096:
        assert (n, span) == (16, 256)


@pytest.mark.parametrize("b", [96, 256])
@pytest.mark.parametrize("m", [64, 100, 4100])
def test_merge_stage_by_slot_ranges_equals_the_whole_call(m, b):
    """The kernel's partition holds the plain version: each block's
    packets (``packet_blocks``: the checked ones whose clamped tag names a
    slot of its range, and a share of the others) run through
    ``merge_stage`` alone, the other packets dead, in reverse block order,
    each on the tables the last one left, give each packet's decisions
    and row and each range's metadata and payload rows of the whole call.
    The case has duplicates, forged CRCs, negative and out-of-range tags;
    M = 100 and 4100 are no multiple of N, and M = 64 and 100 give ranges
    of 4 and 7 slots, narrower than a bitmap word."""
    from repro_torch.backend import ref as R
    from repro_torch.kernels import merge_stage as MS
    rng = np.random.default_rng(3 * m + b)
    meta, ptable, f = _merge_case(rng, m, b)
    whole = _merge_port(meta, ptable, f)
    _check_merge(whole, _merge_reference(m, meta, ptable, f, rng))
    n, span = MS.slot_ranges(m)
    t = {k: _t(f[k]) for k in _HEADER}
    checked = (t["alive"] & t["pp_valid"] & (t["pp_enb"] == 1)
               & (R.crc16_tag(t["pp_ti"], t["pp_clk"]) == t["pp_crc"]))
    owner = MS.packet_blocks(checked, t["pp_ti"], m).numpy()
    assert len(set(owner[checked.numpy()].tolist())) > 1
    assert not checked.all()
    wmeta, wd, wrows, wtable = whole
    cur_meta, cur_table = meta, ptable
    for r in reversed(range(n)):
        mine = owner == r
        fr = dict(f, alive=f["alive"] & mine)
        gmeta, gd, grows, gtable = _merge_port(cur_meta, cur_table, fr)
        for k in MERGE_KEYS:
            assert torch.equal(gd[k][mine], wd[k][mine]), (r, k)
        assert torch.equal(grows[mine], wrows[mine]), r
        own = slice(r * span, min(m, (r + 1) * span))
        for g, w in zip(gmeta, wmeta):
            assert torch.equal(g[own], w[own]), r
        assert torch.equal(gtable[own], wtable[own]), r
        cur_meta = [g.numpy() for g in gmeta]
        cur_table = gtable.numpy()
    for g, w in zip(cur_meta, wmeta):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(cur_table, wtable.numpy())


# --------------------------------------------------------------------------
# the CUDA launchers' checks and bindings, reachable without a card
# --------------------------------------------------------------------------

def _fake_library(monkeypatch, module, calls):
    """Point ``module``'s wrapper at C functions built from
    ``build.SIGNATURES`` that record their arguments (ctypes raises on a
    count or type the signature does not take), as
    ``tests/test_torch_primitives.py`` does.  The launch counter is
    restored afterwards."""
    import ctypes
    from repro_torch.kernels import build

    class Lib:
        pass

    lib = Lib()
    for name, argtypes in build.SIGNATURES.items():
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
        setattr(lib, name,
                proto(lambda *a, name=name: calls.append((name, a)) or 0))
    monkeypatch.setattr(module, "library", lambda: lib)
    monkeypatch.setattr(module, "require_cuda",
                        lambda name, *t: torch.device("cpu"))
    monkeypatch.setattr(module, "stream_handle", lambda dev: 0)
    monkeypatch.setitem(trace.COUNTERS, module.COUNT,
                        trace.COUNTERS[module.COUNT])


def test_split_control_binding_matches_its_signature(monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import split_control as SC
    calls = []
    _fake_library(monkeypatch, SC, calls)
    before = trace.COUNTERS[SC.COUNT]
    m, b = 16, 8
    z = torch.zeros(2, dtype=torch.int32)
    meta = [torch.zeros(2, m, dtype=torch.int32) for _ in range(3)]
    alive = torch.ones(2, b, dtype=torch.bool)
    plen = torch.full((2, b), 200, dtype=torch.int32)
    (ti, clk, *new_meta), d = SC.split_control_cuda(
        m, 2, 1 << 16, 160, 160, z, z, *meta, alive, plen)
    assert [c[0] for c in calls] == ["pp_split_control"]
    args = calls[0][1]
    assert len(args) == len(build.SIGNATURES["pp_split_control"]) == 31
    # pipes, b, m, max_clk, max_exp, min_park_len, pass_bytes, then the
    # blocks a pipe and the slots of each
    assert args[20:29] == (2, b, m, 1 << 16, 2, 160, 160,
                           *SC.slot_ranges(m))
    assert args[29] is None                       # shared memory: no scratch
    assert trace.COUNTERS[SC.COUNT] == before + 1  # one launch per call
    assert tuple(ti.shape) == (2,) and tuple(new_meta[0].shape) == (2, m)
    assert [(k, d[k].dtype) for k in d] == list(SC.DECISIONS)
    assert all(tuple(v.shape) == (2, b) for v in d.values())


@pytest.mark.parametrize("pipes,b,m,past", [
    (8, 256, 4096, False),                    # pipes8: 16 blocks a pipe
    (1, 17641, 4096, False),                  # 232405 B: at the limit
    (1, 17642, 4096, True),                   # one packet past it
    (2, 11000, 1 << 20, True),                # 8192-slot ranges
])
def test_split_control_cuda_passes_device_scratch_past_its_shared_memory(
        monkeypatch, pipes, b, m, past):
    """Past ``MAX_SHARED`` bytes a block (Hopper's 227 KB less the scan's
    static warp sums) the launcher hands the kernel a device-memory scratch
    of ``scratch_words`` int32 words a block (16-byte aligned, P x N
    blocks) and still launches once; under it, a null scratch."""
    from repro_torch.kernels import split_control as SC
    calls, scratch = [], []
    _fake_library(monkeypatch, SC, calls)
    real_empty = torch.empty

    def empty(shape, *a, **kw):
        out = real_empty(shape, *a, **kw)
        if kw.get("dtype") == torch.int32 and len(shape) == 2 \
                and shape[1] == SC.scratch_words(b, m):
            scratch.append(out)
        return out

    monkeypatch.setattr(SC.torch, "empty", empty)
    before = trace.COUNTERS[SC.COUNT]
    z = torch.zeros(pipes, dtype=torch.int32)
    meta = [torch.zeros(pipes, m, dtype=torch.int32) for _ in range(3)]
    SC.split_control_cuda(m, 2, 1 << 16, 160, 160, z, z, *meta,
                          torch.ones(pipes, b, dtype=torch.bool),
                          torch.full((pipes, b), 200, dtype=torch.int32))
    assert trace.COUNTERS[SC.COUNT] == before + 1
    args = calls[0][1]
    blocks = SC.slot_ranges(m)[0]
    assert SC.MAX_SHARED == 227 * 1024 - 32
    assert past == (SC.shared_bytes(b, m) > SC.MAX_SHARED)
    if past:
        assert len(scratch) == 1 and args[29] == scratch[0].data_ptr()
        assert tuple(scratch[0].shape) == (pipes * blocks,
                                           SC.scratch_words(b, m))
        assert SC.scratch_words(b, m) % 4 == 0
        assert 4 * SC.scratch_words(b, m) >= SC.shared_bytes(b, m)
    else:
        assert args[29] is None and not scratch


@pytest.mark.parametrize("m,b,max_clk", [(16, 8, 1), (16, 8, (1 << 31) + 1),
                                         (1 << 31, 8, 1 << 16)])
def test_split_control_cuda_raises_past_its_32_bit_tagger(m, b, max_clk):
    """The kernel's tagger works in 32 bits: a capacity of 2^31 rows or a
    clock past 2^31 (or of 1, with nothing to wrap) raises before any
    launch or allocation."""
    from repro_torch.kernels import split_control as SC
    before = trace.COUNTERS[SC.COUNT]
    z = torch.zeros((), dtype=torch.int32)
    meta = [torch.zeros(1, dtype=torch.int32).expand(m) for _ in range(3)]
    with pytest.raises(ValueError, match="32-bit tagger"):
        SC.split_control_cuda(m, 2, max_clk, 160, 160, z, z, *meta,
                              torch.ones(b, dtype=torch.bool),
                              torch.full((b,), 200, dtype=torch.int32))
    assert trace.COUNTERS[SC.COUNT] == before


def test_merge_stage_binding_matches_its_signature(monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import merge_stage as MS
    calls = []
    _fake_library(monkeypatch, MS, calls)
    before = trace.COUNTERS[MS.COUNT]
    m, b = 16, 8
    table = torch.zeros(1, m, W, dtype=torch.uint8)
    meta = [torch.zeros(1, m, dtype=torch.int32) for _ in range(3)]
    flag = torch.ones(1, b, dtype=torch.bool)
    z = torch.zeros(1, b, dtype=torch.int32)
    new_meta, d, parked, tab = MS.merge_stage_cuda(
        table, *meta, flag, flag, z, z, z, z, z)
    assert [c[0] for c in calls] == ["pp_merge_stage"]
    args = calls[0][1]
    assert len(args) == len(build.SIGNATURES["pp_merge_stage"]) == 30
    # pipes, b, m, width, op, then the blocks a pipe and the slots of each
    assert args[21:28] == (1, b, m, W, OP_DROP, *MS.slot_ranges(m))
    assert args[28] is None                       # shared memory: no scratch
    assert trace.COUNTERS[MS.COUNT] == before + 1
    assert tab is table and tuple(parked.shape) == (1, b, W)
    assert [(k, d[k].dtype) for k in d] == list(MS.DECISIONS)


def test_merge_stage_cuda_raises_past_its_shared_memory():
    """Past one block's shared memory the kernel works in device memory, so
    the size raises nothing: a CPU call raises only for its device."""
    from repro_torch.kernels import merge_stage as MS
    b = MS.MAX_SHARED // 5 + 1
    z = torch.zeros(b, dtype=torch.int32)
    flag = torch.ones(b, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        MS.merge_stage_cuda(torch.zeros(16, W, dtype=torch.uint8),
                            *(torch.zeros(16, dtype=torch.int32)
                              for _ in range(3)),
                            flag, flag, z, z, z, z, z)
    assert launch_counts()["merge_stage"] == 0


def _merge_last_shared(ms, m: int) -> int:
    """The largest batch whose Merge layout at M ``m`` fits in one block's
    dynamic shared memory."""
    b = (ms.MAX_SHARED - ms.shared_bytes(0, m)) // 17
    assert ms.shared_bytes(b, m) <= ms.MAX_SHARED < ms.shared_bytes(b + 1, m)
    return b


@pytest.mark.parametrize("pipes,b,m,past", [
    (1, 256, 1 << 20, False),                 # 128 blocks of 8192 slots
    (2, 227 * 1024 // 17 + 1, 16, True),      # the staged rows
    (1, "last", 4096, False),                 # the most packets in it
    (1, "last+1", 4096, True),                # one packet past it
    (1, 13488, 4096, True),                   # 232432 B: past the 48 B of
    (1, 13489, 4096, True),                   # static shared memory
])
def test_merge_stage_cuda_passes_device_scratch_past_its_shared_memory(
        monkeypatch, pipes, b, m, past):
    """Past ``MAX_SHARED`` bytes a block (Hopper's 227 KB less the
    kernel's 48 B of static shared memory) the launcher hands the kernel a
    device-memory scratch of ``scratch_words`` int32 words a block (16-byte
    aligned, P x N blocks) and still launches once; under it, a null
    scratch.  ``"last"`` is the largest batch whose ``shared_bytes`` fits
    in ``MAX_SHARED``."""
    from repro_torch.kernels import merge_stage as MS
    assert MS.MAX_SHARED == 227 * 1024 - 48
    if isinstance(b, str):
        b = _merge_last_shared(MS, m) + (b == "last+1")
    calls, scratch = [], []
    _fake_library(monkeypatch, MS, calls)
    real_empty = torch.empty

    def empty(shape, *a, **kw):
        out = real_empty(shape, *a, **kw)
        if kw.get("dtype") == torch.int32 and len(shape) == 2 \
                and shape[1] == MS.scratch_words(b, m):
            scratch.append(out)
        return out

    monkeypatch.setattr(MS.torch, "empty", empty)
    before = trace.COUNTERS[MS.COUNT]
    table = torch.zeros(pipes, m, W, dtype=torch.uint8)
    meta = [torch.zeros(pipes, m, dtype=torch.int32) for _ in range(3)]
    flag = torch.ones(pipes, b, dtype=torch.bool)
    z = torch.zeros(pipes, b, dtype=torch.int32)
    MS.merge_stage_cuda(table, *meta, flag, flag, z, z, z, z, z)
    assert trace.COUNTERS[MS.COUNT] == before + 1
    args = calls[0][1]
    blocks = MS.slot_ranges(m)[0]
    assert past == (MS.shared_bytes(b, m) > MS.MAX_SHARED)
    if past:
        assert len(scratch) == 1 and args[28] == scratch[0].data_ptr()
        assert tuple(scratch[0].shape) == (pipes * blocks,
                                           MS.scratch_words(b, m))
        assert MS.scratch_words(b, m) % 4 == 0
        assert 4 * MS.scratch_words(b, m) >= MS.shared_bytes(b, m)
    else:
        assert args[28] is None and not scratch
