"""Merge's packet transformation as one primitive (``merge_payload``): its
plain version against the expression ``core/park.py::merge_fn`` computed
before the primitive existed (kept here as the oracle), exactly; the CUDA
launcher's checks and binding, reachable without a card; and the kernel
against its plain version on a card (skipped without one)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.backend import BackendConfig  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def merge_fn_expression(pmax, park_bytes, pkts, parked, d):
    """``merge_fn``'s packet transformation as it was written inline (with
    ``cfg.pmax`` and ``cfg.park_bytes`` as arguments): the oracle."""
    fetch = d["matched"] & ~d["is_drop_op"]
    shift = torch.where(fetch, d["park_len"], 0)
    col = torch.arange(pmax, device=shift.device)
    rem_idx = torch.clamp(col - shift[..., None], 0, pmax - 1)
    carried = torch.gather(pkts["payload"], -1, rem_idx.to(torch.int64))
    if pmax >= park_bytes:
        parked_full = torch.nn.functional.pad(parked, (0, pmax - park_bytes))
    else:
        parked_full = parked[..., :pmax]
    new_payload = torch.where(col < shift[..., None], parked_full, carried)
    new_len = pkts["payload_len"] + shift
    new_payload = torch.where(col < new_len[..., None], new_payload, 0)

    forwarded = d["disabled"] | fetch
    dropped = d["premature"] | d["crc_fail"] | d["is_drop_op"]
    gone = forwarded | dropped
    zero = torch.zeros_like(pkts["pp_op"])
    return dict(
        payload=torch.where(forwarded[..., None], new_payload,
                            pkts["payload"]).to(torch.uint8),
        payload_len=torch.where(forwarded, new_len,
                                pkts["payload_len"]).to(torch.int32),
        alive=pkts["alive"] & ~dropped,
        pp_valid=pkts["pp_valid"] & ~gone,
        pp_enb=torch.where(gone, zero, pkts["pp_enb"]),
        pp_op=torch.where(gone, zero, pkts["pp_op"]),
        pp_ti=torch.where(gone, zero, pkts["pp_ti"]),
        pp_clk=torch.where(gone, zero, pkts["pp_clk"]),
        pp_crc=torch.where(gone, zero, pkts["pp_crc"]),
    )


def returning(seed, lead, b, pmax, w):
    """Packets back from the server and Merge's decisions on them, drawn
    with numpy: header-less returns (disabled), matches (some explicit
    drops), premature, CRC-failed and untouched packets.  A matched packet
    carries a parked prefix of 0..W bytes and what is left of 0..pmax.
    Packet 0 ends
    exactly at pmax after Merge, packet 1 matches with a prefix of 0 bytes,
    packet 2 is a header-less return of pmax bytes.  Returns (pkts,
    parked, d) as dicts of tensors and a tensor."""
    rng = np.random.default_rng(seed)
    shape = lead + (b,)
    kind = rng.choice(5, size=shape, p=(0.3, 0.45, 0.1, 0.1, 0.05))
    d = dict(disabled=kind == 0, matched=kind == 1, premature=kind == 2,
             crc_fail=kind == 3)
    d["is_drop_op"] = d["matched"] & (rng.random(shape) < 0.2)
    park_len = rng.integers(0, w + 1, shape)
    total = rng.integers(0, pmax + 1, shape)
    if b >= 3:
        for k, v in (("matched", (1, 1, 0)), ("disabled", (0, 0, 1)),
                     ("is_drop_op", (0, 0, 0)), ("premature", (0, 0, 0)),
                     ("crc_fail", (0, 0, 0))):
            d[k][..., :3] = v
        park_len[..., 0], park_len[..., 1] = min(w, pmax), 0
        total[..., :3] = pmax
    d["park_len"] = np.where(d["matched"], park_len, 0)
    plen = np.where(d["matched"] & ~d["is_drop_op"],
                    np.maximum(total - d["park_len"], 0), total)
    payload = rng.integers(0, 256, shape + (pmax,), dtype=np.uint8)
    # bytes past the length are 0, as on the wire, but for a third of the
    # packets that are not header-less returns (the new length's mask and
    # the clamped reads then show)
    clean = (np.arange(b) % 3 != 2) | d["disabled"]
    payload[(np.arange(pmax) >= plen[..., None]) & clean[..., None]] = 0
    parked = rng.integers(0, 256, shape + (w,), dtype=np.uint8)
    parked[~d["matched"]] = 0
    pkts = dict(payload=payload, payload_len=plen,
                alive=rng.random(shape) < 0.95,
                pp_valid=rng.random(shape) < 0.9)
    for k in ("pp_enb", "pp_op", "pp_ti", "pp_clk", "pp_crc"):
        pkts[k] = rng.integers(-(1 << 31), 1 << 31, shape)

    def t(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(torch.int32) if a.dtype == torch.int64 else a

    return ({k: t(v) for k, v in pkts.items()}, t(parked),
            {k: t(v) for k, v in d.items()})


def primitive_args(pkts, parked, d):
    return ([pkts[k] for k in R.MERGE_PAYLOAD_FIELDS] + [parked]
            + [d[k] for k in R.MERGE_DECISIONS])


CASES = {
    "pmax1450_w160": ((4,), 64, 1450, 160),
    "pmax1450_w352": ((4,), 64, 1450, 352),
    "pmax200_w160": ((3,), 40, 200, 160),       # not a multiple of 16
    "pmax13_w160": ((3,), 37, 13, 160),         # below W and 16
    "pmax100_w160": ((4,), 32, 100, 160),       # pmax < W
    "pmax300_w352": ((4,), 32, 300, 352),       # pmax < W
    "no_pipe_axis": ((), 96, 1450, 160),
    "two_pipe_axes": ((2, 3), 24, 1000, 352),
    "b0": ((4,), 0, 1450, 160),
}


@pytest.mark.parametrize("case", CASES)
def test_merge_payload_matches_merge_fn_expression(case):
    lead, b, pmax, w = CASES[case]
    pkts, parked, d = returning(sum(map(ord, case)), lead, b, pmax, w)
    got = dict(zip(R.MERGE_PAYLOAD_FIELDS,
                   R.merge_payload(*primitive_args(pkts, parked, d))))
    want = merge_fn_expression(pmax, w, pkts, parked, d)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    if b == 0:
        return
    # rows that are not forwarded keep their bytes; header-less returns
    # keep theirs too (zeros past their length)
    kept = d["premature"] | d["crc_fail"] | d["is_drop_op"] | d["disabled"]
    assert bool(kept.any())
    assert torch.equal(got["payload"][kept], pkts["payload"][kept])
    fetch = d["matched"] & ~d["is_drop_op"]
    assert torch.equal(got["payload_len"],
                       pkts["payload_len"] + torch.where(fetch,
                                                         d["park_len"], 0))
    if b >= 3 and pmax >= w:
        assert bool((got["payload_len"][..., 0] == pmax).all())
        assert torch.equal(got["payload"][..., 0, :w], parked[..., 0, :])
        assert torch.equal(got["payload"][..., 1, :],
                           pkts["payload"][..., 1, :])


def test_merge_fn_dispatches_its_packet_transformation(monkeypatch):
    """``merge_fn`` rebuilds the packets through the ``merge_payload``
    primitive, once a call: choosing its kernel on CPU tensors raises, and
    a Split then a Merge give the packets back as they were."""
    from repro_torch.backend import registry
    from repro_torch.core import packet as TK
    from repro_torch.core import park as TP
    cfg = TP.ParkConfig(capacity=16, max_exp=2, pmax=400)
    rng = np.random.default_rng(1)
    wire = torch.from_numpy(rng.integers(42, 442, 24).astype(np.int32))
    pkts = TK.make_udp_batch(3, 24, wire, pmax=400, device="cpu")

    def split():
        return TP.split_fn(cfg, TP.init_state(cfg, device="cpu"), pkts)

    state, sent = split()
    assert bool(sent.pp_enb.any())
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.merge_fn(cfg, state, sent,
                    backend=BackendConfig("auto", {"merge_payload": "cuda"}))
    seen = []

    def spy(*args):
        seen.append(args)
        return R.merge_payload(*args)

    monkeypatch.setitem(registry._REGISTRY, "merge_payload",
                        dataclasses.replace(
                            registry._REGISTRY["merge_payload"], ref=spy))
    state, sent = split()   # the failed Merge above cleared the rows
    _, out = TP.merge_fn(cfg, state, sent, backend="ref")
    assert len(seen) == 1 and len(seen[0]) == 16
    for k in ("payload", "payload_len", "alive"):
        assert torch.equal(getattr(out, k), getattr(pkts, k)), k
    assert not bool(out.pp_valid.any())


# --------------------------------------------------------------------------
# the CUDA launcher's checks and binding, reachable without a card
# --------------------------------------------------------------------------

def _fake_library(monkeypatch, module, calls):
    """Point ``module``'s wrapper at C functions built from
    ``build.SIGNATURES`` that record their arguments (ctypes raises on a
    count or type the signature does not take).  The launch counter is
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


def test_merge_payload_binding_matches_its_signature(monkeypatch):
    """One launch a call with the 31 arguments of ``pp_merge_payload``:
    the payload's and the parked rows' strides passed as they are (views of
    wider rows are read in place, not copied), new output tensors."""
    from repro_torch.kernels import build
    from repro_torch.kernels import merge_payload as MP
    calls = []
    _fake_library(monkeypatch, MP, calls)
    before = trace.COUNTERS[MP.COUNT]
    pkts, parked, d = returning(3, (2,), 8, 1456, 176)
    args = primitive_args(pkts, parked, d)
    args[0], args[9] = args[0][..., 3:1453], args[9][..., 8:168]
    out = MP.merge_payload_cuda(*args)
    assert [c[0] for c in calls] == ["pp_merge_payload"]
    sent = calls[0][1]
    assert len(sent) == len(build.SIGNATURES["pp_merge_payload"]) == 31
    assert sent[0] == args[0].data_ptr() and sent[9] == args[9].data_ptr()
    # rows, pmax, payload row stride, W, parked row stride
    assert sent[25:30] == (16, 1450, 1456, 160, 176)
    assert trace.COUNTERS[MP.COUNT] == before + 1
    assert [t.shape for t in out] == [a.shape for a in args[:9]]
    assert [t.dtype for t in out] == [a.dtype for a in args[:9]]
    assert all(t.data_ptr() not in (a.data_ptr() for a in args)
               for t in out)


def test_merge_payload_cuda_refuses_what_the_kernel_does_not_take(
        monkeypatch):
    from repro_torch.kernels import merge_payload as MP
    pkts, parked, d = returning(4, (2,), 8, 64, 160)
    args = primitive_args(pkts, parked, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        MP.merge_payload_cuda(*args)
    calls = []
    _fake_library(monkeypatch, MP, calls)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)              # payload_len
    with pytest.raises(TypeError, match="dtype"):
        MP.merge_payload_cuda(*bad)
    bad = list(args)
    bad[15] = bad[15][:, :4]                     # park_len
    with pytest.raises(ValueError, match="shapes"):
        MP.merge_payload_cuda(*bad)
    empty = primitive_args(*returning(5, (3,), 0, 64, 160))
    out = MP.merge_payload_cuda(*empty)          # B = 0: no launch
    assert calls == [] and launch_counts()["merge_payload"] == 0
    assert [t.shape for t in out] == [a.shape for a in empty[:9]]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("case", ["pmax1450_w160", "pmax1450_w352",
                                  "pmax13_w160", "pmax100_w160",
                                  "two_pipe_axes"])
def test_merge_payload_kernel_bit_for_bit_on_the_card(card, case):
    from repro_torch.kernels import merge_payload as MP
    lead, b, pmax, w = CASES[case]
    pkts, parked, d = returning(sum(map(ord, case)), lead, b, pmax, w)
    args = [a.to(card) for a in primitive_args(pkts, parked, d)]
    before = launch_counts()["merge_payload"]
    got = MP.merge_payload_cuda(*args)
    torch.cuda.synchronize(card)
    assert launch_counts()["merge_payload"] == before + 1
    for g, want in zip(got, R.merge_payload(*args)):
        assert g.dtype == want.dtype and torch.equal(g, want)
