"""Each primitive's plain PyTorch version against the reference's jnp
version and its Pallas kernel in interpret mode, on the same numpy inputs,
compared exactly; plus the backend registry's device rules on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.backend import dispatch as jdispatch  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.backend import BackendConfig  # noqa: E402
from repro_torch.backend import dispatch as tdispatch  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402

JAX_BACKENDS = ("ref", "pallas_interpret")


def _t(a):
    return torch.from_numpy(np.array(a))


def _run(name, jax_backend, *args):
    out = jdispatch(name, jax_backend)(*(jnp.asarray(a) for a in args))
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
@pytest.mark.parametrize("n", [1, 7, 1000, 1024])
def test_crc16_parity(n, jax_backend):
    rng = np.random.default_rng(n)
    ti = rng.integers(0, 1 << 16, n).astype(np.int32)
    clk = rng.integers(1, 1 << 16, n).astype(np.int32)
    got = R.crc16_tag(_t(ti), _t(clk)).numpy()
    assert np.array_equal(got, _run("crc16_tag", jax_backend, ti, clk))


def test_crc16_known_vector_bitexact():
    data = torch.tensor([ord(c) for c in "123456789"], dtype=torch.int32)
    assert int(R.crc16_bytes(data)) == 0x29B1


@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
@pytest.mark.parametrize("b,r", [(5, 1), (500, 20), (1024, 4), (264, 20)])
def test_acl_match_parity(b, r, jax_backend):
    rng = np.random.default_rng(b + r)
    ips = rng.integers(0, 50, b).astype(np.int32)
    rules = rng.integers(0, 50, r).astype(np.int32)
    got = R.acl_match(_t(ips), _t(rules)).numpy()
    assert np.array_equal(got, _run("acl_match", jax_backend, ips, rules))


@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
@pytest.mark.parametrize("b", [3, 300])
def test_maglev_select_parity(b, jax_backend):
    rng = np.random.default_rng(b)
    f = [rng.integers(-(1 << 31), (1 << 31) - 1, b).astype(np.int32)
         for _ in range(5)]
    table = rng.integers(0, 8, 251).astype(np.int32)
    bips = rng.integers(0, 1 << 30, 8).astype(np.int32)
    got = R.maglev_select(*(_t(a) for a in f), _t(table), _t(bips)).numpy()
    assert np.array_equal(
        got, _run("maglev_select", jax_backend, *f, table, bips))


def _store_inputs(m, nbytes, b, seed, dups):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (m, nbytes)).astype(np.uint8)
    payload = rng.integers(0, 256, (b, nbytes)).astype(np.uint8)
    idx = (rng.permutation(m)[:b] if b <= m else np.arange(b) % m)
    idx = idx.astype(np.int32)
    enb = rng.random(b) < 0.7
    if dups and b >= 4:  # several enabled writers to one row: last wins
        idx[[1, 2, b - 1]] = idx[0]
        enb[[0, 1, b - 1]] = True
    return table, payload, idx, enb


@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("m,nbytes,b", [(16, 160, 8), (64, 352, 24),
                                        (128, 160, 128), (32, 32, 5)])
def test_payload_store_parity(m, nbytes, b, dups, jax_backend):
    table, payload, idx, enb = _store_inputs(m, nbytes, b, m + b, dups)
    got = R.payload_store(_t(table), _t(payload), _t(idx), _t(enb)).numpy()
    want = _run("payload_store", jax_backend, table, payload, idx, enb)
    assert np.array_equal(got, want)


def test_payload_store_out_of_range_rows_match_reference():
    table, payload, idx, enb = _store_inputs(16, 160, 8, 3, False)
    idx[:4] = [-1, -16, 16, -17]  # wraps, wraps, dropped, dropped
    enb[:4] = True
    got = R.payload_store(_t(table), _t(payload), _t(idx), _t(enb)).numpy()
    assert np.array_equal(got, _run("payload_store", "ref", table, payload,
                                    idx, enb))


def _fetch_inputs(m, nbytes, b, seed):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (m, nbytes)).astype(np.uint8)
    idx = (rng.permutation(m)[:b] if b <= m else np.arange(b) % m)
    mask = rng.random(b) < 0.6
    # masked-off rows carry pp_ti = 0 duplicates, as Merge hands them over
    idx = np.where(mask, idx, 0).astype(np.int32)
    return table, idx, mask


@pytest.mark.parametrize("jax_backend", JAX_BACKENDS)
@pytest.mark.parametrize("m,nbytes,b", [(16, 160, 8), (64, 352, 24),
                                        (128, 160, 128)])
def test_payload_fetch_parity(m, nbytes, b, jax_backend):
    table, idx, mask = _fetch_inputs(m, nbytes, b, m * b)
    rows, tab = R.payload_fetch(_t(table), _t(idx), _t(mask))
    want_rows, want_tab = _run("payload_fetch", jax_backend, table, idx,
                               mask)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(tab.numpy(), want_tab)


def test_payload_fetch_all_masked_touches_nothing_bitexact():
    table, idx, _ = _fetch_inputs(16, 160, 8, 1)
    mask = np.zeros(8, bool)
    rows, tab = R.payload_fetch(_t(table), _t(np.zeros(8, np.int32)),
                                _t(mask))
    assert not rows.any() and np.array_equal(tab.numpy(), table)


def test_payload_fetch_out_of_range_rows_match_reference():
    table, idx, mask = _fetch_inputs(16, 160, 8, 5)
    idx[:3] = [-2, 40, -40]  # wraps; clamps to 15 (no clear); clamps to 0
    mask[:3] = True
    rows, tab = R.payload_fetch(_t(table), _t(idx), _t(mask))
    want_rows, want_tab = _run("payload_fetch", "ref", table, idx, mask)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(tab.numpy(), want_tab)


def test_primitives_take_a_leading_pipe_axis():
    tabs, pays, idxs, enbs = zip(*(_store_inputs(32, 160, 8, s, True)
                                   for s in range(3)))
    got = R.payload_store(_t(np.stack(tabs)), _t(np.stack(pays)),
                          _t(np.stack(idxs)), _t(np.stack(enbs))).numpy()
    for p in range(3):
        want = _run("payload_store", "ref", tabs[p], pays[p], idxs[p],
                    enbs[p])
        assert np.array_equal(got[p], want)
    tabs, idxs, masks = zip(*(_fetch_inputs(32, 352, 8, s) for s in range(3)))
    rows, tab = R.payload_fetch(_t(np.stack(tabs)), _t(np.stack(idxs)),
                                _t(np.stack(masks)))
    for p in range(3):
        want_rows, want_tab = _run("payload_fetch", "ref", tabs[p], idxs[p],
                                   masks[p])
        assert np.array_equal(rows[p].numpy(), want_rows)
        assert np.array_equal(tab[p].numpy(), want_tab)


# --------------------------------------------------------------------------
# registry and device rules
# --------------------------------------------------------------------------

def _cpu_args(name):
    z = torch.zeros(8, dtype=torch.int32)
    return {
        "crc16_tag": (z, z),
        "acl_match": (z, z[:2]),
        "maglev_select": (z, z, z, z, z, torch.zeros(251, dtype=torch.int32),
                          torch.zeros(8, dtype=torch.int32)),
        "payload_store": (torch.zeros(4, 16, dtype=torch.uint8),
                          torch.zeros(8, 16, dtype=torch.uint8), z,
                          torch.ones(8, dtype=torch.bool)),
        "payload_fetch": (torch.zeros(4, 16, dtype=torch.uint8), z,
                          torch.ones(8, dtype=torch.bool)),
        # capacity 16, max_exp 2, max_clk, min_park_len, pass_bytes; two
        # pipes of 8 packets, all eligible
        "split_control": (16, 2, 1 << 16, 160, 160, z[:2], z[:2],
                          *(torch.zeros(2, 16, dtype=torch.int32)
                            for _ in range(3)),
                          torch.ones(2, 8, dtype=torch.bool),
                          torch.full((2, 8), 200, dtype=torch.int32)),
        # every packet returns with a tag on row 0
        "merge_stage": (torch.zeros(16, 16, dtype=torch.uint8),
                        *(torch.zeros(16, dtype=torch.int32)
                          for _ in range(3)),
                        torch.ones(8, dtype=torch.bool),
                        torch.ones(8, dtype=torch.bool), z + 1, z, z, z, z),
        # every packet matched, a 4-byte prefix put back before 8 bytes
        "merge_payload": (torch.ones(8, 16, dtype=torch.uint8), z + 8,
                          *(torch.ones(8, dtype=torch.bool)
                            for _ in range(2)), z, z, z, z, z,
                          torch.full((8, 16), 2, dtype=torch.uint8),
                          torch.ones(8, dtype=torch.bool),
                          *(torch.zeros(8, dtype=torch.bool)
                            for _ in range(4)), z + 4),
    }[name]


def _clone(a):
    return a.clone() if torch.is_tensor(a) else a


def _leaves(out):
    """The tensors of a primitive's output, in order."""
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    return [t for v in out for t in _leaves(v)]


@pytest.mark.parametrize("name", ["crc16_tag", "acl_match", "maglev_select",
                                  "payload_store", "payload_fetch",
                                  "split_control", "merge_stage",
                                  "merge_payload"])
def test_cuda_backend_raises_on_cpu_tensors(name):
    before = launch_counts()
    with pytest.raises((RuntimeError, NotImplementedError)):
        tdispatch(name, "cuda")(*_cpu_args(name))
    assert launch_counts() == before
    assert all(v == 0 for v in launch_counts().values())


@pytest.mark.parametrize("name", ["crc16_tag", "acl_match", "maglev_select",
                                  "payload_store", "payload_fetch",
                                  "split_control", "merge_stage",
                                  "merge_payload"])
def test_auto_backend_runs_plain_version_on_cpu(name):
    args = _cpu_args(name)
    got = _leaves(tdispatch(name, "auto")(*map(_clone, args)))
    want = _leaves(tdispatch(name, "ref")(*map(_clone, args)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(v == 0 for v in launch_counts().values())


def test_backend_config_validates_and_overrides():
    with pytest.raises(ValueError):
        BackendConfig("pallas")
    with pytest.raises(ValueError):
        BackendConfig("auto", {"nope": "ref"})
    cfg = BackendConfig("auto", {"payload_store": "ref"})
    assert cfg.mode("payload_store") == "ref"
    assert cfg.mode("crc16_tag") == "auto"
    assert cfg == BackendConfig("auto", (("payload_store", "ref"),))
    cfg = BackendConfig("cuda", {"split_control": "ref",
                                 "merge_stage": "auto"})
    assert cfg.mode("split_control") == "ref"
    assert cfg.mode("merge_stage") == "auto"
    assert cfg.mode("payload_fetch") == "cuda"
    assert cfg.overrides == (("merge_stage", "auto"),
                             ("split_control", "ref"))


# --------------------------------------------------------------------------
# the CUDA wrappers' checks and bindings, reachable without a card
# --------------------------------------------------------------------------

def test_payload_store_cuda_raises_on_cpu_tensors():
    from repro_torch.kernels import payload_store as PS
    table, payload, idx, enb = _cpu_args("payload_store")
    with pytest.raises(RuntimeError):
        PS.payload_store_cuda(table, payload, idx, enb)
    assert launch_counts()["payload_store"] == 0


def test_payload_store_cuda_raises_past_its_shared_memory():
    """Past one block's shared memory the launcher tiles the batch, so the
    size raises nothing: a CPU call raises only for its device."""
    from repro_torch.kernels import payload_store as PS
    b = PS.MAX_PACKETS + 1
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.payload_store_cuda(torch.zeros(4, 16, dtype=torch.uint8),
                              torch.zeros(b, 16, dtype=torch.uint8),
                              torch.zeros(b, dtype=torch.int32),
                              torch.ones(b, dtype=torch.bool))
    assert launch_counts()["payload_store"] == 0


def _fake_library(monkeypatch, module, calls):
    """Point ``module``'s wrapper at C functions built from
    ``build.SIGNATURES`` that record their arguments: ctypes converts each
    argument by the signature's type and raises on a count or type the
    signature does not take.  The launch counter is restored afterwards."""
    import ctypes
    from repro_torch.kernels import build

    class Lib:
        pass

    lib = Lib()
    for name, argtypes in build.SIGNATURES.items():
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
        fn = proto(lambda *a, name=name: calls.append((name, a)) or 0)
        setattr(lib, name, fn)
    lib._keep = [getattr(lib, n) for n in build.SIGNATURES]
    monkeypatch.setattr(module, "library", lambda: lib)
    monkeypatch.setattr(module, "require_cuda",
                        lambda name, *t: torch.device("cpu"))
    monkeypatch.setattr(module, "stream_handle", lambda dev: 0)
    monkeypatch.setitem(trace.COUNTERS, module.COUNT,
                        trace.COUNTERS[module.COUNT])


def test_payload_store_binding_matches_its_signature(monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import payload_store as PS
    calls = []
    _fake_library(monkeypatch, PS, calls)
    before = trace.COUNTERS[PS.COUNT]
    table, payload, idx, enb = _cpu_args("payload_store")
    PS.payload_store_cuda(table.view(1, 4, 16), payload.view(1, 8, 16),
                          idx.view(1, 8), enb.view(1, 8))
    assert [c[0] for c in calls] == ["pp_payload_store"]
    assert len(calls[0][1]) == len(build.SIGNATURES["pp_payload_store"]) == 10
    assert calls[0][1][4:9] == (1, 8, 8, 4, 16)  # pipes, b, stride, m, width
    assert trace.COUNTERS[PS.COUNT] == before + 1  # one launch per call


@pytest.mark.parametrize("pipes,b", [(1, 16384), (3, 2 * 12288 + 5),
                                     (2, 12288)])
def test_payload_store_cuda_tiles_past_max_packets(monkeypatch, pipes, b):
    """A batch past ``MAX_PACKETS`` packets a pipe runs as consecutive
    launches over tiles of at most ``MAX_PACKETS``, in arrival order: each
    launch names its tile's first packet of every pipe (the pipes lie
    ``b`` packets apart) and counts one launch."""
    from repro_torch.kernels import payload_store as PS
    calls = []
    _fake_library(monkeypatch, PS, calls)
    before = trace.COUNTERS[PS.COUNT]
    m, w = 64, 16
    table = torch.zeros(pipes, m, w, dtype=torch.uint8)
    payload = torch.zeros(pipes, b, w, dtype=torch.uint8)
    idx = torch.zeros(pipes, b, dtype=torch.int32)
    enb = torch.ones(pipes, b, dtype=torch.bool)
    assert PS.payload_store_cuda(table, payload, idx, enb) is table
    tiles = list(range(0, b, PS.MAX_PACKETS))
    assert [c[0] for c in calls] == ["pp_payload_store"] * len(tiles)
    assert trace.COUNTERS[PS.COUNT] == before + len(tiles)
    for lo, (_, args) in zip(tiles, calls):
        assert args[0] == table.data_ptr()
        assert args[1] == payload.data_ptr() + lo * w
        assert args[2] == idx.data_ptr() + lo * 4
        assert args[3] == enb.data_ptr() + lo
        assert args[4:9] == (pipes, min(PS.MAX_PACKETS, b - lo), b, m, w)


def test_paged_attention_binding_matches_its_signature(monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as PA
    calls = []
    _fake_library(monkeypatch, PA, calls)
    monkeypatch.setattr(PA, "_TICKETS", {})
    before = trace.COUNTERS[PA.COUNT]
    q = torch.zeros(1, 2, 8, 128, dtype=torch.bfloat16)
    pages = torch.zeros(16, 16, 2, 128, dtype=torch.bfloat16)
    pt = torch.arange(12, dtype=torch.int32)[None]
    ln = torch.tensor([160], dtype=torch.int32)
    PA.paged_decode_attention_cuda(q, pages, pages, pt, ln)
    assert [c[0] for c in calls] == ["pp_paged_attention"]
    args = calls[0][1]
    assert len(args) == len(build.SIGNATURES["pp_paged_attention"]) == 22
    # dtype, b, K, G, E, pages, page, MP, split_tokens, splits, stages
    assert args[9:20] == (0, 1, 2, 8, 128, 16, 16, 12, 192, 1, 2)
    assert args[6:9] == (None, None, None)          # one split: no scratch
    assert trace.COUNTERS[PA.COUNT] == before + 1
    # 32 splits: scratch and tickets
    calls.clear()
    pt = torch.arange(128, dtype=torch.int32)[None] % 16
    PA.paged_decode_attention_cuda(q, pages, pages, pt, ln)
    assert calls[0][1][17:20] == (64, 32, 1)
    assert all(a is not None for a in calls[0][1][6:9])
    assert trace.COUNTERS[PA.COUNT] == before + 2
