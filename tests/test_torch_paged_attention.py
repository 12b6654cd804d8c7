"""The plain ``paged_decode_attention`` against the reference's
``paged_decode_attention_ref`` and its Pallas kernel in interpret mode, on
the same numpy inputs, within the reference's own tolerances (atol 0.02,
rtol 0.05, tests/test_kernels.py); plus the registry's device rules for the
``paged_attention`` primitive on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import \
    paged_decode_attention as pallas_paged  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_decode_attention_ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.backend import dispatch  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402

ATOL, RTOL = 0.02, 0.05


def _inputs(seed, b, k, g, e, page, mp, npages=None, tables=None,
            lengths=None, dtype=jnp.bfloat16):
    """Numpy-seeded inputs as JAX arrays; without ``tables`` each request
    gets distinct random pages and a length within them, as the
    reference's sweep test draws them."""
    rng = np.random.default_rng(seed)
    npages = npages or mp * b + 2
    q = jnp.asarray(rng.standard_normal((b, k, g, e)), dtype)
    kp = jnp.asarray(rng.standard_normal((npages, page, k, e)), dtype)
    vp = jnp.asarray(rng.standard_normal((npages, page, k, e)), dtype)
    if tables is None:
        pt = np.full((b, mp), -1, np.int32)
        ln = np.zeros((b,), np.int32)
        for i in range(b):
            n = rng.integers(1, mp + 1)
            pt[i, :n] = rng.choice(npages, n, replace=False)
            ln[i] = rng.integers(1, n * page + 1)
    else:
        pt = np.asarray(tables, np.int32)
        ln = np.asarray(lengths, np.int32)
    return q, kp, vp, jnp.asarray(pt), jnp.asarray(ln)


def _port(args):
    out = R.paged_decode_attention(*(convert.tensor(a, "cpu") for a in args))
    return out.float().numpy()


def _close(got, want, rows=slice(None)):
    np.testing.assert_allclose(got[rows], np.asarray(want, np.float32)[rows],
                               atol=ATOL, rtol=RTOL)


SWEEP = [(4, 2, 4, 64, 16, 6), (2, 1, 8, 128, 128, 4), (8, 4, 1, 32, 8, 3)]


@pytest.mark.parametrize("b,k,g,e,page,mp", SWEEP)
def test_plain_matches_reference_sweep(b, k, g, e, page, mp):
    args = _inputs(5, b, k, g, e, page, mp)
    got = _port(args)
    _close(got, paged_decode_attention_ref(*args))
    _close(got, pallas_paged(*args, interpret=True))


@pytest.mark.parametrize("shape", [(1, 2, 8, 128, 16, 12),
                                   (2, 16, 1, 256, 16, 4),
                                   (3, 1, 4, 16, 4, 8)],
                         ids=["engine", "gemma", "reduced"])
def test_plain_matches_reference_serving_shapes(shape):
    args = _inputs(7, *shape)
    got = _port(args)
    _close(got, paged_decode_attention_ref(*args))
    _close(got, pallas_paged(*args, interpret=True))


def test_plain_matches_reference_in_f32():
    args = _inputs(9, 4, 2, 4, 64, 16, 6, dtype=jnp.float32)
    got = _port(args)
    assert got.dtype == np.float32
    _close(got, paged_decode_attention_ref(*args))


# -1 pages inside the length (also as the first page) and after it, a
# length on a page boundary, length 1; then length 0 and no live page
EDGE_TABLES = [[1, -1, 2, 3, -1, -1], [-1, 4, 5, -1, -1, -1],
               [6, 7, 8, -1, -1, -1], [9, 10, -1, -1, 11, 12],
               [13, -1, -1, -1, -1, -1],
               [14, 15, -1, -1, -1, -1], [-1, -1, -1, -1, -1, -1]]
EDGE_LENGTHS = [60, 40, 20, 32, 1, 0, 30]


def test_plain_matches_reference_on_edge_cases():
    args = _inputs(11, 7, 2, 4, 64, 16, 6, npages=20, tables=EDGE_TABLES,
                   lengths=EDGE_LENGTHS)
    got = _port(args)
    live = slice(0, 5)
    _close(got, paged_decode_attention_ref(*args), live)
    _close(got, pallas_paged(*args, interpret=True), live)


def test_no_live_token_gives_zeros():
    """Length 0 and a request whose pages are all -1: the port (and its
    kernel, which never reads a -1 page) give zeros; the reference gives
    the mean of the clamped page 0's values there."""
    args = _inputs(11, 7, 2, 4, 64, 16, 6, npages=20, tables=EDGE_TABLES,
                   lengths=EDGE_LENGTHS)
    got = _port(args)
    assert np.all(got[5:] == 0.0)
    want = np.asarray(paged_decode_attention_ref(*args), np.float32)
    assert np.abs(want[5:]).max() > 0


def test_length_one_returns_the_value_row_exactly():
    """One live token: softmax weight 1, so the output is v itself (the
    engine's first position relies on this)."""
    args = _inputs(13, 2, 2, 4, 64, 16, 3, npages=8,
                   tables=[[5, -1, -1], [2, 3, -1]], lengths=[1, 1])
    got = R.paged_decode_attention(*(convert.tensor(a, "cpu") for a in args))
    vp = convert.tensor(args[2], "cpu")
    for i, page in enumerate((5, 2)):
        want = vp[page, 0][:, None, :].expand(2, 4, 64)
        assert torch.equal(got[i], want)


def test_out_of_range_page_is_clamped_as_the_reference():
    args = _inputs(15, 1, 1, 2, 32, 8, 2, npages=4, tables=[[1, 9]],
                   lengths=[12])
    _close(_port(args), paged_decode_attention_ref(*args))


def test_registry_device_rules_on_cpu():
    args = [convert.tensor(a, "cpu")
            for a in _inputs(17, 2, 2, 4, 64, 16, 3)]
    before = launch_counts()
    with pytest.raises(RuntimeError):
        dispatch("paged_attention", "cuda")(*args)
    auto = dispatch("paged_attention", "auto")(*args)
    assert torch.equal(auto, dispatch("paged_attention", "ref")(*args))
    assert launch_counts() == before
    assert launch_counts()["paged_attention"] == 0


# --------------------------------------------------------------------------
# the CUDA kernel's split-K plan and its split/combine algebra, emulated
# --------------------------------------------------------------------------

from repro_torch.kernels import paged_attention as PA  # noqa: E402

# (B, K, G, E, page, MP): the engine, batched, sweep, Gemma and head_dim-16
# shapes of chip_smoke.py's phase 2
PLAN_SHAPES = {
    "engine": (1, 2, 8, 128, 16, 12),
    "batched": (8, 2, 8, 128, 16, 128),
    "sweep0": SWEEP[0], "sweep1": SWEEP[1], "sweep2": SWEEP[2],
    "gemma": (2, 16, 1, 256, 16, 8),
    "head_dim16": (3, 1, 4, 16, 4, 8),
    "long": (1, 2, 8, 128, 16, 128),
    "wide": (2, 2, 20, 64, 8, 40),
    "page4": (2, 2, 8, 64, 4, 96),
}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_split_plan_covers_every_token_once(name):
    b, k, g, e, page, mp = PLAN_SHAPES[name]
    st, splits = PA.split_plan(b, k, mp, page, g)
    assert st % PA.TILE == 0 and 1 <= splits <= PA.MAX_SPLITS
    total = mp * page
    seen = np.zeros(total, np.int64)
    for s in range(splits):
        lo, hi = s * st, min((s + 1) * st, total)
        assert lo < hi  # no empty split
        seen[lo:hi] += 1
    assert np.all(seen == 1)
    heads = b * k * -(-g // PA.COLS)
    assert heads * splits <= max(heads, 2 * PA.TARGET_BLOCKS)


def test_split_plan_gives_the_engine_and_batched_grids():
    assert PA.split_plan(1, 2, 12, 16, 8) == (192, 1)     # 2 blocks
    assert PA.split_plan(8, 2, 128, 16, 8) == (128, 16)   # 256 blocks
    assert PA.split_plan(1, 2, 128, 16, 8) == (64, 32)    # 64 blocks
    assert PA.split_plan(1, 2, 13, 16, 8) == (64, 4)      # past 192 tokens


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulate(q, kp, vp, pt, ln):
    """The kernel's algorithm in f32 on the CPU: per (request, KV head, 8
    query rows) and split, each warp's online softmax over its 16-token
    tiles (probabilities rounded to the value type before PV, l summed in
    f32), the warps merged into the block's partial, the partials merged
    by the last block."""
    b, kh, g, e = q.shape
    npages, page = kp.shape[:2]
    mp = pt.shape[1]
    st, splits = PA.split_plan(b, kh, mp, page, g)
    rnd = _bf16 if vp.dtype == torch.bfloat16 else (lambda x: x)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    out = torch.zeros((b, kh, g, e))
    neg = -1e30
    for bi in range(b):
        total = max(0, min(int(ln[bi]), mp * page))
        for h in range(kh):
            for g0 in range(0, g, PA.COLS):
                rows = qf[bi, h, g0:g0 + PA.COLS]            # (Gc, E)
                parts = []
                for sp in range(splits):
                    lo, hi = sp * st, min(sp * st + st, total)
                    warps = []
                    for w in range(PA.WARPS):
                        m = torch.full((rows.shape[0],), neg)
                        l = torch.zeros(rows.shape[0])
                        acc = torch.zeros(rows.shape[0], e)
                        t0 = lo + w * PA.TILE
                        while lo < hi and t0 < hi:
                            t = torch.arange(t0, t0 + PA.TILE)
                            pid = pt[bi, (t // page).clamp(max=mp - 1)]
                            live = (t < hi) & (pid >= 0)
                            pid = pid.clamp(0, npages - 1)
                            kt = kf[pid, t % page, h]             # (16, E)
                            vt = vf[pid, t % page, h]
                            vt = torch.where(live[:, None], vt, 0.0)
                            s = (kt @ rows.T) * e ** -0.5         # (16, Gc)
                            x = torch.where(live[:, None], s, neg)
                            mn = torch.maximum(m, x.max(0).values)
                            p = torch.where(live[:, None],
                                            torch.exp(x - mn), 0.0)
                            al = torch.exp(m - mn)
                            l = l * al + p.sum(0)
                            acc = acc * al[:, None] + rnd(p).T @ vt
                            m = mn
                            t0 += PA.WARPS * PA.TILE
                        warps.append((m, l, acc))
                    big = torch.stack([w[0] for w in warps]).max(0).values
                    sc = [torch.exp(w[0] - big) for w in warps]
                    parts.append((big,
                                  sum(w[1] * c for w, c in zip(warps, sc)),
                                  sum(w[2] * c[:, None]
                                      for w, c in zip(warps, sc))))
                big = torch.stack([p[0] for p in parts]).max(0).values
                wt = [torch.exp(p[0] - big) for p in parts]
                l = sum(p[1] * c for p, c in zip(parts, wt))
                acc = sum(p[2] * c[:, None] for p, c in zip(parts, wt))
                out[bi, h, g0:g0 + PA.COLS] = acc / l.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


def _emulated(args):
    got = _emulate(*(convert.tensor(a, "cpu") for a in args)).float()
    assert torch.isfinite(got).all()
    return got.numpy()


@pytest.mark.parametrize("name", ["engine", "sweep0", "sweep1", "sweep2",
                                  "gemma", "head_dim16", "wide", "page4"])
def test_split_combine_matches_reference_and_plain(name):
    args = _inputs(19, *PLAN_SHAPES[name])
    got = _emulated(args)
    _close(got, paged_decode_attention_ref(*args))
    _close(got, _port(args))


def test_split_combine_matches_reference_at_the_batched_shape():
    """8 requests of up to 2048 tokens: 32 splits per (request, KV head)."""
    b, k, g, e, page, mp = PLAN_SHAPES["batched"]
    rng = np.random.default_rng(23)
    lengths = rng.integers(1, mp * page + 1, b)
    lengths[0] = mp * page
    pt = rng.permutation(b * mp + 16)[:b * mp].reshape(b, mp)
    pt = np.where(np.arange(mp)[None] * page < lengths[:, None], pt, -1)
    args = _inputs(23, b, k, g, e, page, mp, npages=b * mp + 16,
                   tables=pt, lengths=lengths)
    got = _emulated(args)
    _close(got, paged_decode_attention_ref(*args))
    _close(got, _port(args))


def test_split_combine_in_f32_matches_reference():
    args = _inputs(29, 4, 2, 4, 64, 16, 6, dtype=jnp.float32)
    _close(_emulated(args), paged_decode_attention_ref(*args))


# (5, 2, 8, 128), 16-token pages, MP 32: 8 splits of 64 tokens (4 pages).
# Request 0 has a split of -1 pages only inside its length, request 1 ends
# mid-split, request 2's last splits lie wholly past its length, then
# lengths 1 and 0
_NONE = [-1] * 32
SPLIT_TABLES = [list(range(0, 4)) + [-1] * 4 + list(range(4, 28)),
                list(range(28, 34)) + _NONE[6:],
                list(range(34, 66)),
                [66] + _NONE[1:], [67, 68] + _NONE[2:]]
SPLIT_LENGTHS = [250, 90, 40, 1, 0]


def test_split_combine_edge_splits():
    assert PA.split_plan(5, 2, 32, 16, 8) == (64, 8)
    args = _inputs(31, 5, 2, 8, 128, 16, 32, npages=70, tables=SPLIT_TABLES,
                   lengths=SPLIT_LENGTHS)
    got = _emulated(args)
    live = slice(0, 4)
    _close(got, paged_decode_attention_ref(*args), live)
    _close(got, _port(args))
    assert np.all(got[4] == 0.0)          # length 0: zeros, no NaN
    vp = convert.tensor(args[2], "cpu")   # length 1: the value row itself
    want = vp[66, 0][:, None, :].expand(2, 8, 128).float().numpy()
    np.testing.assert_array_equal(got[3], want)


def test_split_combine_gives_zeros_without_a_live_token():
    args = _inputs(11, 7, 2, 4, 64, 16, 6, npages=20, tables=EDGE_TABLES,
                   lengths=EDGE_LENGTHS)
    got = _emulated(args)
    _close(got, _port(args))
    _close(got, paged_decode_attention_ref(*args), slice(0, 5))
    assert np.all(got[5:] == 0.0)


def test_launch_plan_stages_and_shared_memory():
    # engine: one split of 3 tiles per warp, two stages
    plan = PA.launch_plan(1, 2, 8, 128, 2, 12, 16)
    assert (plan["splits"], plan["stages"], plan["heads"]) == (1, 2, 2)
    assert plan["shared"] == PA.shared_bytes(128, 2, 2, 1) <= PA.MAX_SHARED
    # one tile per warp: one stage; batched and many tiles per warp: two
    assert PA.launch_plan(1, 2, 8, 128, 2, 128, 16)["stages"] == 1
    assert PA.launch_plan(8, 2, 8, 128, 2, 128, 16)["stages"] == 2
    assert PA.launch_plan(64, 8, 8, 128, 2, 128, 16)["stages"] == 2
    # f32 at E = 256: two stages do not fit, one does
    assert PA.shared_bytes(256, 4, 2, 1) > PA.MAX_SHARED
    assert PA.launch_plan(64, 8, 8, 256, 4, 128, 16)["stages"] == 1
    # what one stage cannot hold is rejected
    assert PA.shared_bytes(1024, 4, 1, 1) > PA.MAX_SHARED
    with pytest.raises(ValueError):
        PA.launch_plan(1, 1, 8, 1024, 4, 4, 16)
