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
