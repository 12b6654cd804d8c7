"""The port's PayloadPark header entry point (``repro_torch.core.header``)
against the reference's ``repro.core.header`` on the same seeded numpy
tags, corrupted CRCs included, compared exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import header as JH  # noqa: E402
from repro_torch.backend import ref as R  # noqa: E402
from repro_torch.core import header as TH  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402


def _tags(seed, n):
    rng = np.random.default_rng(seed)
    ti = rng.integers(0, 1 << 16, n).astype(np.int32)
    clk = rng.integers(0, 1 << 16, n).astype(np.int32)
    return ti, clk


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_crc16_tag_and_tag_valid_match_reference(n):
    ti, clk = _tags(n, n)
    want = np.asarray(JH.crc16_tag(jnp.asarray(ti), jnp.asarray(clk),
                                   backend="ref"))
    got = TH.crc16_tag(torch.from_numpy(ti), torch.from_numpy(clk))
    assert np.array_equal(want, got.numpy())
    # flip one CRC bit in about a third of the tags
    rng = np.random.default_rng(n + 1)
    bad = rng.random(n) < 0.3
    crc = np.where(bad, want ^ (1 << rng.integers(0, 16, n)), want)
    crc = crc.astype(np.int32)
    jv = np.asarray(JH.tag_valid(jnp.asarray(ti), jnp.asarray(clk),
                                 jnp.asarray(crc), backend="ref"))
    tv = TH.tag_valid(torch.from_numpy(ti), torch.from_numpy(clk),
                      torch.from_numpy(crc), backend="ref")
    assert np.array_equal(jv, tv.numpy())
    assert np.array_equal(tv.numpy(), ~bad)


def test_header_routes_through_the_registry_on_cpu():
    ti, clk = (torch.from_numpy(a) for a in _tags(7, 64))
    with pytest.raises(RuntimeError):
        TH.crc16_tag(ti, clk, backend="cuda")
    assert torch.equal(TH.crc16_tag(ti, clk, backend="auto"),
                       TH.crc16_tag(ti, clk, backend="ref"))
    assert launch_counts()["crc16"] == 0


def test_constants_and_byte_helpers_match_reference():
    """The re-exported constants, and the byte-level routines the reference
    re-exports from its header (the port's live in ``backend/ref.py``)."""
    assert (TH.CRC_POLY, TH.CRC_INIT) == (JH.CRC_POLY, JH.CRC_INIT)
    assert (TH.CRC_POLY, TH.CRC_INIT) == (R.CRC_POLY, R.CRC_INIT)
    ti, clk = _tags(9, 33)
    want = np.asarray(JH.tag_bytes(jnp.asarray(ti), jnp.asarray(clk)))
    got = R.tag_bytes(torch.from_numpy(ti), torch.from_numpy(clk))
    assert np.array_equal(want, got.numpy())
    assert np.array_equal(
        np.asarray(JH.crc16_bytes(jnp.asarray(want))),
        R.crc16_bytes(got).numpy())
