"""The port's model pieces (``repro_torch.models``) against
``repro.models.common`` and ``repro.models.lm`` on the same numpy inputs
and converted parameters, and the parameter layout against the
reference's: keys, shapes and dtypes, at reduced size from real trees and
at full size from ``jax.eval_shape`` against the port on ``meta``.

bf16 tolerances: one bf16 rounding step is 2**-8 relative, so results of
order 1 that round at other places in the two frameworks differ by up to a
few 0.004-0.016 steps; the checks allow 0.02 + 0.02 relative on values of
order 1 (0.05 on the MLP output, which sums 128 rounded products).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.models.lm import segments_for as jsegments_for  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models.lm import LM, segments_for  # noqa: E402

def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return a, convert.tensor(a, "cpu")


def _close(got, want, atol=0.02, rtol=0.02):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def trees():
    """arch -> (reduced cfg of each package, reference params, port params
    converted from them)."""
    out = {}
    for name in ("gemma-7b", "qwen2.5-3b", "qwen3-32b"):
        jcfg = jreduced(jconfigs.get(name))
        jp = JLM(jcfg, remat_policy="off").init_params(jax.random.key(0))
        tp = convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")
        out[name] = (jcfg, reduced(configs.get(name)), jp, tp)
    return out


# --------------------------------------------------------------------------
# configs and parameter layout
# --------------------------------------------------------------------------

def test_config_registry_equals_reference():
    assert configs.names() == jconfigs.names()
    for n in configs.names():
        assert dataclasses.asdict(configs.get(n)) == \
            dataclasses.asdict(jconfigs.get(n))
        assert dataclasses.asdict(reduced(configs.get(n))) == \
            dataclasses.asdict(jreduced(jconfigs.get(n)))


def _layout(tree, prefix=""):
    """Dotted key -> (shape, dtype name) of a nested dict of arrays or
    tensors (``torch.bfloat16`` and JAX's ``bfloat16`` both give
    ``bfloat16``)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_layout(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = (tuple(v.shape),
                                str(v.dtype).removeprefix("torch."))
    return flat


@pytest.mark.parametrize("name", ["gemma-7b", "qwen2.5-3b", "qwen3-32b"])
def test_reduced_params_layout_and_conversion(trees, name):
    jcfg, tcfg, jp, tp = trees[name]
    own = LM(tcfg).init_params(torch.Generator().manual_seed(0))
    assert _layout(own) == _layout(jp) == _layout(tp)
    # conversion is leaf for leaf and bit for bit
    ref_wq = np.asarray(jp["blocks"]["sub0"]["attn"]["wq"])
    assert np.array_equal(
        tp["blocks"]["sub0"]["attn"]["wq"].view(torch.uint16).numpy(),
        ref_wq.view(np.uint16))


@pytest.mark.parametrize("name", jconfigs.names())
def test_full_params_layout_matches_eval_shape(name):
    jcfg = jconfigs.get(name)
    shapes = jax.eval_shape(JLM(jcfg, remat_policy="off").init_params,
                            jax.random.key(0))
    own = LM(configs.get(name)).init_params(device="meta")
    assert _layout(own) == _layout(shapes)
    assert [dataclasses.astuple(s) for s in segments_for(configs.get(name))] \
        == [dataclasses.astuple(s) for s in jsegments_for(jcfg)]


# --------------------------------------------------------------------------
# model pieces
# --------------------------------------------------------------------------

def test_rmsnorm():
    rng = np.random.default_rng(0)
    xj, xt = _bf16(rng, (2, 3, 64), 3.0)
    s = rng.standard_normal(64).astype(np.float32)
    _close(cm.rmsnorm(xt, torch.from_numpy(s), 1e-6),
           jcm.rmsnorm(xj, jnp.asarray(s), 1e-6))


def test_rope():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    cj, sj = jcm.rope_angles(jnp.asarray(pos), 128, 1_000_000.0)
    ct, st = cm.rope_angles(torch.from_numpy(pos), 128, 1_000_000.0)
    # angles of up to ~4096 rad: f32 pow/cos/sin differ by a few ulp of it
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-3)
    xj, xt = _bf16(rng, (2, 5, 4, 128))
    _close(cm.apply_rope(xt, ct, st), jcm.apply_rope(xj, cj, sj))


@pytest.mark.parametrize("name", ["qwen2.5-3b", "qwen3-32b", "gemma-7b"],
                         ids=["bias", "qk_norm", "plain"])
def test_attn_qkv_and_out(trees, name):
    jcfg, tcfg, jp, tp = trees[name]
    rng = np.random.default_rng(2)
    ja = jax.tree.map(lambda a: a[1], jp["blocks"]["sub0"]["attn"])
    ta = {k: v[1] for k, v in tp["blocks"]["sub0"]["attn"].items()}
    if jcfg.qkv_bias:  # non-zero biases, so the add is exercised
        for key in ("bq", "bk", "bv"):
            ja[key] = jnp.asarray(rng.standard_normal(ja[key].shape),
                                  jnp.bfloat16)
            ta[key] = convert.tensor(ja[key], "cpu")
    xj, xt = _bf16(rng, (1, 3, 64))
    pos = np.array([[0, 7, 40]], np.int32)
    cj, sj = jcm.rope_angles(jnp.asarray(pos), jcfg.head_dim, jcfg.rope_theta)
    ct, st = cm.rope_angles(torch.from_numpy(pos), tcfg.head_dim,
                            tcfg.rope_theta)
    want = jcm.attn_qkv(ja, xj, jcfg, cj, sj)
    got = cm.attn_qkv(ta, xt, tcfg, ct, st)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        _close(g, w)
    _close(cm.attn_out(ta, got[0]), jcm.attn_out(ja, want[0]))


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_apply(trees, act):
    _, _, jp, tp = trees["gemma-7b"]
    jf = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["ffn"])
    tf = {k: v[0] for k, v in tp["blocks"]["sub0"]["ffn"].items()}
    xj, xt = _bf16(np.random.default_rng(3), (1, 4, 64), 2.0)
    _close(cm.mlp_apply(tf, xt, act), jcm.mlp_apply(jf, xj, act), atol=0.05)


@pytest.mark.parametrize("name", ["gemma-7b", "qwen3-32b"],
                         ids=["scaled_tied", "untied"])
def test_embed_and_unembed(trees, name):
    jcfg, tcfg, jp, tp = trees[name]
    toks = np.array([[0, 5, 255, 17]], np.int32)
    ej = jcm.embed_apply(jp["embed"], jnp.asarray(toks), jcfg)
    et = cm.embed_apply(tp["embed"], torch.from_numpy(toks).long(), tcfg)
    # a gather and one bf16 multiply by bf16(sqrt(d_model)): bit for bit
    assert np.array_equal(et.view(torch.uint16).numpy(),
                          np.asarray(ej).view(np.uint16))
    _close(cm.unembed_apply(tp["embed"], et, tcfg),
           jcm.unembed_apply(jp["embed"], ej, jcfg), atol=0.05)


@pytest.mark.parametrize("shape", [(37, 50), (3, 40, 50), (5, 7)])
def test_ninit_draws_slice_by_slice(monkeypatch, shape):
    """A leaf past ``DRAW_CHUNK`` elements is drawn one ``randn`` a slice
    of its leading axis (recursively where one slice is larger), the
    slices' draws scaled and cast a buffer at a time; a smaller leaf in
    one draw: the same values as those draws made one by one."""
    monkeypatch.setattr(cm, "DRAW_CHUNK", 1000)

    def by_hand(gen, shape):
        if np.prod(shape) <= 1000:
            return torch.randn(shape, generator=gen)
        return torch.stack([by_hand(gen, shape[1:])
                            for _ in range(shape[0])])

    got = cm.ninit(torch.Generator().manual_seed(0), shape, 0.5, "cpu")
    want = (by_hand(torch.Generator().manual_seed(0), shape) * 0.5).to(
        cm.DTYPE)
    assert torch.equal(got, want)
