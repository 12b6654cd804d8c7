"""The port's LM building blocks against the reference's, one piece at a
time on the same numpy inputs and converted parameters: blockwise and
decode attention, M-RoPE angles, the cache ring, MoE dispatch with drops,
the SSD and RG-LRU recurrences, MLA, and the shape table.

bf16 results are held within 0.02 + 0.02 relative (one or two bf16
rounding steps on values of order 1, as ``tests/test_torch_models.py``);
f32 results within 1e-4; integer and layout results exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models import ssd  # noqa: E402


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, atol=0.02, rtol=0.02):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _bf16(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    return a, convert.tensor(a, "cpu")


def _params(jinit, name, **kw):
    """A block's reference parameters (key 0) on the reduced config, and
    the port's conversion of them."""
    jcfg = jreduced(jconfigs.get(name))
    if kw:
        jcfg = dataclasses.replace(jcfg, **kw)
    jp = jinit(jax.random.key(0), jcfg)
    tcfg = reduced(configs.get(name))
    if kw:
        tcfg = dataclasses.replace(tcfg, **kw)
    return jcfg, tcfg, jp, convert.lm_params(jax.tree.map(np.asarray, jp),
                                             "cpu")


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw,s,t,ve", [
    (dict(causal=True), 64, 64, 16),
    (dict(causal=True, q_block=16, kv_block=32), 64, 64, 16),
    (dict(causal=True, window=10, q_block=16, kv_block=16), 64, 64, 16),
    (dict(causal=True, q_offset=48, q_block=8, kv_block=16), 16, 64, 16),
    (dict(causal=False, q_block=8, kv_block=8), 24, 40, 16),
    (dict(causal=True, q_block=16, kv_block=16), 32, 32, 24),
], ids=["causal", "blocks", "window", "q_offset", "non_causal", "mla_value"])
def test_blockwise_attention(kw, s, t, ve):
    rng = np.random.default_rng(0)
    qj, qt = _bf16(rng, (2, s, 2, 3, 16))
    kj, kt = _bf16(rng, (2, t, 2, 16))
    vj, vt = _bf16(rng, (2, t, 2, ve))
    want = jcm.blockwise_attention(qj, kj, vj, **kw)
    got = cm.blockwise_attention(qt, kt, vt, **kw)
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_blockwise_attention_rejects_blocks_that_do_not_divide():
    q = torch.zeros(1, 24, 1, 1, 8)
    k = torch.zeros(1, 24, 1, 8)
    with pytest.raises(ValueError, match="do not divide"):
        cm.blockwise_attention(q, k, k, q_block=16)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention(window):
    rng = np.random.default_rng(1)
    qj, qt = _bf16(rng, (3, 2, 4, 16))
    kj, kt = _bf16(rng, (3, 20, 2, 16))
    vj, vt = _bf16(rng, (3, 20, 2, 16))
    lengths = np.array([1, 13, 20], np.int32)
    want = jcm.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                window=window)
    got = cm.decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                              window=window)
    _close(got, want)


def test_mrope_angles():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4096, (3, 2, 5)).astype(np.int32)
    for sections, e in (((2, 3, 3), 16), ((16, 24, 24), 128)):
        cj, sj = jcm.rope_angles(jnp.asarray(pos), e, 1_000_000.0, sections)
        ct, st = cm.rope_angles(torch.from_numpy(pos), e, 1_000_000.0,
                                sections)
        # angles of up to ~4096 rad: f32 pow/cos/sin differ by a few ulp
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-3)
    # equal (t, h, w) positions give the plain rotary angles
    flat = np.broadcast_to(pos[:1], pos.shape).copy()
    c3, s3 = cm.rope_angles(torch.from_numpy(flat), 16, 1e4, (2, 3, 3))
    c1, s1 = cm.rope_angles(torch.from_numpy(flat[0]), 16, 1e4)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)
    with pytest.raises(ValueError, match="sum"):
        cm.rope_angles(torch.from_numpy(pos), 16, 1e4, (2, 3, 4))


def test_embed_one_hot_and_unembed_shard_hook():
    cfg = reduced(configs.get("gemma-7b"))
    p = cm.embed_init(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.tensor([[0, 5, 255, 17]])
    assert torch.equal(cm.embed_apply(p, toks, cfg),
                       cm.embed_apply(p, toks, cfg, one_hot_matmul=True))
    x = cm.embed_apply(p, toks, cfg)
    seen = []
    out = cm.unembed_apply(p, x, cfg,
                           shard=lambda t, name: seen.append(name) or t)
    assert seen == ["logits"] and torch.equal(out, cm.unembed_apply(p, x,
                                                                    cfg))


# --------------------------------------------------------------------------
# the cache ring
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,cache_len", [(12, 16), (12, 12), (12, 5),
                                         (40, 16)])
def test_prefill_cache_layout_exact(s, cache_len):
    arr = np.arange(2 * s * 3, dtype=np.float32).reshape(2, s, 3)
    want = jlm._prefill_cache_layout(jnp.asarray(arr), cache_len)
    got = lm._prefill_cache_layout(torch.from_numpy(arr), cache_len)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_ring_write_exact():
    rng = np.random.default_rng(3)
    buf = rng.standard_normal((3, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    lengths = np.array([1, 8, 19], np.int32)  # slots 0, 7 and 2
    want = jlm._ring_write(jnp.asarray(buf), jnp.asarray(new),
                           jnp.asarray(lengths), jlm._identity)
    tbuf = torch.from_numpy(buf)
    got = lm._ring_write(tbuf, torch.from_numpy(new),
                         torch.from_numpy(lengths), lm._identity)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tbuf.numpy(), buf)  # a new buffer


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,b,s,capacity,skew", [
    ("mixtral-8x7b", 2, 32, 1.25, True),    # default capacity: drops
    ("mixtral-8x7b", 2, 40, 0.5, False),    # drops in groups of 20
    ("deepseek-v2-236b", 2, 16, 1.25, False),  # shared experts
    ("mixtral-8x7b", 1, 1, 1.25, False),    # one token (a decode step)
])
def test_moe_apply(name, b, s, capacity, skew):
    """``skew`` gives every token a common direction, so the router sends
    most of them to the same experts and the default capacity drops the
    latecomers in arrival order."""
    jcfg, tcfg, jp, tp = _params(jmoe.moe_init, name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=capacity))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=capacity))
    assert moe._capacity(tcfg.moe, 32) == jmoe._capacity(jcfg.moe, 32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, 64))
    if skew:
        x = 0.3 * x + rng.standard_normal(64)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = convert.tensor(xj, "cpu")
    for act in ("silu", "gelu"):
        wo, wa = jmoe.moe_apply(jp, xj, jcfg, act)
        go, ga = moe.moe_apply(tp, xt, tcfg, act)
        _close(go, wo, atol=0.03)
        assert abs(float(ga) - float(wa)) < 1e-5
    # drops show: the same call with room for every token differs
    roomy = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    dropped = not torch.equal(moe.moe_apply(tp, xt, roomy, "gelu")[0], go)
    assert dropped == (skew or capacity < 1), dropped


def test_moe_apply_takes_given_experts():
    """``top_i`` names the experts each token takes: the router's own
    choice gives the same result, other experts another one, weighted by
    the router's renormalised probabilities at them."""
    _, tcfg, _, tp = _params(jmoe.moe_init, "mixtral-8x7b")
    x = convert.tensor(jnp.asarray(np.random.default_rng(10).standard_normal(
        (2, 6, 64)), jnp.bfloat16), "cpu")
    out, aux = moe.moe_apply(tp, x, tcfg, "silu")
    probs = torch.softmax(x.float() @ tp["router"], dim=-1)
    own = torch.topk(probs, tcfg.moe.top_k, dim=-1).indices
    same, same_aux = moe.moe_apply(tp, x, tcfg, "silu", top_i=own)
    assert torch.equal(same, out) and torch.equal(same_aux, aux)
    other = (own + 1) % tcfg.moe.num_experts
    moved, _ = moe.moe_apply(tp, x, tcfg, "silu", top_i=other)
    assert not torch.equal(moved, out)
    # one token, one layer by hand: the experts given, renormalised
    w = probs[0, 0][other[0, 0]]
    w = w / w.sum()
    want = sum(wi * cm.mlp_apply({k: tp[k][e] for k in ("wi", "wg", "wo")},
                                 x[:1, :1], "silu").float()
               for wi, e in zip(w, other[0, 0]))
    _close(moved[:1, :1], want, atol=0.03)


# --------------------------------------------------------------------------
# SSD and RG-LRU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 13, 5])  # 2 chunks, padded, one chunk
def test_ssd_seq_and_step(s):
    jcfg, tcfg, jp, tp = _params(jssd.ssd_init, "mamba2-1.3b")
    rng = np.random.default_rng(5)
    xj, xt = _bf16(rng, (2, s, 64))
    wo, (wh, wc) = jssd.ssd_seq(jp, xj, jcfg)
    go, (gh, gc) = ssd.ssd_seq(tp, xt, tcfg)
    _close(go, wo, atol=0.03)
    _close(gh, wh, atol=0.03)
    for k in ("x", "b", "c"):
        _close(gc[k], wc[k])
    # one decode step from the reference's state
    yj, yt = _bf16(rng, (2, 1, 64))
    so, (sh, sc) = jssd.ssd_step(jp, yj, jcfg, (wh, wc))
    to, (th, tc) = ssd.ssd_step(
        tp, yt, tcfg, (convert.tensor(wh, "cpu"),
                       {k: convert.tensor(v, "cpu") for k, v in wc.items()}))
    _close(to, so)
    _close(th, sh)
    for k in ("x", "b", "c"):
        assert np.array_equal(_np(tc[k]), _np(sc[k]))


def test_ssd_seq_in_f32_matches_to_rounding():
    jcfg, tcfg, jp, tp = _params(jssd.ssd_init, "mamba2-1.3b")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = {k: v.float() for k, v in tp.items()}
    x = np.random.default_rng(6).standard_normal((2, 13, 64)).astype(
        np.float32)
    wo, (wh, _) = jssd.ssd_seq(jp, jnp.asarray(x), jcfg)
    go, (gh, _) = ssd.ssd_seq(tp, torch.from_numpy(x), tcfg)
    _close(go, wo, atol=1e-4, rtol=1e-4)
    _close(gh, wh, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s,h0", [(16, False), (7, True), (1, False)])
def test_rglru_seq_and_step(s, h0):
    jcfg, tcfg, jp, tp = _params(jrg.rglru_init, "recurrentgemma-9b")
    rng = np.random.default_rng(7)
    xj, xt = _bf16(rng, (2, s, 64))
    hj = ht = None
    cj, ct = _bf16(rng, (2, 3, 64))
    if h0:
        h = rng.standard_normal((2, 64)).astype(np.float32)
        hj, ht = jnp.asarray(h), torch.from_numpy(h)
    wo, (wh, wc) = jrg.rglru_seq(jp, xj, jcfg, conv_state=cj if h0 else None,
                                 h0=hj)
    go, (gh, gc) = rg.rglru_seq(tp, xt, tcfg, conv_state=ct if h0 else None,
                                h0=ht)
    _close(go, wo)
    _close(gh, wh)
    assert np.array_equal(_np(gc), _np(wc))
    yj, yt = _bf16(rng, (2, 1, 64))
    so, (sh, _) = jrg.rglru_step(jp, yj, jcfg, (wh, wc))
    to, (th, _) = rg.rglru_step(tp, yt, tcfg, (convert.tensor(wh, "cpu"),
                                               convert.tensor(wc, "cpu")))
    _close(to, so)
    _close(th, sh)


def test_linear_scan_equals_the_sequential_recurrence():
    gen = torch.Generator().manual_seed(8)
    for s in (1, 2, 5, 16, 33):
        a = torch.rand((2, s, 6), generator=gen)
        b = torch.randn((2, s, 6), generator=gen)
        h, want = torch.zeros(2, 6), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(rg.linear_scan(a, b),
                                   torch.stack(want, 1), atol=1e-5,
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def test_mla_attention_and_decode():
    jcfg, tcfg, jp, tp = _params(jmla.mla_init, "deepseek-v2-236b")
    rng = np.random.default_rng(9)
    s = 12
    xj, xt = _bf16(rng, (2, s, 64))
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).astype(np.int32)
    e = jcfg.mla.rope_head_dim
    cj, sj = jcm.rope_angles(jnp.asarray(pos), e, jcfg.rope_theta)
    ct, st = cm.rope_angles(torch.from_numpy(pos), e, tcfg.rope_theta)
    wo, (wc, wr) = jmla.mla_attention(jp, xj, jcfg, cj, sj, q_block=4,
                                      kv_block=6)
    go, (gc, gr) = mla.mla_attention(tp, xt, tcfg, ct, st, q_block=4,
                                     kv_block=6)
    _close(go, wo, atol=0.03)
    _close(gc, wc)
    _close(gr, wr)
    # decode the last position against the latent cache of all 12
    lengths = np.array([12, 7], np.int32)
    do = jmla.mla_decode(jp, xj[:, -1:], jcfg, cj[:, -1:], sj[:, -1:],
                         (wc, wr), jnp.asarray(lengths))
    to = mla.mla_decode(tp, xt[:, -1:], tcfg, ct[:, -1:], st[:, -1:],
                        (convert.tensor(wc, "cpu"), convert.tensor(wr, "cpu")),
                        torch.from_numpy(lengths))
    _close(to, do, atol=0.03)


# --------------------------------------------------------------------------
# shapes
# --------------------------------------------------------------------------

def test_shapes_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for name in configs.names():
        got = [(dataclasses.asdict(s), ok, why)
               for s, ok, why in shapes.cells(configs.get(name))]
        want = [(dataclasses.asdict(s), ok, why)
                for s, ok, why in jshapes.cells(jconfigs.get(name))]
        assert got == want, name
