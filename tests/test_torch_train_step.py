"""The port's training step (``repro_torch.training.train_step``) against
the reference's (``repro.training.train_step``) on all ten reduced
configs, from the same parameters (the reference's, carried across by
``convert.lm_params``) and the same batch (``tests/test_torch_lm.py``'s
recipe).

In f32 the two compute the same math up to f32 rounding: ``loss`` and
``ce`` within 1e-5 relative, ``aux`` within 1e-5, ``lr`` exact,
``grad_norm`` within 1e-4 relative, the new moments within 1e-4 of each
leaf's largest magnitude and the new parameters within 1e-6 — except
where the reference's clipped gradient is below 1e3 * eps: there Adam's
first step, g / (|g| + eps), is no longer sign(g), and the two packages'
steps may differ by up to 2 * lr.  Those elements are counted and must
stay under 0.1 % of their leaf (the key bias: 10 %, ``KEY_BIAS_SHARE``).

In bf16 (the models' dtype) the step mirrors
``tests/test_models_smoke.py::test_one_train_step`` (finite loss,
``grad_norm > 0``, parameters moved) with the loss within 0.02 relative
of the reference's.  Microbatches with int8 compression, and the three
remat policies (bit-equal on the CPU), run on a few configs.

The four slowest families (``HEAVY``: MLA + MoE, SSD, RG-LRU, the
encoder-decoder) take the same two cases in
``tests/test_torch_train_step_families.py``, which imports this module's
helpers, so that the load is spread over two files.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, init_opt_state  # noqa: E402,E501
from repro_torch.training.train_step import TrainConfig, train_step  # noqa: E402,E501

HEAVY = ("deepseek-v2-236b", "mamba2-1.3b", "recurrentgemma-9b",
         "seamless-m4t-large-v2")
ARCHS = [n for n in jconfigs.names() if n not in HEAVY]
B, S = 2, 33
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
EPS = 1e-8
# The key bias's gradient is zero up to rounding in its slow rotary
# channels (a softmax is invariant to a shift of its scores, and those
# channels turn the bias by almost nothing over 33 positions): about half
# of reduced Qwen2.5-3B's and Qwen2-VL's ``attn.bk`` (4 x 16) lies below
# 1e3 * eps, and 3 of its 64 elements take another first step in each
# package.  Its excepted elements are held under 10 % of the leaf.
KEY_BIAS_SHARE = 0.1
# The reference's jitted draw and step compile with LLVM's optimizations
# off: a fraction of the compile time of its default, the same XLA program
# (the step's results move by ~1e-7 relative, where LLVM's default
# contracts products into FMAs)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def batch_for(cfg):
    """``tests/test_torch_lm.py::batch_for``: tokens from key 1, labels
    the next token (-1 past the end and on two padded positions), a vision
    stub on a 2 x 4 grid ahead of the text (M-RoPE) from key 2, speech
    frames from key 3."""
    toks = jax.random.randint(jax.random.key(1), (B, S), 0, cfg.vocab_size,
                              dtype=jnp.int32)
    labels = np.array(jnp.roll(toks, -1, axis=1))
    labels[:, -1] = -1
    labels[0, 3] = labels[1, 7] = -1
    batch = {"tokens": np.array(toks), "labels": labels}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
        pos[0, :, :8] = 0
        pos[1, :, :8] = np.arange(8) // 4
        pos[2, :, :8] = np.arange(8) % 4
        batch["positions"] = pos.astype(np.int32)
        batch["vision_embeds"] = np.array(0.02 * jax.random.normal(
            jax.random.key(2), (B, 8, cfg.d_model)), np.float32)
    if cfg.enc_layers:
        batch["enc_frames"] = np.array(0.1 * jax.random.normal(
            jax.random.key(3), (B, 32, cfg.d_model)), np.float32)
    return batch


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _cast(tree, dtype):
    return jax.tree.map(lambda a: a.astype(dtype)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@functools.lru_cache(maxsize=None)
def _drawn(name):
    """The reference's parameters (numpy, each leaf in its own dtype; its
    jitted draw) and batch, drawn once per config for the module's
    tests."""
    jcfg = jreduced(jconfigs.get(name))
    params = jax.jit(JLM(jcfg).init_params,
                     compiler_options=FAST_COMPILE)(jax.random.key(0))
    return jcfg, jax.tree.map(np.asarray, params), batch_for(jcfg)


def _setup(name, f32: bool):
    """``_drawn``, with every float leaf cast to f32 with ``f32``."""
    jcfg, params, batch = _drawn(name)
    if f32:
        params = jax.tree.map(np.asarray, _cast(params, jnp.float32))
    return jcfg, params, batch


def _jbatch(batch, dtype):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
            for k, v in batch.items()}


def _tbatch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _reference_step(jcfg, params, batch, microbatch=0, compress=False):
    lm = JLM(jcfg, remat_policy="off")
    state = {"params": jax.tree.map(jnp.asarray, params)}
    state["opt"] = jopt.init_opt_state(state["params"])
    gt = None
    if compress:
        def gt(g):
            return jcomp.compress_decompress(g, jcomp.init_error_state(g))[0]
    tcfg = jts.TrainConfig(adamw=jopt.AdamWConfig(**ADAMW),
                           microbatch=microbatch)
    new, metrics = jax.jit(lambda s, b: jts.train_step(
        lm, tcfg, s, b, grad_transform=gt), compiler_options=FAST_COMPILE)(
            state, _jbatch(batch, jnp.float32))
    return jax.tree.map(np.asarray, new), {k: float(v)
                                           for k, v in metrics.items()}


def _port_step(name, params, batch, dtype, microbatch=0, compress=False,
               remat="minimal"):
    cfg = reduced(configs.get(name))
    tp = convert.lm_params(params, "cpu")
    state = {"params": tp, "opt": init_opt_state(tp)}
    gt = None
    if compress:
        def gt(g):
            return compression.compress_decompress(
                g, compression.init_error_state(g))[0]
    tcfg = TrainConfig(adamw=AdamWConfig(**ADAMW), microbatch=microbatch)
    new, metrics = train_step(LM(cfg, remat_policy=remat), tcfg, state,
                              _tbatch(batch, dtype), grad_transform=gt)
    return new, metrics


def _check_step(name, got, got_m, want, want_m, quantum_flips=False):
    """``got`` (the port's state and metrics) against ``want`` (the
    reference's) within the module's f32 bounds.  With ``quantum_flips``
    (int8 compression) a moment element may also differ by one
    quantization step (a rounding tie that falls the other way in the
    two packages); those are counted.  Returns the counts of excepted
    elements."""
    assert got_m["loss"].item() == pytest.approx(want_m["loss"], rel=1e-5)
    assert got_m["ce"].item() == pytest.approx(want_m["ce"], rel=1e-5)
    assert abs(got_m["aux"].item() - want_m["aux"]) <= 1e-5
    assert got_m["lr"].item() == want_m["lr"]
    assert got_m["grad_norm"].item() == pytest.approx(want_m["grad_norm"],
                                                      rel=1e-4)
    lr = want_m["lr"]
    counts = {}
    gp, wp = _flat(got["params"]), _flat(want["params"])
    gm, wm = _flat(got["opt"]["m"]), _flat(want["opt"]["m"])
    gv, wv = _flat(got["opt"]["v"]), _flat(want["opt"]["v"])
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    for leaf, w in wp.items():
        m_ref = _np(wm[leaf])
        top = max(float(np.abs(m_ref).max()), 1e-30)
        dm = np.abs(_np(gm[leaf]) - m_ref)
        flips = dm > 1e-4 * top
        if quantum_flips:
            # one int8 step of the leaf (its largest element is 127 steps)
            assert (dm[flips] <= 1.01 * top / 127).all(), (name, leaf)
            counts[f"{leaf} m"] = int(flips.sum())
        else:
            assert not flips.any(), (name, leaf, float(dm.max()), top)
        v_ref = _np(wv[leaf])
        dv = np.abs(_np(gv[leaf]) - v_ref)
        vtop = max(float(np.abs(v_ref).max()), 1e-30)
        # v = (1 - b2) g^2 at step 1: one int8 step of g moves it by at
        # most 0.05 * step * (2 |g| + step)
        g_top = top / 0.1
        g_step = g_top / 127
        vflip = 0.05 * g_step * (2 * g_top + g_step) * 1.01
        assert (dv <= np.where(flips, vflip, 1e-4 * vtop)).all(), (
            name, leaf, float(dv.max()), vtop)
        dp = np.abs(_np(gp[leaf]) - _np(w))
        # the reference's clipped gradient: m = (1 - b1) g at step 1
        small = np.abs(m_ref) < (1 - 0.9) * 1e3 * EPS
        off = dp > 1e-6
        allowed = small | flips
        assert (~off | allowed).all(), (name, leaf, float(dp[~allowed].max()))
        assert (dp[off] <= 2 * lr * 1.001).all(), (name, leaf)
        if off.any():
            counts[f"{leaf} p"] = int(off.sum())
            share = KEY_BIAS_SHARE if leaf.endswith("attn.bk") else 1e-3
            assert off.sum() < share * off.size or quantum_flips, (
                name, leaf, int(off.sum()), off.size)
    return counts


def f32_case(name):
    """One f32 step of ``name`` in both packages, within the module's
    bounds."""
    jcfg, params, batch = _setup(name, f32=True)
    want, want_m = _reference_step(jcfg, params, batch)
    got, got_m = _port_step(name, params, batch, torch.float32)
    _check_step(name, got, got_m, want, want_m)


def bf16_case(name):
    """The models' dtype: the reference smoke test's checks, and the loss
    within 0.02 relative of the reference's bf16 loss."""
    jcfg, params, batch = _setup(name, f32=False)
    want = float(jax.jit(JLM(jcfg, remat_policy="off").loss,
                         compiler_options=FAST_COMPILE)(
        jax.tree.map(jnp.asarray, params), _jbatch(batch, jnp.bfloat16))[0])
    before = convert.lm_params(params, "cpu")
    new, metrics = _port_step(name, params, batch, torch.bfloat16)
    loss = metrics["loss"].item()
    assert np.isfinite(loss)
    assert metrics["grad_norm"].item() > 0
    assert loss == pytest.approx(want, rel=0.02)
    moved = [not torch.equal(a, b) for a, b in
             zip(_flat(before).values(), _flat(new["params"]).values())]
    assert any(moved)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_f32_matches_reference(name):
    f32_case(name)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_bf16(name):
    bf16_case(name)


def test_train_config_has_no_compression_switch():
    """Compression is a ``grad_transform``: a ``TrainConfig`` that asked
    for it, and would silently step on uncompressed gradients, cannot be
    made."""
    with pytest.raises(TypeError):
        TrainConfig(compress_grads=True)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mixtral-8x7b",
                                  "qwen2-vl-72b"])
def test_microbatch_and_compression_match_reference(name):
    """B 2 in microbatches of 1 (M-RoPE positions (3, B, S) sliced on axis
    1), then the int8 error-feedback round trip: the reference's metrics
    quirk (``ce`` the mean total loss, ``aux`` 0), and the step within the
    f32 bounds but for moment elements one int8 step apart."""
    jcfg, params, batch = _setup(name, f32=True)
    want, want_m = _reference_step(jcfg, params, batch, microbatch=1,
                                   compress=True)
    got, got_m = _port_step(name, params, batch, torch.float32,
                            microbatch=1, compress=True)
    assert want_m["aux"] == 0.0 and got_m["aux"].item() == 0.0
    assert got_m["ce"].item() == got_m["loss"].item()
    counts = _check_step(name, got, got_m, want, want_m, quantum_flips=True)
    total = sum(np.asarray(v).size for v in _flat(want["params"]).values())
    assert sum(counts.values()) < 1e-3 * total, counts


@pytest.mark.parametrize("name", ["qwen2.5-3b", "mixtral-8x7b"])
def test_remat_policies_give_the_same_step(name):
    """minimal, dots and off: the same state and metrics, bit for bit on
    the CPU (bf16, the models' dtype; Mixtral with its MoE aux loss)."""
    _, params, batch = _setup(name, f32=False)
    runs = [_port_step(name, params, batch, torch.bfloat16, remat=policy)
            for policy in ("minimal", "dots", "off")]
    (s0, m0), rest = runs[0], runs[1:]
    for s, m in rest:
        for k in m0:
            assert torch.equal(m[k], m0[k]), k
        for (ka, a), (kb, b) in zip(_flat(s0["params"]).items(),
                                    _flat(s["params"]).items()):
            assert ka == kb and torch.equal(a, b), ka
        for part in ("m", "v"):
            for k, a in _flat(s0["opt"][part]).items():
                assert torch.equal(a, _flat(s["opt"][part])[k]), k
