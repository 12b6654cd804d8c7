"""The port's AdamW (``repro_torch.training.optimizer``) and int8 gradient
compression (``repro_torch.training.compression``) against the
reference's on the same arrays, within one unit in the last place of the
leaf's dtype or 1e-6 relative; the reference tests' properties
(``tests/test_training.py::TestOptimizer``, ``TestCompression``) on the
port; and the reference's weight decay of stacked vectors (ROADMAP C0h),
pinned in both packages."""
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
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            apply_updates, global_norm,
                                            init_opt_state, schedule)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _within_ulp(got, want, dtype_name: str) -> None:
    """Every element within one unit in the last place of ``dtype_name``
    (f32 or bf16) of ``want``, or within 1e-6 relative."""
    g, w = _np(got), _np(want)
    bits = 7 if dtype_name == "bfloat16" else 23
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - bits)
    d = np.abs(g - w)
    ok = (d <= ulp) | (d <= 1e-6 * np.abs(w))
    assert ok.all(), (dtype_name, float(d.max()), int((~ok).sum()))


def _tree(seed: int, scale: float = 1.0) -> dict:
    """f32 and bf16 leaves, 1-d and stacked, as numpy (bf16 in
    ml_dtypes)."""
    rng = np.random.default_rng(seed)

    def r(*shape, dtype=np.float32):
        return (scale * rng.standard_normal(shape)).astype(dtype)

    bf16 = jnp.bfloat16
    return {"norm": r(64),
            "blocks": {"ln1": r(4, 64), "w": r(4, 64, 32, dtype=bf16),
                       "bq": r(4, 4, 16, dtype=bf16)},
            "table": r(256, 64, dtype=bf16)}


def _grid_grads(seed: int) -> dict:
    """Gradients on a grid of 1/16 in [-2, 2]: their squares and every
    partial sum of them are exact in f32, so both packages' global norm,
    and with it the clipping scale, are the same number."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.integers(-32, 33, a.shape) / 16).astype(a.dtype),
        _tree(0))


def _pair(tree):
    """(reference tree of jnp arrays, port tree of CPU tensors)."""
    return (jax.tree.map(jnp.asarray, tree),
            convert.lm_params(tree, "cpu"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 5, 10, 50, 100])
def test_schedule_matches_reference(step):
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    _within_ulp(schedule(cfg, torch.tensor(step, dtype=torch.int32)),
                jopt.schedule(jcfg, jnp.asarray(step, jnp.int32)), "float32")


def test_global_norm_matches_reference():
    """f32 sums of ~24k squares round differently in each package (XLA's
    reduction order depends on the leaf's shape), so both are held to the
    exact (f64) norm: the port within 1e-6 relative of it, and within the
    reference's own error of the reference."""
    tree = _tree(0)
    jt, tt = _pair(tree)
    exact = np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                        for x in jax.tree.leaves(tree)))
    got, want = float(global_norm(tt)), float(jopt.global_norm(jt))
    assert abs(got - exact) <= 1e-6 * exact, (got, exact)
    assert abs(got - want) <= abs(want - exact) + 1e-6 * exact


@pytest.mark.parametrize("clip", [1.0, 1e6])
def test_apply_updates_matches_reference(clip):
    """Two steps from a state with nonzero moments: clipped (the global
    norm is ~187) and unclipped.  The gradients lie on a grid whose global
    norm is exact in f32 (``_grid_grads``), so every difference left is
    the elementwise arithmetic's."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    cfg, jcfg = AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    params = _tree(1)
    jp, tp = _pair(params)
    m = jax.tree.map(lambda a: np.asarray(a, np.float32), _tree(2, 0.1))
    v = jax.tree.map(lambda a: np.abs(np.asarray(a, np.float32)),
                     _tree(3, 0.1))
    jstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v),
              "step": jnp.asarray(3, jnp.int32)}
    tstate = {"m": convert.lm_params(m, "cpu"),
              "v": convert.lm_params(v, "cpu"),
              "step": torch.tensor(3, dtype=torch.int32)}
    for seed in (4, 5):
        jg, tg = _pair(_grid_grads(seed))
        jp, jstate, jmet = jopt.apply_updates(jcfg, jp, jstate, jg)
        tp, tstate, tmet = apply_updates(cfg, tp, tstate, tg)
        assert int(tstate["step"]) == int(jstate["step"])
        _within_ulp(tmet["lr"], jmet["lr"], "float32")
        _within_ulp(tmet["grad_norm"], jmet["grad_norm"], "float32")
        for name, want in _flat(jp).items():
            _within_ulp(_flat(tp)[name], want, want.dtype.name)
        for part in ("m", "v"):
            for name, want in _flat(jstate[part]).items():
                _within_ulp(_flat(tstate[part])[name], want, "float32")


def test_apply_updates_is_in_place():
    """The returned tensors are the ones passed in (the docstring's
    contract: callers that need old values copy them first)."""
    _, tp = _pair(_tree(0))
    st = init_opt_state(tp)
    w = tp["blocks"]["w"]
    before = w.clone()
    out, st2, _ = apply_updates(AdamWConfig(warmup_steps=0), tp, st,
                                _pair(_tree(1))[1])
    assert out["blocks"]["w"] is w and st2["m"] is st["m"]
    assert not torch.equal(w, before)


def test_compress_decompress_matches_reference():
    jg, tg = _pair(_tree(6))
    jerr = jcomp.init_error_state(jg)
    terr = compression.init_error_state(tg)
    for _ in range(3):  # the error feedback carries across calls
        jg2, jerr = jcomp.compress_decompress(jg, jerr)
        tg2, terr = compression.compress_decompress(tg, terr)
        for name, want in _flat(jg2).items():
            got = _flat(tg2)[name]
            assert got.dtype == convert.tensor(np.asarray(want), "cpu").dtype
            _within_ulp(got, want, want.dtype.name)
        for name, want in _flat(jerr).items():
            _within_ulp(_flat(terr)[name], want, "float32")


# --------------------------------------------------------------------------
# the reference tests' properties, on the port
# --------------------------------------------------------------------------

def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(schedule(cfg, torch.tensor(s))) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 5e-4) < 1e-8
    assert abs(lrs[2] - 1e-3) < 1e-8
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - cfg.lr * cfg.min_lr_ratio) < 1e-8


def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = apply_updates(cfg, params, opt, grads)
    assert float(params["w"].abs().max()) < 0.3


def test_grad_clip():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.ones(4)}
    opt = init_opt_state(params)
    _, _, metrics = apply_updates(cfg, params, opt,
                                  {"w": torch.full((4,), 100.0)})
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_roundtrip_bounded_error():
    g = {"w": torch.randn(128, generator=torch.Generator().manual_seed(0))}
    err = compression.init_error_state(g)
    out, err = compression.compress_decompress(g, err)
    scale = float(g["w"].abs().max()) / 127
    assert float((out["w"] - g["w"]).abs().max()) <= scale * 0.51


def test_error_feedback_accumulates():
    """Constant gradients: the error-feedback mean converges to the true
    gradient (no bias)."""
    g = {"w": torch.full((16,), 0.01) + torch.arange(16) * 1e-4}
    err = compression.init_error_state(g)
    total = torch.zeros(16)
    n = 50
    for _ in range(n):
        out, err = compression.compress_decompress(g, err)
        total = total + out["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=1e-5)


# --------------------------------------------------------------------------
# C0h: the decay rule p.ndim >= 2 meets the stacked layer axis
# --------------------------------------------------------------------------

def test_stacked_vectors_are_decayed_in_both_packages():
    """Reduced Qwen2.5-3B keeps each layer's norm scale and query bias
    stacked on the layer axis, (4, 64) and (4, 4, 16), so both packages'
    ``p.ndim >= 2`` rule decays them, while the unstacked ``final_norm``
    (64,) is not decayed.  A step with zero gradients moves exactly the
    decayed leaves, by lr * weight_decay * p."""
    jcfg = jreduced(jconfigs.get("qwen2.5-3b"))
    shapes = jax.eval_shape(JLM(jcfg).init_params, jax.random.key(0))
    meta = LM(reduced(configs.get("qwen2.5-3b"))).init_params(device="meta")
    sub = shapes["blocks"]["sub0"]
    assert sub["ln1"].shape == tuple(meta["blocks"]["sub0"]["ln1"].shape) \
        == (4, 64)
    assert sub["attn"]["bq"].shape == tuple(
        meta["blocks"]["sub0"]["attn"]["bq"].shape) == (4, 4, 16)
    rng = np.random.default_rng(7)
    params = {"blocks": {"sub0": {
        "ln1": rng.standard_normal(sub["ln1"].shape).astype(np.float32),
        "attn": {"bq": rng.standard_normal(sub["attn"]["bq"].shape).astype(
            jnp.bfloat16)}}},
        "final_norm": rng.standard_normal(
            shapes["final_norm"].shape).astype(np.float32)}
    kw = dict(lr=0.1, warmup_steps=0, weight_decay=0.1)
    jp, tp = _pair(params)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), params)
    jg, tg = _pair(zeros)
    jnew, _, _ = jopt.apply_updates(jopt.AdamWConfig(**kw), jp,
                                    jopt.init_opt_state(jp), jg)
    tnew, _, _ = apply_updates(AdamWConfig(**kw), tp, init_opt_state(tp), tg)
    for new in (jnew, tnew):
        flat = {k: _np(v) for k, v in _flat(new).items()}
        np.testing.assert_array_equal(flat["final_norm"],
                                      params["final_norm"])
        for name in ("blocks.sub0.ln1", "blocks.sub0.attn.bq"):
            old = _np(np.asarray(_flat(params)[name]))
            # lr is 0.1 at step 1 (to 1e-8), so decay scales p by 0.99;
            # bf16 rounds the result to within 2e-3 of that
            np.testing.assert_allclose(flat[name], old * 0.99, rtol=4e-3,
                                       err_msg=name)
    for name, want in _flat(jnew).items():
        _within_ulp(_flat(tnew)[name], want, want.dtype.name)
