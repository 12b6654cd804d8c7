"""The port's prefill + decode against its own full forward: the cache,
ring and rotary invariant of ``tests/test_decode_consistency.py``, per
config, on the reference test's own data (parameters from key 0 carried
across by ``convert.lm_params``, tokens from key 1), with its bounds:
relative error < 0.06 for one decode step after a 32-token prefill, and
< 0.08 for the windowed configs decoding 16 tokens past a 16-token window
(the ring wraps).  MoE configs raise the capacity factor to 8.0 so that no
token is dropped, as there: expert-capacity drops legitimately depend on
the batch's composition."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

B, S = 2, 33  # prefill 32 + 1 decode


def _nodrop(cfg):
    if cfg.moe is not None:
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@functools.cache
def _jparams(arch):
    """The reference's parameters from key 0 (drawn eagerly once an arch:
    its jitted draw rounds otherwise)."""
    return JLM(jreduced(jconfigs.get(arch)), remat_policy="off").init_params(
        jax.random.key(0))


@functools.cache
def _params(arch):
    return convert.lm_params(jax.tree.map(np.asarray, _jparams(arch)), "cpu")


def _model(arch):
    """The port's model on the reduced config and the reference's
    parameters from key 0 (drawn once an arch; no test writes them)."""
    return LM(_nodrop(reduced(configs.get(arch)))), _params(arch)


def _t(a):
    return convert.tensor(a, "cpu")


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-6)


@pytest.mark.parametrize("arch", jconfigs.names())
def test_prefill_decode_matches_forward(arch):
    lm, params = _model(arch)
    cfg = lm.cfg
    toks = _t(jax.random.randint(jax.random.key(1), (B, S), 0,
                                 cfg.vocab_size, dtype=jnp.int32))
    full, pre = {"tokens": toks}, {"tokens": toks[:, :-1]}
    if cfg.family == "vlm":
        pos = torch.arange(S, dtype=torch.int32)[None, None].expand(3, B, S)
        full["positions"], pre["positions"] = pos, pos[:, :, :-1]
        ve = _t(0.02 * jax.random.normal(jax.random.key(2), (B, 8,
                                                             cfg.d_model)
                                         ).astype(jnp.bfloat16))
        full["vision_embeds"] = pre["vision_embeds"] = ve
    if cfg.enc_layers:
        fr = _t(0.1 * jax.random.normal(jax.random.key(3), (B, 32,
                                                            cfg.d_model)
                                        ).astype(jnp.bfloat16))
        full["enc_frames"] = pre["enc_frames"] = fr
    want = lm.forward_train(params, full)[0][:, -1]
    _, cache = lm.prefill(params, pre, cache_len=40)
    got, new_cache = lm.decode_step(params, cache, toks[:, -1],
                                    torch.full((B,), S - 1,
                                               dtype=torch.int32))
    assert _rel(got, want) < 0.06
    # the step returns a new cache and leaves the prefill cache as it was
    again, _ = lm.decode_step(params, cache, toks[:, -1],
                              torch.full((B,), S - 1, dtype=torch.int32))
    assert torch.equal(got, again)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b"])
def test_ring_buffer_window_decode(arch):
    """Windowed configs: decoding far past the window with a ring cache
    agrees with the full forward (the ring is the window)."""
    lm, params = _model(arch)
    total = 48  # the window is 16, so the ring wraps 3 times
    toks = _t(jax.random.randint(jax.random.key(4), (B, total), 0,
                                 lm.cfg.vocab_size, dtype=jnp.int32))
    want = lm.forward_train(params, {"tokens": toks})[0][:, -1]
    _, cache = lm.prefill(params, {"tokens": toks[:, :32]}, cache_len=40)
    for i in range(32, total):
        got, cache = lm.decode_step(params, cache, toks[:, i],
                                    torch.full((B,), i, dtype=torch.int32))
    assert _rel(got, want) < 0.08


@pytest.mark.parametrize("layers,finite", [(8, True), (38, False)])
def test_recurrent_residual_overflows_as_in_the_reference(layers, finite):
    """The reference's recurrent blocks add the RG-LRU output to the
    residual stream without their ``ln1`` pre-norm, so the stream grows
    block by block: at RecurrentGemma-9B's full depth of 38 layers its bf16
    logits are not finite, even at reduced width (ROADMAP C0g), and before
    that its own bf16 rounding grows with depth (0.11 from its f32 logits
    at 8 layers, 2.5 at 10).  The port keeps the reference's math: not
    finite where the reference is not, and where it is finite, equal to
    it in f32 within 2e-3."""
    cfgs = [dataclasses.replace(c, num_layers=layers) for c in (
        jreduced(jconfigs.get("recurrentgemma-9b")),
        reduced(configs.get("recurrentgemma-9b")))]
    jlm = JLM(cfgs[0], remat_policy="off")
    jp = jlm.init_params(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (B, S), 0,
                              cfgs[0].vocab_size, dtype=jnp.int32)
    for dtype in (jnp.bfloat16, jnp.float32):
        jpd = jax.tree.map(lambda a: a.astype(dtype)
                           if a.dtype == jnp.bfloat16 else a, jp)
        want = np.asarray(jlm.forward_train(jpd, {"tokens": toks})[0],
                          np.float32)
        got = LM(cfgs[1]).forward_train(
            convert.lm_params(jax.tree.map(np.asarray, jpd), "cpu"),
            {"tokens": _t(toks)})[0].float().numpy()
        if dtype == jnp.bfloat16:
            assert bool(np.isfinite(want).all()) == finite
            assert bool(np.isfinite(got).all()) == finite
        elif finite:
            assert float(np.abs(got - want).max()) < 2e-3


# --------------------------------------------------------------------------
# the decode cache carried in place, the uniform slot write
# --------------------------------------------------------------------------

F32_TOL = 2e-3
# the reference's decodes and prefill below are jitted without XLA's
# backend optimizations: a third of their eager time, the same math
FAST = {"xla_backend_optimization_level": 0}
FLAGS = [dict(decode_carry_cache=True), dict(assume_uniform_decode=True),
         dict(decode_carry_cache=True, assume_uniform_decode=True)]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


@functools.cache
def _f32_setup(arch):
    """Reduced ``arch`` in f32 on both sides: the reference's prefill of 32
    tokens (its cache, carried across, is every decode's start), the
    decode token, and the port's parameters and decode without flags."""
    jcfg = _nodrop(jreduced(jconfigs.get(arch)))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), _jparams(arch))
    toks = jax.random.randint(jax.random.key(1), (B, S), 0, jcfg.vocab_size,
                              dtype=jnp.int32)
    pre = {"tokens": toks[:, :-1]}
    if jcfg.enc_layers:
        pre["enc_frames"] = 0.1 * jax.random.normal(jax.random.key(3),
                                                    (B, 32, jcfg.d_model))
    _, jcache = jax.jit(lambda p, b: JLM(jcfg, remat_policy="off").prefill(
        p, b, cache_len=40), compiler_options=FAST)(jp, pre)
    lm = LM(_nodrop(reduced(configs.get(arch))))
    params = convert.lm_params(jax.tree.map(np.asarray, jp), "cpu")
    cache = jax.tree.map(np.asarray, jcache)
    want, want_cache = lm.decode_step(params, _torch_tree(cache),
                                      _t(toks[:, -1]), _positions())
    return jcfg, jp, cache, toks[:, -1], params, want, want_cache


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _positions():
    return torch.full((B,), S - 1, dtype=torch.int32)


@pytest.mark.parametrize("flags", FLAGS,
                         ids=["carry", "uniform", "carry+uniform"])
@pytest.mark.parametrize("arch", jconfigs.names())
def test_decode_flags_match_reference(arch, flags):
    """``decode_step`` with ``decode_carry_cache`` and/or
    ``assume_uniform_decode`` on every reduced config (all have a decode
    cache), in f32 from the reference's prefill cache: logits and every
    new cache leaf within 2e-3 of the reference's ``LM`` with the same
    flags; bit for bit the port's decode without them; and the caller's
    cache written in place and returned (the same tensors) when carried,
    left as it was when not."""
    jcfg, jp, cache, tok, params, want, want_cache = _f32_setup(arch)
    jlogits, jnew = jax.jit(JLM(jcfg, remat_policy="off", **flags).decode_step,
                            compiler_options=FAST)(
        jp, jax.tree.map(jnp.asarray, cache), tok,
        jnp.full((B,), S - 1, jnp.int32))
    mine = _torch_tree(cache)
    ptrs = {k: v.data_ptr() for k, v in _leaves(mine).items()}
    got, new = LM(_nodrop(reduced(configs.get(arch))), **flags).decode_step(
        params, mine, _t(tok), _positions())
    assert float((got - _t(jlogits)).abs().max()) < F32_TOL
    assert torch.equal(got, want)
    jnew, new, want_cache = (_leaves(t) for t in (
        jax.tree.map(np.asarray, jnew), new, want_cache))
    assert sorted(new) == sorted(jnew) == sorted(want_cache)
    for k, v in new.items():
        assert float((v.float() - _t(jnew[k]).float()).abs().max()) \
            < F32_TOL, k
        assert torch.equal(v, want_cache[k]), k
        carried = flags.get("decode_carry_cache", False)
        assert (v.data_ptr() == ptrs[k]) == carried, k
        assert torch.equal(_leaves(mine)[k],
                           v if carried else _t(_leaves(cache)[k])), k
