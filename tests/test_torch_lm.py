"""The port's LM stack (``repro_torch.models.lm``) against the reference's
(``repro.models.lm``) on all ten reduced configs: ``forward_train``
logits, ``loss`` (``ce``, ``aux``), ``prefill`` (last logits and every
cache leaf) and ``decode_step`` logits, from the same parameters (the
reference's, carried across by ``convert.lm_params``) and the same inputs.

Each config runs twice:

* In f32 (both packages' parameters cast to f32), where the two compute
  the same math up to f32 rounding: logits and cache leaves within 2e-3,
  ``ce`` within 1e-5 relative, ``aux`` within 1e-5 (equal routing gives
  equal dispatch fractions).
* In bf16, the models' own dtype: logits within 0.08 (the serving
  tolerance), ``ce`` within 0.02 relative, cache leaves within 0.02 + 0.02
  relative, ``aux`` within 1e-5.  Two bf16 computations that round at
  other places can lie further apart than that: Mamba-2's gated SSD moves
  the reference's own logits by ~0.15 from its f32 ones, RecurrentGemma's
  by ~0.07, and an MoE token whose top-k routing is a near tie takes
  another expert in each package.  Past the bound, the port's bf16 result
  is held to the reference's f32 result within twice the reference's own
  bf16 error there: the port rounds no worse than the reference.
  ``_held`` returns which check decided.
"""
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

ARCHS = jconfigs.names()
B, S = 2, 33           # the reference's decode test: prefill 32 + 1 decode
CACHE_LEN = 40
LOGIT_TOL = 0.08       # tests/test_torch_serving.py
F32_TOL = 2e-3


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def _close(a, b, atol, rtol) -> bool:
    return bool(np.allclose(_np(a), _np(b), atol=atol, rtol=rtol))


def _held(got, want, want32, atol, rtol=0.0) -> str:
    """bf16 ``got`` against the reference's bf16 ``want`` within ``atol``
    + ``rtol`` relative; past that, against the reference's f32 ``want32``
    within twice the reference's own largest bf16 error."""
    if _close(got, want, atol, rtol):
        return "bound"
    own = _err(want, want32)
    assert _err(got, want32) <= 2 * own, (_err(got, want), own,
                                          _err(got, want32))
    return "reference's rounding"


def batch_for(cfg, s=S):
    """The reference decode test's inputs (tokens from key 1, vision stub
    from key 2, frames from key 3), with labels (the next token, -1 past
    the end and on two padded positions) and, for M-RoPE, vision tokens
    on a 2 x 4 grid (t = 0, h, w) ahead of the text."""
    toks = jax.random.randint(jax.random.key(1), (B, s), 0, cfg.vocab_size,
                              dtype=jnp.int32)
    labels = np.array(jnp.roll(toks, -1, axis=1))
    labels[:, -1] = -1
    labels[0, 3] = labels[1, 7] = -1
    batch = {"tokens": np.array(toks), "labels": labels}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(s)[None, None], (3, B, s)).copy()
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


def _prefix(batch, n):
    return {k: (v[..., :n] if k in ("tokens", "labels", "positions") else v)
            for k, v in batch.items()}


def _run_reference(jcfg, jp, batch, dtype):
    lm = JLM(jcfg, remat_policy="off")
    jb = {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
          for k, v in batch.items()}
    logits, aux = lm.forward_train(jp, jb)
    _, parts = lm.loss(jp, jb)
    pre = _prefix(jb, S - 1)
    last, cache = lm.prefill(jp, pre, cache_len=CACHE_LEN)
    dec, _ = lm.decode_step(jp, cache, jb["tokens"][:, -1],
                            jnp.full((B,), S - 1, jnp.int32))
    return dict(logits=logits, aux=aux, ce=parts["ce"], loss_aux=parts["aux"],
                last=last, cache=jax.tree.map(np.asarray, cache), dec=dec)


def _run_port(tcfg, tp, batch, dtype):
    lm = LM(tcfg)
    tb = {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in batch.items()}
    logits, aux = lm.forward_train(tp, tb)
    _, parts = lm.loss(tp, tb)
    last, cache = lm.prefill(tp, _prefix(tb, S - 1), cache_len=CACHE_LEN)
    dec, _ = lm.decode_step(tp, cache, tb["tokens"][:, -1],
                            torch.full((B,), S - 1, dtype=torch.int32))
    return dict(logits=logits, aux=aux, ce=parts["ce"], loss_aux=parts["aux"],
                last=last, cache=cache, dec=dec)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """arch -> both packages' results in bf16 and in f32, from the
    reference's parameters (key 0) and the parameters themselves."""
    name = request.param
    jcfg = jreduced(jconfigs.get(name))
    tcfg = reduced(configs.get(name))
    # jitted: one compilation in place of the eager vmap's many
    jp = jax.jit(JLM(jcfg, remat_policy="off").init_params)(
        jax.random.key(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = batch_for(jcfg)
    out = {"name": name, "params": jp}
    for tag, params, dtype in (("16", jp, jnp.bfloat16),
                               ("32", jp32, jnp.float32)):
        tp = convert.lm_params(jax.tree.map(np.asarray, params), "cpu")
        out["ref" + tag] = _run_reference(jcfg, params, batch, dtype)
        out["port" + tag] = _run_port(
            tcfg, tp, batch,
            torch.bfloat16 if tag == "16" else torch.float32)
    return out


def test_forward_logits_match_reference(runs):
    r16, r32, p16, p32 = (runs[k] for k in ("ref16", "ref32", "port16",
                                            "port32"))
    assert tuple(p16["logits"].shape) == r16["logits"].shape
    assert p16["logits"].dtype == torch.bfloat16
    assert _err(p32["logits"], r32["logits"]) < F32_TOL
    _held(p16["logits"], r16["logits"], r32["logits"], LOGIT_TOL)


def test_loss_matches_reference(runs):
    r16, r32, p16, p32 = (runs[k] for k in ("ref16", "ref32", "port16",
                                            "port32"))
    for p, r in ((p32, r32), (p16, r16)):
        tol = 1e-5 if p is p32 else 0.02
        ce_p, ce_r = float(p["ce"]), float(r["ce"])
        assert abs(ce_p - ce_r) <= tol * abs(ce_r), (ce_p, ce_r)
    assert abs(float(p32["loss_aux"]) - float(r32["loss_aux"])) < 1e-5
    assert abs(float(p32["aux"]) - float(r32["aux"])) < 1e-5
    # bf16: the same routing gives the same aux; a near tie routed apart
    # moves it, no further from the f32 aux than the reference's own
    err = abs(float(p16["aux"]) - float(r16["aux"]))
    own = abs(float(r16["aux"]) - float(r32["aux"]))
    assert err < 1e-5 or abs(float(p16["aux"]) - float(r32["aux"])) \
        <= 2 * own, (err, own)
    if configs.get(runs["name"]).moe is None:
        assert float(p16["aux"]) == float(p32["aux"]) == 0.0


def test_loss_gold_pick_is_the_gather_bit_for_bit(runs):
    """The loss keeps its gold pick (B, S, 1) wide, so that vocab-sharded
    DTensor logits reduce over the shape the gather made; on plain tensors
    it gives the ``gather(...)[..., 0]`` loss bit for bit.  The
    vocab-parallel pick (one-hot embedding, shard-local gold) gives the
    same cross entropy."""
    tcfg = reduced(configs.get(runs["name"]))
    batch = batch_for(jreduced(jconfigs.get(runs["name"])))
    labels = torch.from_numpy(batch["labels"])
    mask = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    for tag in ("16", "32"):
        p = runs["port" + tag]
        logits = p["logits"].float()
        gold = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = torch.where(mask, torch.logsumexp(logits, dim=-1) - gold, 0.0)
        ce = nll.sum() / torch.clamp(mask.sum(), min=1)
        assert torch.equal(ce, p["ce"]), (tag, ce, p["ce"])
    tp = convert.lm_params(jax.tree.map(np.asarray, runs["params"]), "cpu")
    tb = {k: torch.from_numpy(v).to(torch.bfloat16) if v.dtype == np.float32
          else torch.from_numpy(v) for k, v in batch.items()}
    _, parts = LM(tcfg, vocab_parallel=True).loss(tp, tb)
    assert float(parts["ce"]) == pytest.approx(float(runs["port16"]["ce"]),
                                               rel=1e-6)


def test_prefill_logits_and_cache_match_reference(runs):
    r16, r32, p16, p32 = (runs[k] for k in ("ref16", "ref32", "port16",
                                            "port32"))
    assert _err(p32["last"], r32["last"]) < F32_TOL
    _held(p16["last"], r16["last"], r32["last"], LOGIT_TOL)
    want32 = _leaves(r32["cache"])
    for tag in ("16", "32"):
        got, want = _leaves(runs["port" + tag]["cache"]), \
            _leaves(runs["ref" + tag]["cache"])
        assert sorted(got) == sorted(want)
        for k in want:
            g, w = got[k], want[k]
            assert tuple(g.shape) == w.shape, k
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
            if tag == "32":
                np.testing.assert_allclose(_np(g), _np(w), atol=F32_TOL,
                                           rtol=F32_TOL, err_msg=k)
            else:
                _held(g, w, want32[k], 0.02, 0.02)


def test_decode_step_matches_reference(runs):
    r16, r32, p16, p32 = (runs[k] for k in ("ref16", "ref32", "port16",
                                            "port32"))
    assert tuple(p16["dec"].shape) == r16["dec"].shape
    assert _err(p32["dec"], r32["dec"]) < F32_TOL
    _held(p16["dec"], r16["dec"], r32["dec"], LOGIT_TOL)


def test_params_convert_leaf_for_leaf(runs):
    """Every leaf of the reference's tree (the f32 router, the SSD and
    RG-LRU parameters, the MLA latents, the encoder stack) converts with
    its key, shape, dtype and bits, and the port draws the same layout."""
    name, jp = runs["name"], runs["params"]
    tp = _leaves(convert.lm_params(jax.tree.map(np.asarray, jp), "cpu"))
    want = _leaves(jax.tree.map(np.asarray, jp))
    own = _leaves(LM(reduced(configs.get(name))).init_params(
        torch.Generator().manual_seed(0)))
    assert sorted(tp) == sorted(want) == sorted(own)
    for k, w in want.items():
        for t in (tp[k], own[k]):
            assert tuple(t.shape) == w.shape, k
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype), k
        bits = np.uint16 if w.dtype.name == "bfloat16" else w.dtype
        got = tp[k].view(torch.uint16) if tp[k].dtype == torch.bfloat16 \
            else tp[k]
        assert np.array_equal(got.numpy().view(bits), w.view(bits)), k


def test_init_cache_matches_reference_struct(runs):
    name = runs["name"]
    jcfg = jreduced(jconfigs.get(name))
    want = _leaves(jax.tree.map(
        lambda s: (s.shape, str(s.dtype)),
        JLM(jcfg).cache_struct(B, CACHE_LEN, enc_len=32)))
    got = _leaves(LM(reduced(configs.get(name))).init_cache(
        B, CACHE_LEN, enc_len=32, device="meta"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == want
    zero = _leaves(LM(reduced(configs.get(name))).init_cache(
        B, CACHE_LEN, enc_len=32, device="cpu"))
    assert all(not bool(v.any()) for v in zero.values())
    # the prefill cache has the same tree as the zero cache
    assert sorted(_leaves(runs["port16"]["cache"])) == sorted(zero)
