"""Parked-KV serving in the port against the reference: the page pool
bit-exact against ``repro.serving.pool`` on seeded operation sequences;
the engine against ``repro.serving.engine.ServeEngine`` on reduced
configs (Mixtral's MoE among them) from converted parameters (logits within the reference's engine
tolerance of 0.08 under teacher forcing, pool counters, pages,
generations, drops and header accounting identical); the launch entry
point on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import pool as JP  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.core import counters as C  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import pool as TP  # noqa: E402

LOGIT_TOL = 0.08  # the reference's own engine tolerance (test_serving.py)


# --------------------------------------------------------------------------
# pool
# --------------------------------------------------------------------------

def _same_state(t, j):
    for name in ("tbl_idx", "clk", "meta_exp", "meta_clk", "counters"):
        assert np.array_equal(getattr(t, name).numpy(),
                              np.asarray(getattr(j, name))), name


# the reference's functions, compiled once per configuration and shape
_jalloc = jax.jit(JP.alloc, static_argnums=0)
_jrelease = jax.jit(JP.release, static_argnums=(0, 4))


def _run_ops(cfg_kw, seed, n_ops=40):
    """A seeded sequence of alloc (batches of 1, 3 or 8 requests with some
    not wanting), validate and release (normal or explicit, of held or
    already-evicted pages) through both pools, compared after each op."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = JP.PoolConfig(**cfg_kw), TP.PoolConfig(**cfg_kw)
    js, ts = JP.init_pool(jcfg), TP.init_pool(tcfg, "cpu")
    held = []
    for _ in range(n_ops):
        op = rng.choice(["alloc", "alloc", "release", "validate"])
        if op == "alloc" or not held:
            want = rng.random(int(rng.choice([1, 3, 8]))) < 0.8
            js, jpg, jgn, jok = _jalloc(jcfg, js, jnp.asarray(want))
            ts, tpg, tgn, tok = TP.alloc(tcfg, ts, torch.from_numpy(want))
            for a, b in ((tpg, jpg), (tgn, jgn), (tok, jok)):
                assert np.array_equal(a.numpy(), np.asarray(b))
            held += [(int(p), int(g)) for p, g, k in
                     zip(np.asarray(jpg), np.asarray(jgn), np.asarray(jok))
                     if k]
        else:
            k = int(rng.integers(1, min(4, len(held)) + 1))
            pick = [held.pop(int(rng.integers(len(held)))) for _ in range(k)]
            pages = np.array([p for p, _ in pick] + [-1, -1], np.int32)
            gens = np.array([g for _, g in pick] + [0, 0], np.int32)
            if op == "validate":
                held += pick
                assert bool(TP.validate(ts, torch.from_numpy(pages),
                                        torch.from_numpy(gens))) == \
                    bool(JP.validate(js, jnp.asarray(pages),
                                     jnp.asarray(gens)))
            else:
                explicit = bool(rng.random() < 0.5)
                js = _jrelease(jcfg, js, jnp.asarray(pages),
                               jnp.asarray(gens), explicit)
                ts = TP.release(tcfg, ts, torch.from_numpy(pages),
                                torch.from_numpy(gens), explicit=explicit)
        _same_state(ts, js)
        assert int(TP.occupancy(ts)) == int(JP.occupancy(js))
    return ts


# each sequence also shows the pathology it is named for: counter names
# that must end above zero (clk_wrap: more splits than max_clk)
@pytest.mark.parametrize("cfg_kw,seed,shows", [
    (dict(num_pages=16, max_exp=2), 0, ("evictions", "premature_evictions")),
    (dict(num_pages=8, max_exp=1), 1, ("evictions", "explicit_drops")),
    (dict(num_pages=6, max_exp=50), 2, ("skip_occupied", "merges")),
    (dict(num_pages=8, max_exp=2, max_clk=5), 3, ("splits",)),
    (dict(num_pages=32, max_exp=3, max_clk=7), 4, ("splits", "merges")),
], ids=["evict", "evict_all", "full", "clk_wrap", "mixed"])
def test_pool_bitexact_on_operation_sequences(cfg_kw, seed, shows):
    d = C.as_dict(_run_ops(cfg_kw, seed).counters)
    assert all(d[name] > 0 for name in shows), d
    assert d["splits"] > cfg_kw.get("max_clk", 0) - 1


def test_pool_release_ignores_pages_past_the_table():
    """The reference's drop-mode write: a page id past the table is
    counted by its clamped generation check but frees nothing."""
    kw = dict(num_pages=4, max_exp=3)
    js = JP.init_pool(JP.PoolConfig(**kw))
    ts = TP.init_pool(TP.PoolConfig(**kw), "cpu")
    js, jpg, jgn, _ = JP.alloc(JP.PoolConfig(**kw), js, jnp.ones(4, bool))
    ts, tpg, tgn, _ = TP.alloc(TP.PoolConfig(**kw), ts, torch.ones(4).bool())
    pages = np.array([9, 1], np.int32)
    gens = np.asarray(jgn)[[3, 1]].astype(np.int32)
    js = JP.release(JP.PoolConfig(**kw), js, jnp.asarray(pages),
                    jnp.asarray(gens))
    ts = TP.release(TP.PoolConfig(**kw), ts, torch.from_numpy(pages),
                    torch.from_numpy(gens))
    _same_state(ts, js)


def test_pool_state_converts_and_resumes():
    """A reference pool state carried across by ``convert.pool_state``
    goes on exactly as the reference does."""
    kw = dict(num_pages=8, max_exp=1, max_clk=6)
    jcfg, tcfg = JP.PoolConfig(**kw), TP.PoolConfig(**kw)
    js = JP.init_pool(jcfg)
    for n in (3, 8):
        js, *_ = _jalloc(jcfg, js, jnp.ones(n, bool))
    ts = convert.pool_state(js, "cpu")
    _same_state(ts, js)
    js, jpg, _, _ = _jalloc(jcfg, js, jnp.ones(3, bool))
    ts, tpg, _, _ = TP.alloc(tcfg, ts, torch.ones(3, dtype=torch.bool))
    assert np.array_equal(tpg.numpy(), np.asarray(jpg))
    _same_state(ts, js)


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

class _RefEngine(jengine.ServeEngine):
    """The reference engine with its first-position branch broadcast over
    the query heads of a KV head.  That branch returns v_new as (1, K, 1,
    E), which only reshapes to (1, 1, K, G, E) when G == 1, so the
    reference raises at the first token of a GQA arch (ROADMAP C0d); one
    live token gives softmax weight 1, so every query head gets v_new."""

    def _paged_attention(self, li, q, k_new, v_new, pt, lengths):
        cfg = self.lm.cfg
        kh, e = cfg.num_kv_heads, cfg.head_dim
        g = cfg.num_heads // kh
        if int(lengths[0]) == 0 and g > 1:
            o = jnp.broadcast_to(v_new[:, 0][:, :, None, :], (1, kh, g, e))
            return o.reshape(1, 1, kh, g, e)
        return super()._paged_attention(li, q, k_new, v_new, pt, lengths)


def _record(eng, log, as_np):
    inner = eng._forward_token

    def forward(slot, token):
        logits, k, v = inner(slot, token)
        log.append((int(eng.rid[slot]), int(eng.pos[slot]), int(token),
                    as_np(logits)))
        return logits, k, v
    eng._forward_token = forward


def _lifecycle(je, te):
    """Each operation on both engines in turn, the port teacher-forced
    with the reference's decode inputs.  Two requests, then a third; with
    2-token pages in a 4-page pool and max_exp 1, request 2's growth
    evicts request 1's first page, whose generation check then fails (a
    premature eviction and a drop); request 3 is cancelled, request 2
    completes."""
    for eng in (je, te):
        assert eng.admit(1, [3, 1, 4])
        assert eng.admit(2, [15])
    for _ in range(3):
        te.last_tok[:] = je.last_tok
        je.step()
        te.step()
    out = []
    for eng in (je, te):
        assert eng.admit(3, [9])
        eng.finish(3, cancel=True)
        out.append(eng.finish(2))
    return out


POOL = dict(num_pages=4, page_tokens=2, max_exp=1)


@pytest.fixture(scope="module", params=["gemma-7b", "qwen2.5-3b",
                                        "qwen3-32b", "mixtral-8x7b"])
def engines(request):
    """Both engines through the lifecycle from the same parameters."""
    name = request.param
    jcfg = jreduced(jconfigs.get(name))
    jlm = JLM(jcfg, remat_policy="off")
    jparams = jlm.init_params(jax.random.key(0))
    je = _RefEngine(jlm, jparams, jengine.EngineConfig(
        max_batch=3, max_pages_per_req=8,
        pool=JP.PoolConfig(**POOL)))
    te = tengine.ServeEngine(
        LM(reduced(configs.get(name))),
        convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu"),
        tengine.EngineConfig(max_batch=3, max_pages_per_req=8,
                             pool=TP.PoolConfig(**POOL)))
    jlog, tlog = [], []
    _record(je, jlog, lambda x: np.asarray(x, np.float32))
    _record(te, tlog, lambda x: x.float().numpy())
    jout, tout = _lifecycle(je, te)
    return je, te, jlog, tlog, jout, tout


def test_engine_logits_match_reference(engines):
    je, te, jlog, tlog, _, _ = engines
    assert [s[:3] for s in tlog] == [s[:3] for s in jlog]
    err = max(float(np.abs(a[3] - b[3]).max()) for a, b in zip(jlog, tlog))
    assert err < LOGIT_TOL, err
    # greedy tokens agree wherever the reference's top-2 margin decides them
    for (_, _, _, a), (_, _, _, b) in zip(jlog, tlog):
        top = np.sort(a)[-2:]
        if top[1] - top[0] > 2 * err:
            assert np.argmax(a) == np.argmax(b)


def test_engine_pool_and_headers_match_reference(engines):
    je, te, _, _, jout, tout = engines
    assert te.stats() == je.stats()
    assert np.array_equal(te.pages, je.pages)
    assert np.array_equal(te.gens, je.gens)
    assert te.dropped == je.dropped == [1]
    assert te.header_bytes_total == je.header_bytes_total
    assert te.payload_bytes_avoided == je.payload_bytes_avoided
    d = te.stats()
    assert d["premature_evictions"] > 0 and d["explicit_drops"] > 0
    assert d["splits"] == (d["merges"] + d["explicit_drops"]
                           + d["evictions"] + d["occupancy"])
    assert d["occupancy"] == 0
    assert len(tout) == len(jout)
    assert launch_counts()["paged_attention"] == 0


def test_engine_matches_reference_full_forward():
    """As the reference's own engine test: teacher-forced engine steps
    against the reference's ``forward_train`` logits (a GQA arch, so no
    first-position shim is involved)."""
    name = "qwen2.5-3b"
    jcfg = jreduced(jconfigs.get(name))
    jlm = JLM(jcfg, remat_policy="off")
    jparams = jlm.init_params(jax.random.key(0))
    toks = [3, 1, 4, 1, 5, 9, 2]
    full, _ = jlm.forward_train(jparams,
                                {"tokens": jnp.asarray([toks], jnp.int32)})
    eng = tengine.ServeEngine(
        LM(reduced(configs.get(name))),
        convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu"),
        tengine.EngineConfig(max_batch=2, max_pages_per_req=8,
                             pool=TP.PoolConfig(num_pages=64,
                                                page_tokens=4)))
    eng.active[0] = True
    eng.rid[0] = 7
    eng.finished[7] = []
    for i, t in enumerate(toks):
        assert eng._ensure_page(0)
        lg, kn, vn = eng._forward_token(0, t)
        eng._write_kv(0, kn, vn)   # the same rows again: idempotent
        eng.pos[0] += 1
        err = float(np.abs(lg.float().numpy()
                           - np.asarray(full[0, i], np.float32)).max())
        assert err < LOGIT_TOL, (i, err)


def test_engine_rejects_later_families_and_missing_pages():
    """MLA, SSM, hybrid and encoder-decoder archs are refused, as the
    reference engine's assert refuses them (Mixtral's MoE now serves)."""
    for name in ("deepseek-v2-236b", "mamba2-1.3b", "recurrentgemma-9b",
                 "seamless-m4t-large-v2"):
        cfg = reduced(configs.get(name))
        with pytest.raises(ValueError, match="paged GQA"):
            tengine.ServeEngine(LM(cfg), {"final_norm": torch.ones(64)},
                                tengine.EngineConfig())
    cfg = reduced(configs.get("gemma-7b"))
    eng = tengine.ServeEngine(
        LM(cfg), serve_mod.init_params(cfg, "cpu"),
        tengine.EngineConfig(pool=TP.PoolConfig(num_pages=8,
                                                page_tokens=4)))
    with pytest.raises(RuntimeError, match="_ensure_page"):
        eng._forward_token(0, 1)


def test_header_and_payload_bytes_match_reference():
    pages = np.arange(256, dtype=np.int32)
    pages[200:] = -1
    th = tengine.RequestHeader(1, 5, 32768, pages, np.ones(256, np.int32))
    jh = jengine.RequestHeader(1, 5, 32768, pages, np.ones(256, np.int32))
    assert th.wire_bytes() == jh.wire_bytes()
    for name in configs.names():
        for pos in (1, 4096):
            assert tengine.parked_payload_bytes(configs.get(name), pos) == \
                jengine.parked_payload_bytes(jconfigs.get(name), pos), name


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def test_launch_serve_on_cpu(capsys):
    rep = serve_mod.main(["--device", "cpu", "--arch", "qwen2.5-3b",
                          "--requests", "3", "--prompt-len", "4",
                          "--gen-len", "3", "--max-batch", "2",
                          "--page-tokens", "2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
    assert rep.done == 3 and rep.tokens == 9
    d = rep.stats
    assert d["occupancy"] == 0 and d["splits"] == d["merges"] > 0
    assert launch_counts()["paged_attention"] == 0


def test_serve_cancels_midflight():
    cfg = reduced(configs.get("gemma-7b"))
    eng = tengine.ServeEngine(LM(cfg), serve_mod.init_params(cfg, "cpu"),
                              serve_mod.engine_config(4, 4, 2, 64, 2))
    prompts = serve_mod.make_prompts(3, 4, cfg.vocab_size)
    rep = serve_mod.serve(eng, prompts, 4, cancel={1: 2})
    assert (rep.done, rep.cancelled) == (2, 1)
    d = rep.stats
    assert d["explicit_drops"] > 0 and d["occupancy"] == 0
    assert d["splits"] == d["merges"] + d["explicit_drops"]


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.main(["--arch", "gemma-7b", "--requests", "1"])
