"""The port's sharding rules (``repro_torch.distributed.sharding``) and
shape-only inputs (``repro_torch.launch.inputs``) against the reference's.

``Rules`` reads nothing of a mesh but its axis sizes, so both packages'
rules run here on stand-in meshes (an object whose ``shape`` is
``{axis: size}``) at the production sizes — (16, 16) and (2, 16, 16) —
and at the test sizes (2, 2) and (2, 4), for all ten configs at full
width: the port's trees from ``init_params`` / ``init_train_state`` /
``init_cache`` on ``device="meta"``, the reference's from
``jax.eval_shape`` / ``cache_struct``.  No device is touched.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.training.train_step import init_train_state as jinit_state  # noqa: E402,E501
from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import inputs as tinputs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.training.train_step import init_train_state  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "2x4": {"data": 2, "model": 4}}
FLAGS = [dict(), dict(fsdp=False), dict(seq_sharded_cache=False),
         dict(head_sharded_cache=True)]
# decode caches at the shapes the dry-run lowers (a sharded batch, and the
# batch-1 long context whose sequence spreads over the whole mesh)
CACHES = ((128, 32_768), (1, 524_288))


def stand_in(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


def flat(tree, prefix="") -> dict:
    """``{path: leaf}`` of nested dicts (specs and shapes are leaves)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def specs(tree) -> dict:
    return {k: tuple(v) for k, v in flat(tree).items()}


@functools.lru_cache(maxsize=None)
def reference_trees(name: str):
    lm = JLM(jconfigs.get(name))
    state = jax.eval_shape(lambda: jinit_state(lm, jax.random.key(0)))
    caches = [lm.cache_struct(b, s, enc_len=s if lm.cfg.enc_layers else 0)
              for b, s in CACHES]
    batch = jinputs.train_batch_struct(lm.cfg, JSHAPES["train_4k"])
    return lm.cfg, state, caches, batch


@functools.lru_cache(maxsize=None)
def port_trees(name: str):
    lm = LM(configs.get(name))
    state = init_train_state(lm, device="meta")
    caches = [lm.init_cache(b, s, enc_len=s if lm.cfg.enc_layers else 0,
                            device="meta") for b, s in CACHES]
    batch = tinputs.train_batch_struct(lm.cfg, SHAPES["train_4k"])
    return lm.cfg, state, caches, batch


def even(spec_tree, tree, mesh) -> list:
    """Leaves whose spec would shard a dim unevenly (the guards' promise:
    none)."""
    bad = []
    for k, sp in flat(spec_tree).items():
        shape = flat(tree)[k].shape
        for d, part in enumerate(sp):
            if shape[d] % tsh.axis_size(mesh, part):
                bad.append((k, tuple(shape), tuple(sp)))
    return bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", configs.names())
def test_rules_match_reference_at_full_width(name, mesh):
    jcfg, jstate, jcaches, jbatch = reference_trees(name)
    tcfg, tstate, tcaches, tbatch = port_trees(name)
    m = stand_in(MESHES[mesh])
    for flags in FLAGS:
        want = jsh.Rules(jcfg, m, **flags)
        got = tsh.Rules(tcfg, m, **flags)
        got_state = got.state_spec(tstate)
        assert specs(got.param_specs(tstate["params"])) == \
            specs(want.param_specs(jstate["params"])), flags
        assert specs(got_state) == specs(want.state_spec(jstate)), flags
        assert specs(got.batch_spec(tbatch)) == \
            specs(want.batch_spec(jbatch)), flags
        assert not even(got_state, tstate, m), flags
        for jc, tc in zip(jcaches, tcaches):
            got_cache = got.cache_spec(tc)
            assert specs(got_cache) == specs(want.cache_spec(jc)), flags
            assert not even(got_cache, tc, m), flags


# (name, shape, rule flags): every activation layout of the reference's
# ``act_shard``, divisible and not, and names it leaves alone
ACT_CASES = [
    ("act", (32, 4096, 2048), {}),
    ("act", (1, 4096, 2048), {}),
    ("act", (32, 4096, 2048), dict(sp_activations=True)),
    ("act", (32, 4095, 2048), dict(sp_activations=True)),
    ("act", (32, 2048), {}),
    ("mla_latent", (32, 128, 576), {}),
    ("mla_latent", (3, 128, 576), {}),
    ("q_heads", (32, 128, 16, 8, 128), {}),
    ("q_heads", (32, 128, 16, 8, 128), dict(pin_attn_heads=True)),
    ("q_heads", (32, 128, 12, 8, 128), dict(pin_attn_heads=True)),
    ("kv_heads", (32, 128, 16, 128), dict(pin_attn_heads=True)),
    ("kv_heads", (32, 128, 16, 128), {}),
    ("logits", (32, 128, 151936), {}),
    ("logits", (32, 128, 257), {}),
    ("logits", (32, 151936), {}),
    ("kv_compact", (32, 128, 8, 128), {}),
    ("kv_compact", (32, 128, 32, 128), {}),
    ("cache_kv", (32, 128, 8, 128), {}),
    ("bogus", (32, 128, 2048), {}),
]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_act_spec_matches_reference_act_shard(mesh, monkeypatch):
    """The port's ``act_spec`` is the layout the reference's ``act_shard``
    pins (None where it returns its input unchanged)."""
    pinned = object()
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: (pinned, s))
    monkeypatch.setattr(jsh.Rules, "named", lambda self, spec: spec)
    m = stand_in(MESHES[mesh])
    cfg = jconfigs.get("qwen2.5-3b")
    for name, shape, flags in ACT_CASES:
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        out = jsh.Rules(cfg, m, **flags).act_shard()(x, name)
        want = tuple(out[1]) if isinstance(out, tuple) else None
        got = tsh.Rules(configs.get("qwen2.5-3b"), m,
                        **flags).act_spec(shape, name)
        assert (None if got is None else tuple(got)) == want, \
            (name, shape, flags)


def test_placements_and_even_shards():
    from torch.distributed.tensor import Replicate, Shard

    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                              shape=(2, 2, 2))
    P = tsh.P
    # a dim over a tuple of axes shards on each of them, in mesh order
    assert tsh.placements(P(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(P(None, ("data", "model")), m) == \
        (Replicate(), Shard(1), Shard(1))
    assert tsh.placements(P(), m) == (Replicate(),) * 3
    assert tsh.axis_size(m, ("pod", "data", "model")) == 8
    assert tsh.mesh_shape(m) == {"pod": 2, "data": 2, "model": 2}
    assert tsh.dp_axes(m) == ("pod", "data")
    # an uneven shard is refused before anything is placed
    with pytest.raises(AssertionError, match="does not divide"):
        tsh.distribute({"w": torch.zeros(3, 4)}, {"w": P("data", None)}, m)


def test_act_shard_leaves_plain_tensors_alone():
    rules = tsh.Rules(configs.get("qwen2.5-3b"), stand_in(MESHES["2x2"]))
    x = torch.zeros(4, 8, 16)
    assert rules.act_shard()(x, "act") is x


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(v) for v in tree)
    dtype = str(tree.dtype)
    return tuple(tree.shape), dtype.replace("torch.", "")


@pytest.mark.parametrize("name", configs.names())
def test_input_specs_match_reference(name):
    """``launch.inputs`` gives the reference's shapes and dtypes for every
    cell, on ``meta`` (no allocation)."""
    jlm, tlm = JLM(jconfigs.get(name)), LM(configs.get(name))
    assert tinputs.VLM_PATCH_TOKENS == jinputs.VLM_PATCH_TOKENS
    for key, shape in SHAPES.items():
        got = tinputs.input_specs(tlm, shape)
        want = jinputs.input_specs(jlm, JSHAPES[key])
        assert _shapes(got) == _shapes(want), key
        assert all(t.device.type == "meta"
                   for t in flat_leaves(got)), key
    assert tinputs.sds((2, 3)).dtype == torch.int32
    assert np.dtype(jinputs.sds((2, 3)).dtype) == np.int32


def flat_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flat_leaves(v)]
    return [tree]
