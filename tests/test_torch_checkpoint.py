"""The port's checkpoints (``repro_torch.training.checkpoint``) in the
reference's layout on disk: ``latest_step`` as the reference test finds
it, a reference checkpoint restored into the port and a port checkpoint
restored into the reference bit for bit (bf16 parameters, f32 moments,
the int32 step), and a non-blocking save that writes the values of the
moment it was called though the state is updated in place right after."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.reduced import reduced as jreduced  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            apply_updates)
from repro_torch.training.train_step import init_train_state  # noqa: E402
from repro_torch.training.tree import items, tree_map  # noqa: E402

ARCH = "qwen2.5-3b"


def _bits(x) -> np.ndarray:
    """The leaf's bits: bf16 as uint16, anything else as it is."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _same_bits(port_tree, ref_tree) -> int:
    """Asserts every leaf equal bit for bit, with its dtype and shape;
    returns the number of leaves."""
    ref = {"/".join(str(p.key) for p in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    port = dict(items(port_tree))
    assert sorted(port) == sorted(ref)
    for k, leaf in port.items():
        a, b = _bits(leaf), _bits(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    return len(port)


def _reference_state():
    """A reduced Qwen2.5-3B train state of the reference with bf16
    parameters, nonzero moments and step 7."""
    lm = JLM(jreduced(jconfigs.get(ARCH)))
    # jitted, with LLVM's optimizations off: a fraction of the eager
    # draw's compile time
    state = jax.jit(lambda k: jts.init_train_state(lm, k), compiler_options={
        "xla_backend_optimization_level": 0})(jax.random.key(0))
    rng = np.random.default_rng(1)
    state["opt"]["m"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        state["opt"]["m"])
    state["opt"]["v"] = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(size=a.shape), jnp.float32),
        state["opt"]["v"])
    state["opt"]["step"] = jnp.asarray(7, jnp.int32)
    return lm, state


def _port_state():
    lm = LM(reduced(configs.get(ARCH)))
    state = init_train_state(lm, torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    for _, m in items(state["opt"]["m"]):
        m.copy_(torch.randn(m.shape, generator=gen))
    for _, v in items(state["opt"]["v"]):
        v.copy_(torch.rand(v.shape, generator=gen))
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    return lm, state


def test_latest_step_discovery(tmp_path):
    d = str(tmp_path / "c")
    assert ckpt.latest_step(d) is None
    tree = {"x": torch.arange(4, dtype=torch.int32)}
    ckpt.save(d, 5, tree)
    ckpt.save(d, 10, tree)
    assert ckpt.latest_step(d) == 10
    back = ckpt.restore(d, 10, {"x": torch.empty(4, dtype=torch.int32,
                                                 device="meta")}, "cpu")
    np.testing.assert_array_equal(back["x"].numpy(), np.arange(4))
    # an unfinished save (a temporary directory) is not a checkpoint
    (tmp_path / "c" / "step_00000015.tmp0").mkdir()
    assert ckpt.latest_step(d) == 10


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    _, state = _reference_state()
    jckpt.save(str(tmp_path), 7, state)
    lm = LM(reduced(configs.get(ARCH)))
    template = init_train_state(lm, device="meta")
    back = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)),
                        template, "cpu")
    assert back["params"]["embed"]["table"].dtype == torch.bfloat16
    assert _same_bits(back, state) > 20


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    _, state = _port_state()
    ckpt.save(str(tmp_path), 7, state)
    jlm = JLM(jreduced(jconfigs.get(ARCH)))
    template = jax.eval_shape(lambda: jts.init_train_state(
        jlm, jax.random.key(0)))
    back = jckpt.restore(str(tmp_path), jckpt.latest_step(str(tmp_path)),
                         template)
    assert back["params"]["embed"]["table"].dtype == jnp.bfloat16
    assert _same_bits(state, back) > 20


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.empty(4, device="meta")},
                     "cpu")


def test_nonblocking_save_keeps_the_values_it_was_given(tmp_path):
    """The optimizer updates the state in place right after a
    non-blocking save; the checkpoint still holds the values of the call."""
    lm, state = _port_state()
    before = {k: v.clone() for k, v in items(state)}
    th = ckpt.save(str(tmp_path), 7, state, blocking=False)
    apply_updates(AdamWConfig(warmup_steps=0), state["params"], state["opt"],
                  tree_map(torch.ones_like, state["params"]))
    th.join(timeout=60)
    assert not th.is_alive()
    moved = [k for k, v in items(state["params"])
             if not torch.equal(v, before[f"params/{k}"])]
    assert moved
    back = ckpt.restore(str(tmp_path), 7, init_train_state(lm, device="meta"),
                        "cpu")
    for k, v in items(back):
        np.testing.assert_array_equal(_bits(v), _bits(before[k]), err_msg=k)

