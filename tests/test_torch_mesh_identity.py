"""A one-rank mesh computes what one device computes, bit for bit.

On a (1, 1) ("data", "model") mesh every placement is ``Replicate``: no
collective reorders a sum, so each DTensor branch of the model stack must
give exactly what its plain branch gives.  Equality at world size 1 is the
check that sees a branch whose shard-local product rounds apart from the
plain one (an ``einsum`` where the plain path multiplies by ``@``, or
three operands contracted pairwise where the plain path makes one
``torch.einsum``) without any tolerance; the four-rank tests
(``tests/test_torch_distributed.py``) hold the sharded layouts with the
reference's loose bounds, which such a fault stays under.

One rank is spawned for the module (``ranks`` below) and joins a gloo
group of one over a ``FileStore`` in the test's temporary directory, with
a hard timeout and a collective timeout, as the four-rank tests do.  It
runs every case twice from the same seeded parameters and batch, once on
plain tensors and once with the state, parameters and batch laid out on
``launch.mesh.make_host_mesh(model=1, data=1)`` by
``distributed.sharding.Rules`` / ``distribute`` and the model's ``shard``
hook set to ``rules.act_shard()``, and writes both; the tests compare
them with ``torch.equal``.  Both sides run in the one process, on one
thread, so they meet the same CPU kernels.

The families are the reduced configs of one architecture each: dense GQA
attention (Qwen2.5-3B), MoE (Mixtral-8x7B), MLA with MoE (DeepSeek-V2),
SSD (Mamba-2), RG-LRU (RecurrentGemma, 5 layers, whose residual stays
finite: ROADMAP C0g), M-RoPE (Qwen2-VL) and the encoder-decoder
(SeamlessM4T), at S = 64 (a shorter sequence can hide a product that
rounds apart in the loss and the grad norm).  For each: ``forward_train``
logits; one ``train_step`` with AdamW (loss, grad norm, every gradient
leaf, every updated parameter and moment); ``prefill`` (logits and every
cache leaf) and two ``decode_step`` calls (logits and the cache); the same
two decodes with ``decode_carry_cache`` and ``assume_uniform_decode``
(logits and the cache carried in place); the step over microbatches of
one row (the global rows) and the step with int8 error-feedback
compression (``compress_decompress``: the gradients it passes on and its
error state too).  MoE routing needs no pin here: the router's inputs are
equal bit for bit on both sides, or the logits compared before it already
differ.  ``launch.train(run, mesh)`` runs against ``launch.train(run)``
for 2 steps, with and without ``compress_grads`` (losses, grad norms and
the final state).  ``vocab_parallel`` is off throughout: its one-hot
embedding product rounds the table's gradient apart by design, and the
four-rank tests hold it with their bounds.  The C7 case alone:
``attn_out_heads`` on bf16 (2, 64, 16, 128) x (16, 128, 2048).

A three-operand ``common.einsum`` of DTensors runs as one
``torch.einsum`` of each rank's shards, the plain path's contraction,
where the layouts allow.  Four ranks on a (2, 2) mesh (``sharded``)
hold it on sharded layouts, which a one-rank mesh cannot show: the SSD
and MoE contractions as ``Rules`` lays them out, a contracted index
sharded by every operand (a partial sum), and two indices sharded on one
mesh dim (pair by pair), each against ``torch.einsum`` of the whole
tensors, result and gradients within f32 rounding.
"""
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

RANK_TIMEOUT = 300      # seconds for the whole rank program
COLLECTIVE_TIMEOUT = 120
B, S, CACHE_LEN = 2, 64, 72
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ARCHS = ("qwen2.5-3b", "mixtral-8x7b", "deepseek-v2-236b", "mamba2-1.3b",
         "recurrentgemma-9b", "qwen2-vl-72b", "seamless-m4t-large-v2")
LAUNCH_ARCH = "qwen2.5-3b"
LAUNCH = dict(arch=LAUNCH_ARCH, steps=2, seq_len=S, global_batch=B,
              log_every=0, device="cpu")
# the C7 shapes: o (B, S, H, E) against wo (H, E, D), bf16
C7_O, C7_WO = (2, 64, 16, 128), (16, 128, 2048)


# --------------------------------------------------------------------------
# the rank program (forked from a fork server; imports no jax)
# --------------------------------------------------------------------------

def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _fulls(tree) -> dict:
    from repro_torch.training.tree import items
    return {k: _full(v).detach().clone() for k, v in items(tree)}


def batch_for(cfg, seed: int) -> dict:
    """Tokens and next-token labels (-1 at the end and on two padded
    positions) drawn with numpy; a vision stub on a 2 x 4 grid ahead of
    the text (M-RoPE); speech frames (encoder-decoder)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = labels[1, 7] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).copy()
        pos[0, :, :8] = 0
        pos[1, :, :8] = np.arange(8) // 4
        pos[2, :, :8] = np.arange(8) % 4
        batch["positions"] = pos.astype(np.int32)
        batch["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, 8, cfg.d_model))).astype(np.float32)
    if cfg.enc_layers:
        batch["enc_frames"] = (0.1 * rng.standard_normal(
            (B, 32, cfg.d_model))).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class Side:
    """One side of the comparison: plain tensors (``mesh`` None) or the
    (1, 1) mesh, with ``Rules``' layouts and shard hook."""

    def __init__(self, cfg, mesh):
        from repro_torch.distributed.sharding import Rules
        from repro_torch.models.lm import _identity
        self.mesh = mesh
        self.rules = None if mesh is None else Rules(cfg, mesh)
        self.shard = _identity if mesh is None else self.rules.act_shard()

    def state(self, params0):
        from repro_torch.distributed.sharding import distribute
        from repro_torch.training.optimizer import init_opt_state
        from repro_torch.training.tree import tree_map
        params = tree_map(torch.clone, params0)
        state = {"params": params, "opt": init_opt_state(params)}
        if self.mesh is None:
            return state
        return distribute(state, self.rules.state_spec(state), self.mesh)

    def params(self, params0):
        from repro_torch.distributed.sharding import distribute
        from repro_torch.training.tree import tree_map
        params = tree_map(torch.clone, params0)
        if self.mesh is None:
            return params
        return distribute(params, self.rules.param_specs(params), self.mesh)

    def batch(self, batch):
        from repro_torch.distributed.sharding import distribute
        if self.mesh is None:
            return batch
        return distribute(batch, self.rules.batch_spec(batch), self.mesh)


def _step(lm, side, params0, batch, microbatch=0, compress=False) -> dict:
    """One AdamW ``train_step``: loss, grad norm, the gradients AdamW was
    given, the new state; with ``compress``, through int8 error-feedback
    compression (and its new error state)."""
    from repro_torch.training import compression
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import TrainConfig, train_step

    state = side.state(params0)
    err = compression.init_error_state(state["params"])
    held = {}

    def grab(grads):
        if compress:
            grads, held["err"] = compression.compress_decompress(grads, err)
        held["grads"] = _fulls(grads)
        return grads

    new, metrics = train_step(
        lm, TrainConfig(adamw=AdamWConfig(**ADAMW), microbatch=microbatch),
        state, side.batch(batch), shard=side.shard, grad_transform=grab)
    out = {"loss": _full(metrics["loss"]), "grad_norm":
           _full(metrics["grad_norm"])}
    out |= {f"grad/{k}": v for k, v in held["grads"].items()}
    out |= {f"state/{k}": v for k, v in _fulls(new).items()}
    if compress:
        out |= {f"err/{k}": v for k, v in _fulls(held["err"]).items()}
    return out


def _decode(cfg, side, params0, batch) -> tuple[dict, dict]:
    """``prefill`` then two ``decode_step`` calls, and the same two decodes
    with ``decode_carry_cache`` and ``assume_uniform_decode`` (every
    request at one position) from the prefill's cache."""
    from repro_torch.models.lm import LM

    params = side.params(params0)
    pbatch = side.batch({k: v for k, v in batch.items() if k != "labels"})
    pos = torch.full((B,), S, dtype=torch.int32)
    with torch.no_grad():
        logits, cache = LM(cfg).prefill(params, pbatch, cache_len=CACHE_LEN,
                                        shard=side.shard)
        out = {"prefill": _full(logits)}
        out |= {f"prefill_cache/{k}": v for k, v in _fulls(cache).items()}
        tokens = [torch.argmax(logits, -1).to(torch.int32)]
        new = cache
        for i in range(2):
            dec, new = LM(cfg).decode_step(params, new, tokens[i], pos + i,
                                           shard=side.shard)
            out[f"decode{i}"] = _full(dec)
            tokens.append(torch.argmax(dec, -1).to(torch.int32))
        out |= {f"cache/{k}": v for k, v in _fulls(new).items()}
        carried = {}
        lm = LM(cfg, decode_carry_cache=True, assume_uniform_decode=True)
        for i in range(2):
            dec, cache = lm.decode_step(params, cache, tokens[i], pos + i,
                                        shard=side.shard)
            carried[f"decode{i}"] = _full(dec)
        carried |= {f"cache/{k}": v for k, v in _fulls(cache).items()}
    return out, carried


def _family(arch: str, seed: int, mesh) -> dict:
    """Every case of one reduced config on both sides: {case: (plain,
    mesh)}, each side a dict of tensors."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.lm import LM

    cfg = reduced(configs.get(arch))
    lm = LM(cfg)
    params0 = lm.init_params(torch.Generator().manual_seed(seed),
                             device="cpu")
    batch = batch_for(cfg, seed)
    cases = {}
    for m in (None, mesh):
        side = Side(cfg, m)
        got = {}
        with torch.no_grad():
            logits, aux = lm.forward_train(side.params(params0),
                                           side.batch(batch), side.shard)
        got["forward"] = {"logits": _full(logits), "aux": _full(aux)}
        got["train_step"] = _step(lm, side, params0, batch)
        got["decode"], got["carried_decode"] = _decode(cfg, side, params0,
                                                      batch)
        got["microbatch"] = _step(lm, side, params0, batch, microbatch=1)
        got["compress"] = _step(lm, side, params0, batch, compress=True)
        for case, v in got.items():
            cases.setdefault(case, []).append(v)
    return cases


def _launch(mesh) -> dict:
    """``launch.train`` for 2 steps without and with ``compress_grads``,
    each without a mesh and on ``mesh``."""
    from repro_torch.launch.train import RunConfig, train

    out = {}
    for label, kw in (("default", {}), ("compress_grads",
                                        dict(compress_grads=True))):
        pair = []
        for m in (None, mesh):
            run = train(RunConfig(**LAUNCH, **kw), mesh=m)
            pair.append(dict(
                losses=torch.tensor(run["losses"], dtype=torch.float64),
                grad_norms=torch.tensor(run["grad_norms"],
                                        dtype=torch.float64),
                **{f"state/{k}": v for k, v in _fulls(run["state"]).items()}))
        out[label] = pair
    return out


def _c7(mesh) -> tuple:
    """``attn_out_heads`` of bf16 DTensors on ``mesh`` and of the same
    plain tensors."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models import common as cm
    gen = torch.Generator().manual_seed(7)
    o = torch.randn(C7_O, generator=gen).to(torch.bfloat16)
    wo = (torch.randn(C7_WO, generator=gen) * 0.02).to(torch.bfloat16)
    rep = [Replicate()] * mesh.ndim
    got = cm.attn_out_heads({"wo": distribute_tensor(wo, mesh, rep)},
                            distribute_tensor(o, mesh, rep))
    return cm.attn_out_heads({"wo": wo}, o), _full(got)


def _rank_checks() -> dict:
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=1, data=1)
    out = {"c7": _c7(mesh), "seconds": {}}
    for i, arch in enumerate(ARCHS):
        t0 = time.perf_counter()
        out[arch] = _family(arch, i, mesh)
        out["seconds"][arch] = time.perf_counter() - t0
    out["launch"] = _launch(mesh)
    return out


# three-operand contractions of the model stack on a (2, 2) mesh, each
# operand's spec over ("data", "model"): (equation, shapes, specs)
EINSUMS = {
    # the SSD chunk state: batch over "data", heads over "model"; B lacks
    # the heads (a Partial gradient on "model")
    "ssd_states": ("bkn,bkh,bkhp->bhnp", ((4, 8, 6), (4, 8, 4), (4, 8, 4, 5)),
                   (("data",), ("data", None, "model"),
                    ("data", None, "model", None))),
    # the SSD carried state's output
    "ssd_y_off": ("bqn,bhnp,bqh->bqhp", ((4, 8, 6), (4, 4, 6, 5), (4, 8, 4)),
                  (("data",), ("data", "model"), ("data", None, "model"))),
    # the MoE combine: groups over "data"
    "moe_combine": ("gtkx,gtkc,gtk->gtxc", ((4, 6, 2, 4), (4, 6, 2, 8),
                                           (4, 6, 2)),
                    (("data",), ("data",), ("data",))),
    # a contracted index sharded by all three: a partial sum on "model"
    "partial": ("bkn,bkh,bkhp->bhnp", ((4, 8, 6), (4, 8, 4), (4, 8, 4, 5)),
                (("data", "model"), ("data", "model"),
                 ("data", "model"))),
    # two indices sharded on "model": not local, pair by pair
    "pairwise": ("bkn,bkh,bkhp->bhnp", ((4, 8, 6), (4, 8, 4), (4, 8, 4, 5)),
                 (("data", None, "model"), ("data", None, "model"),
                  ("data",))),
}


def _einsum_checks() -> dict:
    """Each of ``EINSUMS`` through ``common.einsum`` on DTensors laid out
    by its specs: the result and each operand's gradient (of the result
    against a fixed weight) gathered whole, and the result's
    placements."""
    from repro_torch.distributed.sharding import P, distribute
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common as cm

    mesh = make_host_mesh(model=2, data=2)
    out = {}
    for name, (eq, shapes, specs) in EINSUMS.items():
        ops, weight = _einsum_inputs(shapes, eq)
        dops = [distribute(o, P(*sp), mesh).requires_grad_(True)
                for o, sp in zip(ops, specs)]
        res = cm.einsum(eq, *dops)
        (res.full_tensor() * weight).sum().backward()
        out[name] = dict(result=res.full_tensor().detach(),
                         placements=tuple(res.placements),
                         grads=[d.grad.full_tensor() for d in dops])
    return out


def _einsum_inputs(shapes, eq):
    """Seeded f32 operands of ``shapes`` and a weight of ``eq``'s output
    shape."""
    gen = torch.Generator().manual_seed(len(eq))
    ops = [torch.randn(sh, generator=gen) for sh in shapes]
    sizes = {}
    for t, sh in zip(eq.split("->")[0].split(","), shapes):
        sizes |= dict(zip(t, sh))
    weight = torch.randn([sizes[i] for i in eq.split("->")[1]],
                         generator=gen)
    return ops, weight


PROGRAMS = {"one": _rank_checks, "sharded": _einsum_checks}


def rank_main(rank: int, world: int, program: str, work: str) -> None:
    """One rank: join the group over the work directory's FileStore, run
    ``program`` and (rank 0) write its results; a failure leaves its
    traceback in ``rank<i>.err``."""
    import traceback
    import warnings
    from datetime import timedelta

    import torch.distributed as dist

    warnings.simplefilter("ignore")
    torch.set_num_threads(1)
    work = Path(work)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(work / "store"), world),
            rank=rank, world_size=world,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            out = PROGRAMS[program]()
            if rank == 0:
                torch.save(out, work / "rank.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


# --------------------------------------------------------------------------
# the parent: the spawn and the comparisons
# --------------------------------------------------------------------------

# what the ranks import, loaded once by the fork server they are forked
# from
PRELOAD = ["torch", "torch.distributed.tensor", "repro_torch.launch.train",
           "test_torch_mesh_identity"]


def _spawn(work: Path, world: int, program: str):
    """Run ``program`` on ``world`` ranks, each joined within RANK_TIMEOUT
    and killed past it, and return rank 0's results."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, program, str(work)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (work / f"rank{r}.err").read_text()[-4000:]
              for r in range(world) if (work / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} did not finish in {RANK_TIMEOUT} s; " \
        f"errors: {errors}"
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    assert not bad, (bad, errors)
    import torch.distributed.tensor  # noqa: F401 (loads placements)
    return torch.load(work / "rank.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one rank's results (``_rank_checks``)."""
    return _spawn(tmp_path_factory.mktemp("mesh1"), 1, "one")


def assert_same(plain: dict, meshed: dict) -> None:
    """Every key of both sides equal bit for bit (``torch.equal``)."""
    assert sorted(plain) == sorted(meshed)
    differ = {k: float((plain[k].double() - meshed[k].double()).abs().max())
              for k in plain if not torch.equal(plain[k], meshed[k])}
    assert not differ, differ


def test_attn_out_heads_bit_equal_on_a_one_rank_mesh(ranks):
    """C7: ``attn_out_heads`` of DTensors computes its shards' product as
    the plain path does (``(b, s, h*e) @ (h*e, d)``), not as an
    ``einsum``, which rounds apart from it in bf16 at these shapes."""
    plain, meshed = ranks["c7"]
    assert plain.dtype == meshed.dtype == torch.bfloat16
    assert plain.shape == meshed.shape == (C7_O[0], C7_O[1], C7_WO[2])
    assert torch.equal(plain, meshed), float(
        (plain.float() - meshed.float()).abs().max())


CASES = ("forward", "train_step", "decode", "carried_decode", "microbatch",
         "compress")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_bit_equal(ranks, arch, case):
    """``case`` of reduced ``arch`` on the (1, 1) mesh equals the same on
    plain tensors, every tensor bit for bit; the values are finite."""
    plain, meshed = ranks[arch][case]
    assert_same(plain, meshed)
    for k, v in plain.items():
        if v.is_floating_point():
            assert bool(torch.isfinite(v).all()), (arch, case, k)


def test_cases_cover_every_leaf(ranks):
    """The step cases hold every gradient leaf, parameter and moment, and
    the decode cases every cache leaf, of each config."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.lm import LM
    from repro_torch.training.tree import items

    for arch in ARCHS:
        lm = LM(reduced(configs.get(arch)))
        names = [k for k, _ in items(lm.init_params(device="meta"))]
        step = ranks[arch]["train_step"][0]
        for k in names:
            for key in (f"grad/{k}", f"state/params/{k}", f"state/opt/m/{k}",
                        f"state/opt/v/{k}"):
                assert key in step, (arch, key)
        cache = lm.init_cache(B, CACHE_LEN, enc_len=32, device="meta")
        leaves = [k for k, _ in items(cache)]
        dec = ranks[arch]["decode"][0]
        carried = ranks[arch]["carried_decode"][0]
        for k in leaves:
            assert f"prefill_cache/{k}" in dec and f"cache/{k}" in dec, k
            assert f"cache/{k}" in carried, (arch, k)


@pytest.mark.parametrize("option", ["default", "compress_grads"])
def test_launch_train_on_a_one_rank_mesh_bit_equal(ranks, option):
    """``launch.train(run, mesh)`` for 2 steps equals ``launch.train(run)``:
    every loss, grad norm and final parameter and moment."""
    plain, meshed = ranks["launch"][option]
    assert len(plain["losses"]) == LAUNCH["steps"]
    assert_same(plain, meshed)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Four ranks' ``common.einsum`` results (``_einsum_checks``)."""
    return _spawn(tmp_path_factory.mktemp("mesh4"), 4, "sharded")


@pytest.mark.parametrize("name", list(EINSUMS))
def test_three_operand_einsum_on_a_sharded_mesh(sharded, name):
    """``common.einsum`` of three DTensors on a (2, 2) mesh, shard by
    shard where their layouts allow (every rank's product one
    ``torch.einsum`` of its shards) and pair by pair where not, against
    ``torch.einsum`` of the whole tensors: the result and every operand's
    gradient within f32 rounding (the shards' products and the partial
    sums over "model" order their sums otherwise)."""
    from torch.distributed.tensor import Replicate, Shard

    eq, shapes, _ = EINSUMS[name]
    ops, weight = _einsum_inputs(shapes, eq)
    ops = [o.requires_grad_(True) for o in ops]
    want = torch.einsum(eq, *ops)
    (want * weight).sum().backward()
    got = sharded[name]
    torch.testing.assert_close(got["result"], want.detach(), rtol=1e-5,
                               atol=1e-5)
    for g, o in zip(got["grads"], ops):
        torch.testing.assert_close(g, o.grad, rtol=1e-5, atol=1e-5)
    # the output index each mesh dim shards where the product was local
    local = {"ssd_states": "bh", "ssd_y_off": "bh", "moe_combine": "g.",
             "partial": "b."}
    if name in local:
        out = eq.split("->")[1]
        assert got["placements"] == tuple(
            Replicate() if c == "." else Shard(out.index(c))
            for c in local[name])
