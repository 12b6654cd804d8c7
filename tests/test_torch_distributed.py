"""The port's model-parallel layer on a real process group: four CPU ranks
over gloo, against the port's own single-device runs and the reference's.

The reference (``tests/test_distributed.py``) runs on 8 forced host
devices.  Here every device is a process, and the suite runs with six
workers on eight cores, so the ranks are **4**: meshes (2, 2) and (4, 1)
instead of (2, 4) and (4, 2), the same code paths (batch over "data",
heads / FFN / vocab over "model", FSDP over "data").  The four ranks are
spawned once for the module (``ranks`` below), meet over a ``FileStore``
in the test's temporary directory (so concurrent workers never share a
port), run every check in one program, and rank 0 writes the results for
the tests to read.  Each rank has a hard timeout, and the process group a
collective timeout, so a hung collective fails the tests instead of
stalling the suite.  The reference side (its single-device step, prefill
and decode, ``_quant`` and ``sequential_apply``) is computed once in the
parent while the ranks run.

The sharded step also runs with microbatches (``microbatch=2``: global
rows 0-1 then 2-3, each microbatch sharded over "data") and with int8
error-feedback compression (error buffers laid out as the parameters),
each against the reference's and the port's single-device step with the
same option; ``launch.train`` runs on the mesh with and without
``compress_grads``; and a decode over a head-sharded cache carries the
cache in place (``decode_carry_cache``) at a uniform position
(``assume_uniform_decode``).

The bounds are the reference test's own: the sharded step's loss within
2e-2 and every parameter within 0.05 of the single-device step's;
prefill + decode within 0.06; the elastic checkpoint bit for bit (and
readable by the reference's ``checkpoint.restore``); ``quantized_psum``
within ``max|x| / 127 * n + 1e-5`` of the true sum (and bit-equal to the
reference's requantization done in numpy); ``pipeline_apply`` within
2e-5 of ``sequential_apply``.
"""
import os
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
RANK_TIMEOUT = 300      # seconds for the whole rank program
COLLECTIVE_TIMEOUT = 120
B, S, CACHE_LEN = 4, 32, 40
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ARCH = "minitron-8b"
CARRY_ARCH = "gemma-7b"   # reduced: 4 KV heads, a head-sharded cache
RUN = dict(arch=ARCH, steps=2, seq_len=S, global_batch=B, ckpt_every=1,
           log_every=0, device="cpu")


def _stage(w, x):
    return torch.tanh(x @ w)


# --------------------------------------------------------------------------
# the rank program (forked from a fork server; imports no jax)
# --------------------------------------------------------------------------

def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _fulls(tree) -> dict:
    from repro_torch.training.tree import items
    return {k: _full(v).detach().clone() for k, v in items(tree)}


def _rank_checks(rank: int, work: Path) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  sequential_apply)
    from repro_torch.distributed.sharding import (P, Rules, distribute,
                                                  placements)
    from repro_torch.launch.train import RunConfig, train
    from repro_torch.models.lm import LM
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import compression, optimizer
    from repro_torch.training.compression import quantized_psum
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import (TrainConfig,
                                                 _microbatches,
                                                 init_train_state,
                                                 train_step)
    from repro_torch.training.tree import items, tree_map

    # every leaf past 256 elements updates a layer slice at a time, as the
    # full-width leaves do past 2**26: the slices of each rank's shards
    optimizer.CHUNK = 256
    inp = torch.load(work / "inputs.pt")
    cfg = reduced(configs.get(ARCH))
    lm = LM(cfg)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = Rules(cfg, mesh)
    shard = rules.act_shard()

    def fresh_state():
        params = tree_map(torch.clone, inp["params"])
        return {"params": params, "opt": init_opt_state(params)}

    out = {}
    # the sharded train step
    state = fresh_state()
    specs = rules.state_spec(state)
    dstate = distribute(state, specs, mesh)
    dbatch = distribute(inp["batch"], rules.batch_spec(inp["batch"]), mesh)
    t0 = time.perf_counter()
    new, metrics = train_step(lm, TrainConfig(adamw=AdamWConfig(**ADAMW)),
                              dstate, dbatch, shard=shard)
    layouts = {k: tuple(v.placements) == placements(sp, mesh)
               for (k, v), (_, sp) in zip(items(new), items(specs))}
    out["train"] = dict(loss=_full(metrics["loss"]).item(),
                        grad_norm=_full(metrics["grad_norm"]).item(),
                        state=_fulls(new), layouts=layouts,
                        seconds=time.perf_counter() - t0)

    # microbatches of the global rows, laid out again over "data" where
    # they divide it (2 rows) and replicated where not (1 row)
    tokens = dbatch["tokens"]
    out["microbatches"] = {
        mb: [(_full(f(i)).clone(), tuple(f(i).placements))
             for i in range(B // mb)]
        for mb in (1, 2) for f in [_microbatches(tokens, 0, mb)]}

    # the int8 round trip of a (4, 64) gradient sharded over both mesh
    # dims, against the same on the whole tensor
    grad = {"w": inp["psum_x"]}
    dgrad = distribute(grad, {"w": P("data", "model")}, mesh)
    derr = distribute({"w": 0.01 * inp["psum_x"].flip(0)},
                      {"w": P("data", "model")}, mesh)
    out["compress_exact"] = dict(
        got=[_fulls(t) for t in compression.compress_decompress(dgrad,
                                                                derr)],
        placements=tuple(dgrad["w"].placements),
        zero_placements=tuple(compression.init_error_state(
            dgrad)["w"].placements))

    # the sharded step with microbatches, then with compression
    tcfg = TrainConfig(adamw=AdamWConfig(**ADAMW))
    new, metrics = train_step(
        lm, TrainConfig(adamw=AdamWConfig(**ADAMW), microbatch=2),
        distribute(fresh_state(), specs, mesh), dbatch, shard=shard)
    out["train_mb"] = dict(loss=_full(metrics["loss"]).item(),
                           state=_fulls(new))
    dstate = distribute(fresh_state(), specs, mesh)
    err = compression.init_error_state(dstate["params"])
    held = {}

    def compress(grads):
        grads, held["err"] = compression.compress_decompress(grads, err)
        return grads

    new, metrics = train_step(lm, tcfg, dstate, dbatch, shard=shard,
                              grad_transform=compress)

    def same_layout(tree):
        return {k: tuple(e.placements) == tuple(p.placements)
                for (k, e), (_, p) in zip(items(tree),
                                          items(new["params"]))}
    out["train_compress"] = dict(
        loss=_full(metrics["loss"]).item(), state=_fulls(new),
        err_layouts={**same_layout(err), **{
            f"after/{k}": v for k, v in same_layout(held["err"]).items()}})

    # prefill + decode from the initial parameters
    dparams = distribute(tree_map(torch.clone, inp["params"]),
                         rules.param_specs(inp["params"]), mesh)
    toks = dbatch["tokens"]
    logits, cache = lm.prefill(dparams, {"tokens": toks},
                               cache_len=CACHE_LEN, shard=shard)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    dec, _ = lm.decode_step(dparams, cache, nxt,
                            torch.full((B,), S, dtype=torch.int32),
                            shard=shard)
    out["decode"] = dict(prefill=_full(logits).float(),
                         decode=_full(dec).float())

    # decodes that carry the cache in place at a uniform position: over
    # Minitron's cache sharded along the ring, and over reduced Gemma-7B's
    # head-sharded cache (4 KV heads; Minitron's 1 does not divide)
    out["carried"] = {}
    for arch, params, head in ((ARCH, inp["params"], False),
                               (CARRY_ARCH, inp["gparams"], True)):
        c_cfg = reduced(configs.get(arch))
        c_rules = Rules(c_cfg, mesh, head_sharded_cache=head)
        c_shard = c_rules.act_shard()
        c_params = distribute(tree_map(torch.clone, params),
                              c_rules.param_specs(params), mesh)
        _, c_cache = LM(c_cfg).prefill(c_params, {"tokens": toks},
                                       cache_len=CACHE_LEN, shard=c_shard)
        whole = tree_map(_full, c_cache)
        c_cache = distribute(whole, c_rules.cache_spec(whole), mesh)
        before = [(v, v.to_local().data_ptr(), tuple(v.placements))
                  for _, v in items(c_cache)]
        carried, back = LM(c_cfg, decode_carry_cache=True,
                           assume_uniform_decode=True).decode_step(
            c_params, c_cache, inp["next"],
            torch.full((B,), S, dtype=torch.int32), shard=c_shard)
        axis = 3 if head else 2
        out["carried"][arch] = dict(
            decode=_full(carried).float(), cache=_fulls(c_cache),
            sharded=[k for k, v in items(c_cache)
                     if any(p.is_shard() and p.dim == axis
                            for p in v.placements)],
            same=all(v is b and v.to_local().data_ptr() == ptr
                     and tuple(v.placements) == pl
                     for (v, ptr, pl), (_, b) in zip(before, items(back))))

    # the vocab-parallel loss against the default loss, same inputs
    loss_vp, _ = LM(cfg, vocab_parallel=True).loss(dparams, dbatch, shard)
    loss_df, _ = lm.loss(dparams, dbatch, shard)
    out["vocab_parallel"] = dict(vp=_full(loss_vp).item(),
                                 default=_full(loss_df).item())

    # elastic checkpoint: saved under (2, 2), restored under (4, 1)
    state = fresh_state()
    want = _fulls(state)
    ckpt.save(str(work / "ckpt"), 1, distribute(state, specs, mesh),
              process_index=rank)
    mesh2 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    rules2 = Rules(cfg, mesh2)
    template = init_train_state(lm, device="meta")
    specs2 = rules2.state_spec(template)
    restored = ckpt.restore(str(work / "ckpt"), 1, template, "cpu",
                            mesh=mesh2, specs=specs2)
    got = _fulls(restored)
    out["ckpt"] = dict(
        keys=sorted(got) == sorted(want),
        differ=[k for k in want if not torch.equal(got[k], want[k])],
        layouts=all(tuple(v.placements) == placements(sp, mesh2)
                    for (_, v), (_, sp) in zip(items(restored),
                                               items(specs2))),
        sharded_on_4=[k for k, v in items(restored)
                      if any(p.is_shard() for p in v.placements)])

    # quantized_psum over the four ranks
    q = quantized_psum(inp["psum_x"][rank])
    every = [None] * WORLD
    dist.all_gather_object(every, q)
    out["psum"] = dict(result=q, same_on_all=all(torch.equal(q, e)
                                                  for e in every))

    # GPipe over a 4-stage "pod" axis
    mesh_p = init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "model"))
    out["pipeline"] = dict(
        got=pipeline_apply(_stage, inp["ws"], inp["xs"], mesh_p, "pod"),
        sequential=sequential_apply(_stage, inp["ws"], inp["xs"]))

    # launch.train on the (2, 2) mesh, checkpointing at steps 1 and 2
    run = train(RunConfig(ckpt_dir=str(work / "run"), **RUN), mesh=mesh)
    out["launch"] = dict(losses=run["losses"],
                         grad_norms=run["grad_norms"],
                         params=_fulls(run["state"]["params"]))
    run = train(RunConfig(compress_grads=True, **RUN), mesh=mesh)
    out["launch_compress"] = dict(losses=run["losses"],
                                  params=_fulls(run["state"]["params"]))
    return out


def rank_main(rank: int, work: str) -> None:
    """One rank: join the group over the work directory's FileStore, run
    every check, and (rank 0) write the results; a failure leaves its
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
            "gloo", store=dist.FileStore(str(work / "store"), WORLD),
            rank=rank, world_size=WORLD,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
        try:
            out = _rank_checks(rank, work)
            if rank == 0:
                torch.save(out, work / "ranks.pt")
        finally:
            dist.destroy_process_group()
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


# --------------------------------------------------------------------------
# the parent: inputs, the reference side, the spawn
# --------------------------------------------------------------------------

# what every rank imports, loaded once by the fork server the ranks are
# forked from (it holds no thread): ~3.6 s of CPU a rank otherwise
PRELOAD = ["torch", "torch.distributed.tensor", "repro_torch.launch.train",
           "repro_torch.distributed.pipeline", "test_torch_distributed"]


def _spawn(work: Path) -> list:
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    procs = [ctx.Process(target=rank_main, args=(r, str(work)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def _join(procs, work: Path) -> None:
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (work / f"rank{r}.err").read_text()[-4000:]
              for r in range(WORLD) if (work / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} did not finish in {RANK_TIMEOUT} s; " \
        f"errors: {errors}"
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    assert not bad, (bad, errors)


def _reference(inp_np: dict) -> dict:
    """The reference's single-device step, prefill + decode, the psum's
    requantization and the pipeline's sequential_apply, on the CPU."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.configs.reduced import reduced as jreduced
    from repro.distributed.pipeline import sequential_apply
    from repro.models.lm import LM as JLM
    from repro.training import compression as jcomp
    from repro.training.optimizer import AdamWConfig
    from repro.training.train_step import TrainConfig, train_step

    def compress(g):
        return jcomp.compress_decompress(g, jcomp.init_error_state(g))[0]

    fast = {"xla_backend_optimization_level": 0}
    lm = JLM(jreduced(jconfigs.get(ARCH)))
    state = inp_np["jstate"]
    batch = {k: jnp.asarray(v) for k, v in inp_np["batch"].items()}
    tcfg = TrainConfig(adamw=AdamWConfig(**ADAMW))
    new, metrics = jax.jit(lambda s, b: train_step(lm, tcfg, s, b),
                           compiler_options=fast)(state, batch)
    options = {}
    for opt, kw in (("mb", dict(tcfg=TrainConfig(
            adamw=AdamWConfig(**ADAMW), microbatch=2))),
            ("compress", dict(tcfg=tcfg, grad_transform=compress))):
        o_new, o_metrics = jax.jit(
            lambda s, b, kw=kw: train_step(lm, kw["tcfg"], s, b,
                                           grad_transform=kw.get(
                                               "grad_transform")),
            compiler_options=fast)(state, batch)
        options[opt] = dict(loss=float(o_metrics["loss"]), params={
            k: np.asarray(v, np.float32)
            for k, v in _flat(o_new["params"]).items()})
    params = state["params"]
    logits, cache = jax.jit(lambda p, t: lm.prefill(p, {"tokens": t},
                                                    cache_len=CACHE_LEN),
                            compiler_options=fast)(params, batch["tokens"])
    dec, _ = jax.jit(lm.decode_step, compiler_options=fast)(
        params, cache, jnp.argmax(logits, -1).astype(jnp.int32),
        jnp.full((B,), S, jnp.int32))
    carried = {}
    for arch, jp in ((ARCH, params), (CARRY_ARCH, inp_np["jgparams"])):
        c_lm = JLM(jreduced(jconfigs.get(arch)))
        _, c_cache = jax.jit(
            lambda p, t, c_lm=c_lm: c_lm.prefill(p, {"tokens": t},
                                                 cache_len=CACHE_LEN),
            compiler_options=fast)(jp, batch["tokens"])
        c_dec, _ = jax.jit(c_lm.decode_step, compiler_options=fast)(
            jp, c_cache, jnp.asarray(inp_np["next"]),
            jnp.full((B,), S, jnp.int32))
        carried[arch] = np.asarray(c_dec, np.float32)
    xs = inp_np["psum_x"]
    scale_max = max(float(jcomp._quant(jnp.asarray(x))[1]) for x in xs)
    scale_max = np.float32(scale_max)
    q2 = [np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / scale_max),
                              -127, 127).astype(jnp.int32)) for x in xs]
    total = np.sum(q2, axis=0, dtype=np.int32)
    return dict(
        options=options, carried=carried,
        loss=float(metrics["loss"]),
        params={k: np.asarray(v, np.float32) for k, v in
                _flat(new["params"]).items()},
        prefill=np.asarray(logits, np.float32),
        decode=np.asarray(dec, np.float32),
        psum=total.astype(np.float32) * scale_max,
        sequential=np.asarray(sequential_apply(
            lambda w, x: jnp.tanh(x @ w), jnp.asarray(inp_np["ws"]),
            jnp.asarray(inp_np["xs"]))))


def _flat(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _port_single(inp: dict) -> dict:
    """The port's single-device step, prefill + decode and default loss on
    plain tensors: what the sharded runs are held to."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch.train import RunConfig, train
    from repro_torch.models.lm import LM
    from repro_torch.training import compression
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import TrainConfig, train_step
    from repro_torch.training.tree import tree_map

    def fresh_state():
        params = tree_map(torch.clone, inp["params"])
        return {"params": params, "opt": init_opt_state(params)}

    def compress(g):
        return compression.compress_decompress(
            g, compression.init_error_state(g))[0]

    lm = LM(reduced(configs.get(ARCH)))
    params = tree_map(torch.clone, inp["params"])
    with torch.no_grad():
        logits, cache = lm.prefill(params, {"tokens": inp["batch"]["tokens"]},
                                   cache_len=CACHE_LEN)
        dec, _ = lm.decode_step(
            params, cache, torch.argmax(logits, -1).to(torch.int32),
            torch.full((B,), S, dtype=torch.int32))
        carried = {}
        for arch, c_params in ((ARCH, params), (CARRY_ARCH, inp["gparams"])):
            c_lm = LM(reduced(configs.get(arch)))
            _, c_cache = c_lm.prefill(
                c_params, {"tokens": inp["batch"]["tokens"]},
                cache_len=CACHE_LEN)
            c_dec, c_cache = c_lm.decode_step(
                c_params, c_cache, inp["next"],
                torch.full((B,), S, dtype=torch.int32))
            carried[arch] = dict(decode=c_dec.float(),
                                 cache=_flat(c_cache))
        loss, _ = lm.loss(params, inp["batch"])
    new, metrics = train_step(lm, TrainConfig(adamw=AdamWConfig(**ADAMW)),
                              {"params": params,
                               "opt": init_opt_state(params)}, inp["batch"])
    tcfg = TrainConfig(adamw=AdamWConfig(**ADAMW))
    options = {}
    for opt, tc, gt in (("mb", TrainConfig(adamw=AdamWConfig(**ADAMW),
                                           microbatch=2), None),
                        ("compress", tcfg, compress)):
        o_new, o_metrics = train_step(lm, tc, fresh_state(), inp["batch"],
                                      grad_transform=gt)
        options[opt] = dict(loss=o_metrics["loss"].item(), state={
            k: v.clone() for k, v in _flat(o_new).items()})
    run = train(RunConfig(**RUN))
    return dict(options=options, carried=carried,
                launch_compress=train(RunConfig(compress_grads=True, **RUN)),
                loss=metrics["loss"].item(),
                grad_norm=metrics["grad_norm"].item(),
                state={k: v.clone() for k, v in _flat(new).items()},
                prefill=logits.float(), decode=dec.float(),
                default_loss=loss.item(), launch=run)


def _as_jax(tree):
    """The port's parameter dict as the reference's pytree (bf16 by its
    bits)."""
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once; meanwhile compute the reference's and the
    port's single-device sides, from the same seeded parameters and
    batch.  Returns (ranks' results, reference, port single-device,
    inputs, work directory)."""
    from repro.training.optimizer import init_opt_state as jinit_opt
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.models.lm import LM

    work = tmp_path_factory.mktemp("dist")
    cfg = reduced(configs.get(ARCH))
    params = LM(cfg).init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    gparams = LM(reduced(configs.get(CARRY_ARCH))).init_params(
        torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    nxt = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    inp_np = dict(batch=batch, next=nxt,
                  psum_x=rng.standard_normal((WORLD, 64)).astype(np.float32),
                  ws=(0.3 * rng.standard_normal((4, 16, 16))
                      ).astype(np.float32),
                  xs=rng.standard_normal((8, 4, 16)).astype(np.float32))
    inp = dict(params=params, gparams=gparams, next=torch.from_numpy(nxt),
               batch={k: torch.from_numpy(v) for k, v in batch.items()},
               psum_x=torch.from_numpy(inp_np["psum_x"]),
               ws=torch.from_numpy(inp_np["ws"]),
               xs=torch.from_numpy(inp_np["xs"]))
    torch.save(inp, work / "inputs.pt")
    procs = _spawn(work)
    try:
        jparams = _as_jax(params)
        inp_np["jstate"] = {"params": jparams, "opt": jinit_opt(jparams)}
        inp_np["jgparams"] = _as_jax(gparams)
        ref = _reference(inp_np)
        single = _port_single(inp)
    finally:
        _join(procs, work)
    return torch.load(work / "ranks.pt"), ref, single, inp, work


def test_sharded_train_step_matches_single_device(ranks):
    got, ref, single, _, _ = ranks
    tr = got["train"]
    for want in (single["loss"], ref["loss"]):
        assert abs(tr["loss"] - want) < 2e-2, (tr["loss"], want)
    params = {k[len("params/"):]: v for k, v in tr["state"].items()
              if k.startswith("params/")}
    assert sorted(params) == sorted(ref["params"])
    for k, v in params.items():
        for want in (single["state"][f"params/{k}"].float().numpy(),
                     ref["params"][k]):
            d = float(np.max(np.abs(v.float().numpy() - want)))
            assert d < 0.05, (k, d)


def test_sharded_step_keeps_layouts_and_optimizer_state(ranks):
    """apply_updates' in-place slices stay on each rank's shards (every
    leaf keeps its layout), the global norm is the single-device one, and
    the moments and step follow the single-device step's."""
    got, _, single, _, _ = ranks
    tr = got["train"]
    assert all(tr["layouts"].values()), \
        [k for k, ok in tr["layouts"].items() if not ok]
    assert abs(tr["grad_norm"] - single["grad_norm"]) \
        <= 2e-2 * single["grad_norm"]
    assert int(tr["state"]["opt/step"]) == 1
    for k, v in tr["state"].items():
        if k.startswith("opt/m/") or k.startswith("opt/v/"):
            want = single["state"][k]
            scale = float(want.abs().max()) or 1.0
            assert float((v - want).abs().max()) <= 0.05 * scale, k


def test_sharded_decode_matches_single_device(ranks):
    got, ref, single, _, _ = ranks
    for what in ("prefill", "decode"):
        for want in (single[what].numpy(), ref[what]):
            d = float(np.max(np.abs(got["decode"][what].numpy() - want)))
            assert d < 0.06, (what, d)


def test_vocab_parallel_loss_matches_default(ranks):
    got, _, single, _, _ = ranks
    vp = got["vocab_parallel"]
    assert vp["vp"] == pytest.approx(vp["default"], rel=1e-6, abs=1e-6)
    assert vp["default"] == pytest.approx(single["default_loss"], abs=2e-2)


def test_checkpoint_reshard_elastic(ranks):
    """Saved under (2, 2), restored under (4, 1): every leaf bit for bit,
    laid out by the (4, 1) rules."""
    ck = ranks[0]["ckpt"]
    assert ck["keys"] and not ck["differ"], ck["differ"]
    assert ck["layouts"] and ck["sharded_on_4"]


def test_checkpoint_restores_in_reference(ranks):
    """The reference's ``checkpoint.restore`` reads the sharded save bit
    for bit (one host file of whole arrays: the reference's layout)."""
    import jax

    from repro import configs as jconfigs
    from repro.configs.reduced import reduced as jreduced
    from repro.models.lm import LM as JLM
    from repro.training import checkpoint as jckpt
    from repro.training.train_step import init_train_state

    _, _, _, inp, work = ranks
    assert sorted(os.listdir(work / "ckpt" / "step_00000001")) == \
        ["host0.npz", "manifest.json"]
    lm = JLM(jreduced(jconfigs.get(ARCH)))
    template = jax.eval_shape(lambda: init_train_state(lm,
                                                       jax.random.key(0)))
    back = jckpt.restore(str(work / "ckpt"), 1, template)
    for k, v in _flat(back["params"]).items():
        t = inp["params"]
        for part in k.split("/"):
            t = t[part]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        assert np.asarray(v).dtype.itemsize == t.element_size(), k
        assert np.asarray(v).tobytes() == t.numpy().tobytes(), k
    for k, v in _flat(back["opt"]).items():
        assert not np.any(np.asarray(v)), k


def test_quantized_psum_matches_reference(ranks):
    got, ref, _, inp, _ = ranks
    ps = got["psum"]
    assert ps["same_on_all"]
    res = ps["result"].numpy()
    assert np.array_equal(res, ref["psum"])
    x = inp["psum_x"].numpy()
    err = float(np.max(np.abs(res - x.sum(0))))
    assert err <= float(np.max(np.abs(x))) / 127 * WORLD + 1e-5, err


def test_pipeline_parallel_matches_sequential(ranks):
    got, ref, _, _, _ = ranks
    pl = got["pipeline"]
    np.testing.assert_allclose(pl["got"].numpy(), pl["sequential"].numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pl["got"].numpy(), ref["sequential"],
                               rtol=2e-5, atol=2e-5)


def test_launch_train_on_mesh_matches_single_device(ranks):
    """``launch.train(run, mesh)`` on the (2, 2) mesh against the same run
    without one: losses within 2e-2, final parameters within 0.05."""
    got, _, single, _, work = ranks
    mesh_run, plain = got["launch"], single["launch"]
    assert len(mesh_run["losses"]) == RUN["steps"]
    for a, b in zip(mesh_run["losses"], plain["losses"]):
        assert abs(a - b) < 2e-2, (mesh_run["losses"], plain["losses"])
    for k, v in _flat(plain["state"]["params"]).items():
        d = float((mesh_run["params"][k].float() - v.float()).abs().max())
        assert d < 0.05, (k, d)
    assert sorted(os.listdir(work / "run")) == ["step_00000001",
                                               "step_00000002"]


def test_microbatches_are_the_global_rows(ranks):
    """Microbatch i of a batch sharded over "data" is global rows
    ``i*mb .. (i+1)*mb`` (the reference's ``dynamic_slice_in_dim``), laid
    out over "data" when ``mb`` divides it and replicated when not."""
    got, _, _, inp, _ = ranks
    tokens = inp["batch"]["tokens"]
    for mb, parts in got["microbatches"].items():
        assert len(parts) == B // mb
        for i, (part, pl) in enumerate(parts):
            assert torch.equal(part, tokens[i * mb:(i + 1) * mb])
            assert pl[0].is_shard(0) == (mb % 2 == 0), (mb, pl)


@pytest.mark.parametrize("option", ["mb", "compress"])
def test_sharded_step_with_option_matches_single_device(ranks, option):
    """The sharded step with microbatches (2) or with compression against
    the reference's and the port's single-device step with the same
    option: loss within 2e-2, every parameter within 0.05."""
    got, ref, single, _, _ = ranks
    tr = got["train_" + option]
    want_ref, want_port = ref["options"][option], single["options"][option]
    for want in (want_port["loss"], want_ref["loss"]):
        assert abs(tr["loss"] - want) < 2e-2, (tr["loss"], want)
    params = {k[len("params/"):]: v for k, v in tr["state"].items()
              if k.startswith("params/")}
    assert sorted(params) == sorted(want_ref["params"])
    for k, v in params.items():
        for want in (want_port["state"][f"params/{k}"].float().numpy(),
                     want_ref["params"][k]):
            d = float(np.max(np.abs(v.float().numpy() - want)))
            assert d < 0.05, (k, d)


def test_compression_of_a_sharded_gradient_is_exact(ranks):
    """``compress_decompress`` of a gradient sharded over both mesh dims:
    the whole tensor's round trip bit for bit (one scale from the global
    ``max|x|``), the error buffers zero in the gradient's layout."""
    from repro_torch.training import compression

    got, _, _, inp, _ = ranks
    ce = got["compress_exact"]
    x = inp["psum_x"]
    want = compression.compress_decompress({"w": x}, {"w": 0.01 * x.flip(0)})
    for g, w in zip(ce["got"], want):
        assert torch.equal(g["w"], w["w"])
    assert ce["zero_placements"] == ce["placements"]
    assert all(p.is_shard() for p in ce["placements"])


def test_compression_error_state_laid_out_as_parameters(ranks):
    """Every error buffer, fresh and after the step, carries its
    parameter's placements (some of them sharded)."""
    lay = ranks[0]["train_compress"]["err_layouts"]
    assert lay and all(lay.values()), [k for k, ok in lay.items() if not ok]


def test_launch_train_compressed_on_mesh_matches_single_device(ranks):
    """``launch.train(run, mesh)`` with ``compress_grads=True`` against the
    same run without a mesh: losses within 2e-2, parameters within
    0.05."""
    got, _, single, _, _ = ranks
    mesh_run, plain = got["launch_compress"], single["launch_compress"]
    assert len(mesh_run["losses"]) == RUN["steps"]
    for a, b in zip(mesh_run["losses"], plain["losses"]):
        assert abs(a - b) < 2e-2, (mesh_run["losses"], plain["losses"])
    for k, v in _flat(plain["state"]["params"]).items():
        d = float((mesh_run["params"][k].float() - v.float()).abs().max())
        assert d < 0.05, (k, d)


@pytest.mark.parametrize("arch", [ARCH, CARRY_ARCH])
def test_carried_uniform_decode_matches_single_device(ranks, arch):
    """A decode with ``decode_carry_cache`` and ``assume_uniform_decode``
    over Minitron's cache sharded along the ring and over reduced
    Gemma-7B's head-sharded cache: logits within 0.06 of the port's and
    the reference's single-device decode, the cache returned is the one
    passed in (the same DTensors, local storage and placements), and its
    leaves hold the single-device decode's new cache within 0.06."""
    got, ref, single, _, _ = ranks
    car, want = got["carried"][arch], single["carried"][arch]
    assert car["sharded"] and car["same"]
    for w in (want["decode"].numpy(), ref["carried"][arch]):
        d = float(np.max(np.abs(car["decode"].numpy() - w)))
        assert d < 0.06, d
    assert sorted(car["cache"]) == sorted(want["cache"])
    for k, v in car["cache"].items():
        d = float((v.float() - want["cache"][k].float()).abs().max())
        assert d < 0.06, (k, d)
