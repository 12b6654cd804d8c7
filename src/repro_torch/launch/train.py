"""End-to-end training driver with fault tolerance (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2.5-3b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --full --steps 4 --seq-len 1024 --global-batch 2

Runs on the card unless ``--device cpu`` is given; ``--full`` trains the
full config where it fits on the one card.  Behaviours:
  * automatic resume: the latest checkpoint in ``--ckpt-dir`` is restored
    (params, optimizer state, step) and the data stream skips ahead
    (``batch_at(step)`` is stateless, so no batch repeats after a
    restart);
  * periodic non-blocking checkpoints (the previous save joined before
    the next) and a blocking one at the end;
  * a straggler watchdog: a wall-clock EWMA of the step time (each step
    ends in the loss's ``.item()``, a device sync); steps slower than
    ``straggler_factor`` x the EWMA are logged with their index;
  * optional int8 error-feedback gradient compression
    (``--compress-grads``), its error state carried across steps.

Parameters are drawn on the CPU from a generator seeded ``seed`` and moved
to the device, so a run on the card and one on the CPU start from the
same parameters (and see the same batches, ``SyntheticStream``).

``train(run, mesh, rules)`` trains under a DTensor mesh
(``launch/mesh.py``; ``rules`` defaults to ``Rules(cfg, mesh)``): every
rank of the process group runs the same loop (SPMD), the state is laid
out by ``rules.state_spec`` and each batch by ``rules.batch_spec``, the
model's ``shard`` hook is ``rules.act_shard()``, and a resume restores
the checkpoint under the current rules' layout, whatever mesh saved it.
Each rank saves as host ``rank`` (only rank 0 writes; the checkpoint
holds whole tensors).  Under ``--compress-grads`` the error state is laid
out as the parameters and follows them across steps; as in the reference,
no checkpoint holds it (a resumed run starts it from zeros).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.reduced import reduced
from repro_torch.device import DEFAULT_DEVICE, card_line, resolve_device
from repro_torch.distributed.sharding import Rules, distribute, is_dtensor
from repro_torch.models.lm import LM, _identity
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression
from repro_torch.training.data import DataConfig, SyntheticStream
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             train_step)
from repro_torch.training.tree import tree_map


@dataclasses.dataclass(frozen=True)
class RunConfig:
    arch: str
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    stop_after: Optional[int] = None  # simulate a crash at this step
    lr: float = 3e-4
    reduced: bool = True
    compress_grads: bool = False
    straggler_factor: float = 3.0
    seed: int = 0
    log_every: int = 10
    device: str = DEFAULT_DEVICE


def _initial_state(lm: LM, run: RunConfig, dev: torch.device,
                   rules=None) -> tuple[dict, int]:
    """The state to start from: the latest checkpoint in ``run.ckpt_dir``,
    else parameters drawn on the CPU and moved to ``dev`` with a fresh
    optimizer state on ``dev``; under ``rules``, laid out on its mesh.
    Returns (state, first step)."""
    latest = ckpt.latest_step(run.ckpt_dir) if run.ckpt_dir else None
    if latest is not None:
        template = init_train_state(lm, device="meta")
        kw = {} if rules is None else dict(
            mesh=rules.mesh, specs=rules.state_spec(template))
        state = ckpt.restore(run.ckpt_dir, latest, template, dev, **kw)
        print(f"[train] resumed from step {latest}")
        return state, latest
    params = lm.init_params(torch.Generator().manual_seed(run.seed))
    params = tree_map(lambda t: t.to(dev), params)
    state = {"params": params, "opt": init_opt_state(params)}
    if rules is not None:
        state = distribute(state, rules.state_spec(state), rules.mesh)
    return state, 0


def _item(x) -> float:
    """A scalar metric on the host (a DTensor's whole value)."""
    if is_dtensor(x):
        x = x.full_tensor()
    return x.item()


def train(run: RunConfig, mesh=None, rules=None) -> dict:
    dev = resolve_device(run.device)
    cfg = configs.get(run.arch)
    if run.reduced:
        cfg = reduced(cfg)
    lm = LM(cfg)
    if rules is None and mesh is not None:
        rules = Rules(cfg, mesh)
    rank = 0 if rules is None else torch.distributed.get_rank()
    shard = rules.act_shard() if rules is not None else _identity
    tcfg = TrainConfig(adamw=AdamWConfig(lr=run.lr, total_steps=run.steps,
                                         warmup_steps=max(run.steps // 10, 1)))
    stream = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=run.seq_len,
        global_batch=run.global_batch, seed=run.seed), device=dev)

    state, start_step = _initial_state(lm, run, dev, rules)
    err_state = (compression.init_error_state(state["params"])
                 if run.compress_grads else None)

    def compress(grads):
        nonlocal err_state
        grads, err_state = compression.compress_decompress(grads, err_state)
        return grads

    ewma = None
    slow_steps = []
    losses, grad_norms = [], []
    pending_save = None
    stop_at = min(run.steps, run.stop_after or run.steps)
    for step in range(start_step, stop_at):
        batch = stream.batch_at(step)
        if rules is not None:
            batch = distribute(batch, rules.batch_spec(batch), rules.mesh)
        # wall-clock feeds the straggler watchdog (an observability hook,
        # not training logic); the loss's .item() ends it in a device sync
        t0 = time.perf_counter()
        state, metrics = train_step(
            lm, tcfg, state, batch, shard=shard,
            grad_transform=compress if err_state is not None else None)
        loss = _item(metrics["loss"])
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > run.straggler_factor * ewma and step > start_step + 3:
            slow_steps.append((step, round(dt, 3)))
            print(f"[watchdog] straggler step {step}: {dt:.3f}s "
                  f"(ewma {ewma:.3f}s)")
        losses.append(loss)
        grad_norms.append(_item(metrics["grad_norm"]))
        if run.log_every and step % run.log_every == 0 and rank == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {metrics['lr'].item():.2e} {dt * 1e3:.0f}ms")
        if run.ckpt_dir and (step + 1) % run.ckpt_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = ckpt.save(run.ckpt_dir, step + 1, state,
                                     process_index=rank, blocking=False)
    if pending_save is not None:
        pending_save.join()
    if run.ckpt_dir:
        ckpt.save(run.ckpt_dir, stop_at, state, process_index=rank)
    return {"losses": losses, "grad_norms": grad_norms,
            "slow_steps": slow_steps, "state": state,
            "final_loss": losses[-1] if losses else None}


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.names())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full", action="store_true",
                    help="full config (where it fits on the one device)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("DATA", "MODEL"),
                    help="train on a DATA x MODEL mesh over the process "
                         "group torchrun starts (gloo on the CPU, nccl "
                         "on cards, one card a rank)")
    args = ap.parse_args(argv)
    mesh, device = None, args.device
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh
        kind = torch.device(device).type
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
        if kind == "cuda":
            local = dist.get_rank() % torch.cuda.device_count()
            torch.cuda.set_device(local)
            device = f"cuda:{local}"
        mesh = make_host_mesh(data=args.mesh[0], model=args.mesh[1],
                              device_type=kind)
    out = train(RunConfig(
        arch=args.arch, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, lr=args.lr, reduced=not args.full,
        compress_grads=args.compress_grads, device=device), mesh=mesh)
    if mesh is None or torch.distributed.get_rank() == 0:
        print(f"final loss: {out['final_loss']:.4f}; "
              f"stragglers: {out['slow_steps']}; device: "
              f"{card_line(device)}")
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
