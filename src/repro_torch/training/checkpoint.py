"""Checkpoint save and restore in the reference's layout on disk (port of
``repro.training.checkpoint``), so each package reads the other's.

  * ``save`` writes one ``host<i>.npz`` per host plus a ``manifest.json``
    (``{"step", "keys"}``, the keys sorted) under ``step_<N>``; keys are
    the tree paths joined by ``/`` and stored with ``~``; bf16 is stored
    as its uint16 bits (npz has no bf16).  Writes go to a temporary
    directory renamed atomically, so a crash mid-save never corrupts the
    latest checkpoint.
  * ``restore`` takes structure, dtypes and shapes from a template (meta
    tensors do: ``LM.init_params(device="meta")``) and places the leaves
    on ``device`` or, given a mesh and partition specs (the reference's
    ``shardings``), lays each out as a DTensor on that mesh — which may
    differ from the saving run's (elastic rescale: save under a (2, 2)
    mesh, restore under (4, 1)).
  * A tree of DTensors is saved whole: every rank joins the gather of
    each leaf (``full_tensor``), only ``process_index`` 0 writes, so the
    layout on disk is the reference's whatever the mesh, and a blocking
    save returns on every rank once the checkpoint is on disk.
  * ``latest_step`` + ``launch/train.py`` give resume after a failure.
  * A non-blocking save copies every leaf to the host before it returns
    and writes from a thread, so the train loop only waits for the
    previous save; the optimizer then updates the live tensors in place
    without touching what is being written.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed.sharding import distribute, is_dtensor
from repro_torch.training.tree import items, unflatten


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (of the whole tensor for a DTensor: a
    collective every rank joins) that later in-place updates of ``t``
    leave alone; bf16 as its uint16 bits."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save(ckpt_dir: str, step: int, tree, process_index: int = 0,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Write ``tree`` under ckpt_dir/step_<N>/ atomically."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    leaves = items(tree)
    sharded = any(is_dtensor(leaf) for _, leaf in leaves)
    host_data = {path.replace("/", "~"): _host_array(leaf)
                 for path, leaf in leaves}

    def _write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"host{process_index}.npz"), **host_data)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(host_data)}, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    writes = not sharded or process_index == 0
    if blocking:
        if writes:
            _write()
        if sharded:
            import torch.distributed as dist
            dist.barrier()
        return None
    if not writes:
        return None
    th = threading.Thread(target=_write, daemon=True)
    th.start()
    return th


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp0")
             and os.path.isfile(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template,
            device: str | torch.device = DEFAULT_DEVICE, mesh=None,
            specs=None):
    """Load step ``step`` into a tree of ``template``'s structure, dtypes
    and shapes, on ``device``; with a ``mesh``, each leaf is laid out on it
    under ``specs`` (a tree of partition specs, e.g.
    ``Rules(cfg, mesh).state_spec(template)``; every rank calls it)."""
    dev = resolve_device(device)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat: dict[str, np.ndarray] = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".npz"):
            with np.load(os.path.join(d, f)) as z:
                for k in z.files:
                    flat[k.replace("~", "/")] = z[k]

    def place(tmpl: torch.Tensor, path: str) -> torch.Tensor:
        arr = flat[path]
        if tmpl.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr).to(tmpl.dtype)
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"checkpoint leaf {path}: shape "
                             f"{tuple(t.shape)}, template {tuple(tmpl.shape)}")
        return t.to(dev)

    tree = unflatten(template, [place(t, path)
                                for path, t in items(template)])
    if mesh is None:
        return tree
    return distribute(tree, specs, mesh)
