"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group with fake tensors (port of ``repro.launch.dryrun``).

For each cell this builds the production mesh (``launch/mesh.py``: 16 x
16 = 256 devices, or 2 x 16 x 16 = 512) over a fake process group of that
world size, lays every input out by ``Rules`` (``launch/inputs.py``'s
shape-only trees made fake tensors on the run's device type, then
``sharding.distribute``), runs the cell's step function (train /
prefill / decode) once under ``FakeTensorMode`` and records, per device:

  * memory: ``argument_bytes`` (the inputs' local shards),
    ``output_bytes``, ``peak_bytes`` (the most bytes of local storage
    alive at once, inputs included: every storage an operation makes is
    counted from its creation until it is freed) and ``temp_bytes`` =
    peak - argument; whether the cell fits a device is ``peak_bytes``
    against the device's memory;
  * costs: ``flops`` (torch's FLOP formulas, ``torch.utils.flop_counter``,
    on each operation a device runs: the local operations DTensor
    dispatches, so the same count whether DTensor or the model's
    shard-by-shard products issue them); ``bytes_accessed``, the sum of
    every operation's input and result bytes on the local shards (views
    and allocations excluded).  Nothing is fused, so it is an upper bound
    on the traffic a fused program makes; and the collectives by kind
    (all-gather, all-reduce, reduce-scatter, all-to-all, and
    collective-permute from point-to-point sends) with their count and
    bytes: the reference's ring factors on each result's bytes and its
    group's size n (all-gather and all-to-all (n-1)/n, reduce-scatter
    n-1, all-reduce 2(n-1)/n, collective-permute 1).

The fake process group exchanges nothing and the fake tensors hold no
memory, so a cell of 512 devices traces in one process on one host, on
the CPU (``device="cpu"``) or against a card's device type
(``device="cuda"``, the default): no kernel runs and no device memory is
taken.  The accounting probes (``launch/accounting.py``) run under the
same mesh and rules and are combined as the reference combines them
(``cost``); the full-depth trace's own count is ``cost_scan_undercounted``,
a name kept for ``benchmarks/roofline.py``: in the port nothing is
undercounted, since its layer loop is Python and every layer is
dispatched.  Both the full trace and the probes use
``accounting_blocks(S)`` as attention blocks: the port's blockwise
attention masks blocks rather than skipping them, so on whole
sequences the block size changes no FLOP count, and large blocks keep
a 32k-token trace to tens of iterations a layer.  (On DTensors a query
block that cuts a sequence-sharded query gathers it and repeats the
block on every rank of that mesh dim; whole-sequence blocks, as the
accounting blocks are up to 4096 tokens, do not.)  The memory figures
are at those blocks.

Keys of the reference's record with no counterpart are ``None``:
  * ``entry_bytes``: the reference sums the result bytes of the HLO entry
    computation's operations; the port runs no compiled program;
  * ``transcendentals``: XLA's count of transcendental operations; torch
    has no such counter;
  * ``generated_code_bytes``: the size of XLA's compiled code; the port
    compiles none.

Results go to ``dryrun_results_torch/<cell>.json`` at the repository's
root.

Usage (``--device cpu`` traces on a host with no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch qwen2.5-3b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.distributed.sharding import P, Rules, distribute
from repro_torch.launch import inputs as inp
from repro_torch.launch.accounting import accounting_blocks, probe_plan
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import LM
from repro_torch.training.train_step import TrainConfig, train_step
from repro_torch.training.tree import tree_map

RESULTS_DIR = str(Path(__file__).resolve().parents[3]
                  / "dryrun_results_torch")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_factor(kind: str, n: int) -> float:
    """Per-device wire bytes per result byte of a collective over ``n``
    devices (the reference's ring model)."""
    return {"all-gather": (n - 1) / n,
            "reduce-scatter": float(n - 1),
            "all-reduce": 2 * (n - 1) / n,
            "all-to-all": (n - 1) / n,
            "collective-permute": 1.0}[kind]


def _collective_kinds() -> dict:
    """``{op: kind}`` for every collective a traced step can dispatch."""
    ops = {}
    for ns in ("_c10d_functional", "_c10d_functional_autograd"):
        lib = getattr(torch.ops, ns)
        for name, kind in (
                ("all_gather_into_tensor", "all-gather"),
                ("all_gather_into_tensor_out", "all-gather"),
                ("all_gather_into_tensor_coalesced", "all-gather"),
                ("all_reduce", "all-reduce"),
                ("all_reduce_", "all-reduce"),
                ("all_reduce_coalesced", "all-reduce"),
                ("all_reduce_coalesced_", "all-reduce"),
                ("reduce_scatter_tensor", "reduce-scatter"),
                ("reduce_scatter_tensor_out", "reduce-scatter"),
                ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                ("all_to_all_single", "all-to-all")):
            if hasattr(lib, name):
                ops[getattr(lib, name).default] = kind
    if hasattr(torch.ops, "_dtensor"):
        ops[torch.ops._dtensor.shard_dim_alltoall.default] = "all-to-all"
    ops[torch.ops.c10d.send.default] = "collective-permute"
    return ops


def _group_size(args, sizes: dict) -> int:
    """The size of the process group a collective names (by name, looked
    up once into ``sizes``, or as the group object of a point-to-point
    op)."""
    from torch._C._distributed_c10d import (ProcessGroup,
                                            _resolve_process_group)
    for a in reversed(args):
        if isinstance(a, str):
            if a not in sizes:
                sizes[a] = _resolve_process_group(a).size()
            return sizes[a]
        if isinstance(a, ProcessGroup):
            return a.size()
    raise ValueError(f"no process group among {args!r}")


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    """The untyped storage of a plain tensor, or of a DTensor's local
    shard."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(t):
        t = t.to_local()
    return t.untyped_storage()


def storage_bytes(tree) -> int:
    """Bytes of the distinct local storages under ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = _storage(t)
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


_NO_DATA = {torch.ops.prim.device.default}


class Recorder(TorchDispatchMode):
    """Counts what one device runs: FLOPs, bytes, collectives and live
    local storage.

    An operation on DTensors is passed on (``NotImplemented``) so that
    DTensor runs it as the local operations and collectives of one rank,
    which this mode then sees on the local shards.  DTensor's sharding
    propagation, which runs each new operator signature once on global
    shapes to plan its layouts, is not counted (``paused``).
    An operation without a FLOP formula is decomposed first where it has
    a decomposition, as ``FlopCounterMode`` does, so both count the same
    operations."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.collective_kinds = _collective_kinds()
        self.flops = 0
        self.bytes_accessed = 0
        self.coll = {k: {"count": 0, "bytes": 0.0} for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._refs = {}
        self._paused = 0
        self._group_sizes = {}

    # -- live storage ------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages under ``tree`` as live from now until each
        is freed."""
        from repro_torch.distributed.sharding import is_dtensor
        for t in _tensors(tree):
            self._track(t.to_local() if is_dtensor(t) else t)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        size = st.nbytes()

        def freed(_, key=key, size=size):
            self._refs.pop(key, None)
            self.live -= size

        self._refs[key] = weakref.ref(st, freed)
        self.live += size
        self.peak = max(self.peak, self.live)

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # the fake kernel makes a new tensor; an eager wait returns its
            # argument
            return args[0]
        packet = func._overloadpacket
        if packet not in self.flop_registry and func not in _NO_DATA:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        outs = [t for t in _tensors(out) if t.device.type != "meta"]
        kind = self.collective_kinds.get(func)
        if kind is not None:
            n = _group_size(args, self._group_sizes)
            res = _tensors(args[0]) if kind == "collective-permute" else outs
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += (sum(map(_nbytes, res))
                                         * ring_factor(kind, n))
        if func not in _NO_DATA and not func.is_view and outs and not (
                func._schema.name.startswith("aten::empty")
                or func._schema.name.startswith("aten::new_empty")):
            self.bytes_accessed += sum(
                map(_nbytes, _tensors((args, kwargs)) + outs))
        for t in outs:
            self._track(t)
        return out

    def cost(self) -> dict:
        flat = {
            "flops": float(self.flops),
            "bytes_accessed": float(self.bytes_accessed),
            "entry_bytes": None,
            "transcendentals": None,
            "coll_total_bytes": sum(v["bytes"] for v in self.coll.values()),
        }
        for k in COLLECTIVES:
            flat[f"coll_{k}_bytes"] = self.coll[k]["bytes"]
            flat[f"coll_{k}_count"] = self.coll[k]["count"]
        return flat


# DTensor's sharding propagation: it runs each new operator signature's
# decomposition and output metadata once (then caches them), on global
# shapes; none of it is work a device does
_PROPAGATION = ("propagate_op_sharding_non_cached",
                "_propagate_tensor_meta_non_cached")


@contextlib.contextmanager
def recording(rec: Recorder):
    """``rec`` active, with DTensor's sharding propagation paused."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    origs = {name: getattr(ShardingPropagator, name)
             for name in _PROPAGATION if hasattr(ShardingPropagator, name)}

    def paused(orig):
        def run(*args, **kwargs):
            with rec.paused():
                return orig(*args, **kwargs)
        return run

    for name, orig in origs.items():
        setattr(ShardingPropagator, name, paused(orig))
    try:
        with rec:
            yield rec
    finally:
        for name, orig in origs.items():
            setattr(ShardingPropagator, name, orig)


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks that exchanges
    nothing (torch's fake backend), this process as rank 0; taken down on
    exit.  An existing fake group of that size is used as it is; any other
    default group raises (a process has one)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world_size):
            yield
            return
        raise RuntimeError(
            f"a {dist.get_backend()} process group of "
            f"{dist.get_world_size()} ranks is already the default group; "
            f"the dry run needs a fake one of {world_size}")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_devices(mesh_kind: str) -> int:
    return 512 if mesh_kind == "multipod" else 256


def _own_storage(x):
    """A DTensor whose local shard owns a storage of exactly its bytes
    (a shard made as a view of the global tensor shares its storage)."""
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    if local.untyped_storage().nbytes() == _nbytes(local):
        return x
    return DTensor.from_local(local.clone(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _fake(tree, device: str):
    """Each shape-only leaf of ``tree`` as an (uninitialized) tensor on
    ``device``; under ``FakeTensorMode`` a fake one."""
    if isinstance(tree, dict):
        return {k: _fake(v, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def _lay_out(tree, spec, mesh):
    return tree_map(_own_storage, distribute(tree, spec, mesh))


def fake_inputs(lm: LM, shape, rules: Rules, mesh, device: str) -> tuple:
    """The cell's step arguments (``inputs.input_specs``) as fake tensors
    on ``device``, laid out on ``mesh`` by ``rules``: the train state by
    ``state_spec``, parameters by ``param_specs``, batches by
    ``batch_spec``, the decode cache by ``cache_spec`` and the decode
    tokens and positions over the data axes.  Call under
    ``FakeTensorMode``."""
    args = tuple(_fake(a, device) for a in inp.input_specs(lm, shape))
    if shape.kind == "train":
        state, batch = args
        return (_lay_out(state, rules.state_spec(state), mesh),
                _lay_out(batch, rules.batch_spec(batch), mesh))
    if shape.kind == "prefill":
        params, batch = args
        return (_lay_out(params, rules.param_specs(params), mesh),
                _lay_out(batch, rules.batch_spec(batch), mesh))
    params, cache, tok, pos = args
    tok_spec = P(rules._dp_for(tok.shape[0]))
    return (_lay_out(params, rules.param_specs(params), mesh),
            _lay_out(cache, rules.cache_spec(cache), mesh),
            _lay_out(tok, tok_spec, mesh), _lay_out(pos, tok_spec, mesh))


def build_step(lm: LM, shape, rules: Rules):
    """The cell's step function over ``fake_inputs``'s arguments."""
    shard = rules.act_shard()
    if shape.kind == "train":
        tcfg = TrainConfig()

        def fn(state, batch):
            return train_step(lm, tcfg, state, batch, shard=shard)
        return fn

    if shape.kind == "prefill":
        def fn(params, batch):
            return lm.prefill(params, batch, cache_len=shape.seq_len,
                              shard=shard)
        return fn

    def fn(params, cache, tokens, positions):
        return lm.decode_step(params, cache, tokens, positions, shard=shard)
    return fn


def trace_once(lm: LM, shape, mesh, rules: Rules, device: str
               ) -> tuple[dict, dict]:
    """Run one step function on fake inputs.  Returns (costs, memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args = fake_inputs(lm, shape, rules, mesh, device)
        fn = build_step(lm, shape, rules)
        rec = Recorder()
        rec.track(args)
        argument = rec.live
        with recording(rec):
            out = fn(*args)
        memd = {
            "argument_bytes": argument,
            "output_bytes": storage_bytes(out),
            "temp_bytes": rec.peak - argument,
            "peak_bytes": rec.peak,
            "generated_code_bytes": None,
        }
        del out, args
    return rec.cost(), memd


def trace_cell(cfg, shape, mesh, rules_kw: dict, lm_kw: dict,
               device: str) -> dict:
    """The full configuration's trace and the accounting probes' on
    ``mesh`` (under the fake world that holds it).  Returns ``full`` and
    ``memory`` (the full trace's costs and memory), ``probes`` and
    ``probe_memory`` (each probe's), ``cost`` (the probes' costs
    combined) and the seconds of each part, ``full_s`` and ``probe_s``."""
    t0 = time.perf_counter()
    # 1. the full config: proves the layout coherent, the memory fit
    lm = LM(cfg, attn_blocks=accounting_blocks(shape.seq_len), **lm_kw)
    full, memd = trace_once(lm, shape, mesh, Rules(cfg, mesh, **rules_kw),
                            device)
    t_full = time.perf_counter() - t0
    # 2. the accounting probes, combined as the reference's
    probes, combine = probe_plan(cfg, shape)
    probe_cost: dict[str, dict] = {}
    probe_mem: dict[str, dict] = {}
    for pr in probes:
        plm = LM(pr.cfg, attn_blocks=accounting_blocks(pr.shape.seq_len),
                 **lm_kw)
        probe_cost[pr.name], probe_mem[pr.name] = trace_once(
            plm, pr.shape, mesh, Rules(pr.cfg, mesh, **rules_kw), device)
    return {"full": full, "memory": memd, "probes": probe_cost,
            "probe_memory": probe_mem, "cost": combine(probe_cost),
            "full_s": t_full,
            "probe_s": time.perf_counter() - t0 - t_full}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = RESULTS_DIR, verbose: bool = True,
             rules_overrides: dict | None = None,
             lm_overrides: dict | None = None,
             tag: str = "", device: str = DEFAULT_DEVICE) -> dict:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    cell = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
    if not ok:
        rec = {"cell": cell, "status": "skipped", "reason": why}
        _write(out_dir, cell, rec)
        if verbose:
            _print_cell(rec)
        return rec

    lm_kw = lm_overrides or {}
    # default sharding policy per shape kind: training activations are
    # sequence-sharded (Megatron SP) so per-layer residuals fit a device
    rkw = {"sp_activations": shape.kind == "train"}
    rkw.update(rules_overrides or {})
    devices = mesh_devices(mesh_kind)
    try:
        with fake_world(devices):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                        device_type=device)
            traced = trace_cell(cfg, shape, mesh, rkw, lm_kw, device)
        rec = {
            "cell": cell,
            "status": "ok",
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "devices": devices,
            "compile_s": round(traced["full_s"], 1),
            "probe_s": round(traced["probe_s"], 1),
            "memory": traced["memory"],
            "cost_scan_undercounted": traced["full"],
            "cost": traced["cost"],
            "probes": traced["probes"],
        }
    except Exception as e:  # noqa: BLE001 — dry-run failures are findings
        rec = {"cell": cell, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    _write(out_dir, cell, rec)
    if verbose:
        _print_cell(rec)
    return rec


def _write(out_dir: str, cell: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def _print_cell(rec: dict) -> None:
    if rec["status"] == "ok":
        m = rec["memory"]
        c = rec["cost"]
        print(f"[ok] {rec['cell']}: trace={rec['compile_s']}s+"
              f"{rec['probe_s']}s flops={c['flops']:.3e} "
              f"bytes={c['bytes_accessed']:.3e} "
              f"coll={c['coll_total_bytes']:.3e}B "
              f"args={m['argument_bytes']} peak={m['peak_bytes']} "
              f"temp={m['temp_bytes']}", flush=True)
    elif rec["status"] == "skipped":
        print(f"[skip] {rec['cell']}: {rec['reason']}", flush=True)
    else:
        print(f"[ERR] {rec['cell']}: {rec['error']}", flush=True)


def optimized_overrides(arch: str, shape_name: str) -> tuple[dict, dict]:
    """The reference's per-(arch x shape) configuration (its §Perf
    iteration log chose these), without ``assume_uniform_decode``, which
    only steers XLA's lowering and which the port's LM does not have."""
    shape = SHAPES[shape_name]
    cfg = configs.get(arch)
    lm_kw: dict = {}
    rules_kw: dict = {}
    if shape.kind == "decode":
        # fsdp off: parameters stay resident, no per-token weight gathers,
        # except for MoE archs, where FSDP's D-dim sharding doubles as
        # data-axis compute slicing for the expert products
        if cfg.moe is None:
            rules_kw["fsdp"] = False
        # a head-sharded cache makes the new token's writes shard-local
        if (cfg.mla is None and cfg.num_kv_heads
                and cfg.num_kv_heads % 16 == 0):
            rules_kw["head_sharded_cache"] = True
    else:
        lm_kw["vocab_parallel"] = True
        if cfg.mla is not None:
            rules_kw["pin_attn_heads"] = True  # helps MLA, hurts plain GQA
    return lm_kw, rules_kw


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the reference's optimized overrides "
                         "(results tagged __opt)")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="device type of the fake tensors and the mesh "
                         "(cuda or cpu)")
    args = ap.parse_args(argv)

    archs = configs.names() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                lm_kw: dict = {}
                rules_kw: dict = {}
                tag = ""
                if args.opt:
                    lm_kw, rules_kw = optimized_overrides(arch, shape_name)
                    tag = "opt"
                rec = run_cell(arch, shape_name, mesh_kind, args.out,
                               lm_overrides=lm_kw, rules_overrides=rules_kw,
                               tag=tag, device=args.device)
                failures += rec["status"] == "error"
    print(f"dry-run complete; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
