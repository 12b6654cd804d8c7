"""The port's dry run (``repro_torch.launch.{accounting,dryrun}``) against
the reference's pure functions, and its fake traces against real runs.

The reference's own dry run needs 512 forced host devices and an XLA
compile per cell, so it is not run: the reference side here is its
``probe_plan``, ``applicable``, ``optimized_overrides``,
``collective_stats`` (on ``tests/test_system.py``'s HLO text) and
``Rules`` on stand-in meshes (an object whose ``shape`` is ``{axis:
size}``, as ``tests/test_torch_sharding.py`` uses).  The port's side runs
on torch's fake process group with fake tensors on the CPU: the
production meshes (16 x 16 and 2 x 16 x 16) for the argument bytes and
one full-width decode cell, and a (1, 1) mesh for the FLOPs of a fake
step against a real one.  The probes against the full trace are in
``tests/test_torch_dryrun_probes.py``.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import applicable as japplicable  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.launch.accounting import probe_plan as jprobe_plan  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable  # noqa: E402,E501
from repro_torch.distributed.sharding import Rules  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.accounting import probe_plan  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402,E501
from repro_torch.models.lm import LM  # noqa: E402

ARCHS = configs.names()
MESH_KINDS = ("single", "multipod")
STAND_IN = {"single": {"data": 16, "model": 16},
            "multipod": {"pod": 2, "data": 16, "model": 16}}
COST_KEYS = ("flops",) + tuple(
    f"coll_{k}_{x}" for k in dryrun.COLLECTIVES for x in ("count", "bytes"))


def test_arch_lists_agree():
    assert ARCHS == jconfigs.names()
    assert list(SHAPES) == list(JSHAPES)


# --------------------------------------------------------------------------
# 1. probe_plan parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_probe_plan_parity(arch):
    """For all four shapes: the same probe names, each probe's config
    field by field and shape, and the same combination of the same random
    integer costs."""
    rng = np.random.default_rng(sum(map(ord, arch)))
    for name in SHAPES:
        probes, combine = probe_plan(configs.get(arch), SHAPES[name])
        jprobes, jcombine = jprobe_plan(jconfigs.get(arch), JSHAPES[name])
        assert [p.name for p in probes] == [p.name for p in jprobes]
        for p, jp in zip(probes, jprobes):
            assert (dataclasses.asdict(p.cfg)
                    == dataclasses.asdict(jp.cfg)), (arch, name, p.name)
            assert (dataclasses.asdict(p.shape)
                    == dataclasses.asdict(jp.shape)), (arch, name, p.name)
        costs = {p.name: {k: int(v) for k, v in zip(
            ("flops", "bytes_accessed", "coll_total_bytes"),
            rng.integers(0, 2 ** 40, 3))} | {"transcendentals": None}
            for p in probes}
        assert combine(costs) == jcombine(costs), (arch, name)


# --------------------------------------------------------------------------
# 2. records and overrides parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_records_and_overrides_parity(arch, tmp_path):
    """Every (shape x mesh) cell: ``applicable`` as the reference's; a
    skipped cell's record and JSON file equal the reference's own
    ``run_cell`` record (which returns before any compile);
    ``optimized_overrides`` the reference's minus
    ``assume_uniform_decode``."""
    for name in SHAPES:
        ok, why = applicable(configs.get(arch), SHAPES[name])
        assert (ok, why) == japplicable(jconfigs.get(arch), JSHAPES[name])
        lm_kw, rules_kw = dryrun.optimized_overrides(arch, name)
        jlm_kw, jrules_kw = jdryrun.optimized_overrides(arch, name)
        jlm_kw.pop("assume_uniform_decode", None)
        assert (lm_kw, rules_kw) == (jlm_kw, jrules_kw)
        if ok:
            continue
        for mesh_kind in MESH_KINDS:
            for tag in ("", "opt"):
                rec = dryrun.run_cell(arch, name, mesh_kind,
                                      str(tmp_path / "port"), verbose=False,
                                      tag=tag, device="cpu")
                want = jdryrun.run_cell(arch, name, mesh_kind,
                                        str(tmp_path / "ref"), verbose=False,
                                        tag=tag)
                assert rec == want
                cell = rec["cell"] + ".json"
                assert (json.loads((tmp_path / "port" / cell).read_text())
                        == json.loads((tmp_path / "ref" / cell).read_text()))


# --------------------------------------------------------------------------
# 3. ring-factor parity
# --------------------------------------------------------------------------

HLO = """
  %all-reduce = f32[8,128]{1,0} all-reduce(%dot), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = bf16[16,64]{1,0} all-gather(%p), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[4]{0} reduce-scatter(%x), replica_groups={{0,1},{2,3}}, to_apply=%add
"""


@pytest.fixture
def fake8():
    """A fake world of 8 ranks and a (2, 4) ("data", "model") mesh."""
    with dryrun.fake_world(8):
        yield make_host_mesh(model=4, data=2, device_type="cpu")


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter"])
def test_ring_factor_parity(kind, fake8):
    """``tests/test_system.py``'s three collectives issued as DTensor
    redistributions, with the same result shapes, dtypes and group sizes:
    the recorder's count and bytes equal the reference's
    ``collective_stats`` of that HLO."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = fake8
    with FakeTensorMode():
        if kind == "all-reduce":      # f32 (8, 128) over the 4 of "model"
            x = DTensor.from_local(torch.empty(8, 128), mesh,
                                   [Replicate(), Partial()], run_check=False)
            want = [Replicate(), Replicate()]
        elif kind == "all-gather":    # bf16 (16, 64) from (4, 64) shards
            x = DTensor.from_local(torch.empty(4, 64, dtype=torch.bfloat16),
                                   mesh, [Replicate(), Shard(0)],
                                   run_check=False)
            want = [Replicate(), Replicate()]
        else:                         # f32 (8,) into (4,) over the 2 of "data"
            x = DTensor.from_local(torch.empty(8), mesh,
                                   [Partial(), Replicate()], run_check=False)
            want = [Shard(0), Replicate()]
        rec = dryrun.Recorder()
        with dryrun.recording(rec):
            y = x.redistribute(mesh, want)
        assert tuple(y.to_local().shape) == {
            "all-reduce": (8, 128), "all-gather": (16, 64),
            "reduce-scatter": (4,)}[kind]
    ref = jdryrun.collective_stats(HLO)
    assert rec.coll[kind] == ref[kind]
    assert sum(v["count"] for v in rec.coll.values()) == 1


# --------------------------------------------------------------------------
# 4. argument bytes parity
# --------------------------------------------------------------------------

def _shard_bytes(leaf, spec, mesh) -> int:
    n = np.dtype(leaf.dtype).itemsize
    for d, size in enumerate(leaf.shape):
        part = spec[d] if d < len(spec) else None
        n *= size // jsh.axis_size(mesh, part)
    return n


def _pairs(tree, specs):
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], specs[k])]
    return [(tree, specs)]


def reference_argument_bytes(arch: str, shape_name: str, mesh_kind: str):
    """Per-device bytes of the reference's inputs laid out by its Rules on
    a stand-in mesh: each leaf's shard under its spec."""
    lm = JLM(jconfigs.get(arch))
    shape = JSHAPES[shape_name]
    mesh = types.SimpleNamespace(shape=dict(STAND_IN[mesh_kind]))
    rules = jsh.Rules(lm.cfg, mesh, sp_activations=shape.kind == "train")
    args = jinputs.input_specs(lm, shape)
    if shape.kind == "train":
        pairs = (_pairs(args[0], rules.state_spec(args[0]))
                 + _pairs(args[1], rules.batch_spec(args[1])))
    elif shape.kind == "prefill":
        pairs = (_pairs(args[0], rules.param_specs(args[0]))
                 + _pairs(args[1], rules.batch_spec(args[1])))
    else:
        params, cache, tok, pos = args
        tok_spec = jsh.P(rules._dp_for(tok.shape[0]))
        pairs = (_pairs(params, rules.param_specs(params))
                 + _pairs(cache, rules.cache_spec(cache))
                 + [(tok, tok_spec), (pos, tok_spec)])
    return sum(_shard_bytes(leaf, spec, mesh) for leaf, spec in pairs)


@pytest.mark.parametrize("mesh_kind", MESH_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_parity(arch, mesh_kind):
    """Every applicable cell on both production meshes: the port's
    per-device argument bytes (the dry run's own layout code,
    ``dryrun.fake_inputs``, no step) equal the sum of the reference's
    shard bytes under its Rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = configs.get(arch)
    with dryrun.fake_world(dryrun.mesh_devices(mesh_kind)):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                    device_type="cpu")
        for name, shape in SHAPES.items():
            if not applicable(cfg, shape)[0]:
                continue
            rules = Rules(cfg, mesh, sp_activations=shape.kind == "train")
            with FakeTensorMode():
                got = dryrun.storage_bytes(dryrun.fake_inputs(
                    LM(cfg), shape, rules, mesh, "cpu"))
            assert got == reference_argument_bytes(arch, name, mesh_kind), (
                arch, name, mesh_kind)


# --------------------------------------------------------------------------
# 5. fake FLOPs against real ones
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_fake_step_flops_equal_real(arch):
    """One ``train_step`` of the reduced config traced on a world-1 fake
    mesh counts the FLOPs that ``FlopCounterMode`` counts over the same
    step run for real on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.training.train_step import (TrainConfig,
                                                 init_train_state,
                                                 train_step)

    cfg = reduced(configs.get(arch))
    shape = ShapeConfig("t", 32, 4, "train")
    lm = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    state = init_train_state(lm, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    with FlopCounterMode(display=False) as counter:
        train_step(lm, TrainConfig(), state, batch)
    with dryrun.fake_world(1):
        mesh = make_host_mesh(model=1, data=1, device_type="cpu")
        cost, mem = dryrun.trace_once(
            lm, shape, mesh, Rules(cfg, mesh, sp_activations=True), "cpu")
    assert cost["flops"] == counter.get_total_flops() > 0
    assert mem["peak_bytes"] > mem["argument_bytes"] > 0


# --------------------------------------------------------------------------
# 6. one production cell end to end
# --------------------------------------------------------------------------

RECORD_KEYS = {"cell", "status", "arch", "shape", "mesh", "devices",
               "compile_s", "probe_s", "memory", "cost_scan_undercounted",
               "cost", "probes"}


def test_production_decode_cell(tmp_path):
    """Qwen2.5-3B's decode_32k on the full 16 x 16 mesh at full width and
    depth: ``ok``, the reference's record keys, the keys with no
    counterpart ``None``, the probes' combination equal to the full
    trace, and the JSON file written."""
    rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", "single",
                          out_dir=str(tmp_path), verbose=False, device="cpu")
    assert rec["status"] == "ok", rec.get("trace")
    assert set(rec) == RECORD_KEYS
    assert rec["devices"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes",
                                  "generated_code_bytes"}
    assert rec["memory"]["generated_code_bytes"] is None
    assert (rec["memory"]["peak_bytes"]
            == rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"])
    for c in (rec["cost"], rec["cost_scan_undercounted"]):
        assert c["entry_bytes"] is None and c["transcendentals"] is None
    for key in COST_KEYS:
        assert rec["cost"][key] == rec["cost_scan_undercounted"][key], key
    assert rec["cost"]["flops"] > 0 and rec["cost"]["coll_total_bytes"] > 0
    # the new cache keeps the old one's layout (batch over "data", the
    # ring over "model"), not gathered: no larger than the inputs
    assert 0 < rec["memory"]["output_bytes"] < rec["memory"][
        "argument_bytes"]
    written = json.loads((tmp_path / (rec["cell"] + ".json")).read_text())
    assert written == json.loads(json.dumps(rec))


# --------------------------------------------------------------------------
# 7. the sharded path's repairs
# --------------------------------------------------------------------------

def test_attn_out_traces_on_a_sharded_wo():
    """``attn_out`` of DTensors on a fake 16 x 16 mesh, with ``wo`` laid
    out by Rules (heads over "model", FSDP over "data"): flattening that
    ``wo`` made a strided layout whose shard sizes DTensor reads from an
    index tensor (``DataDependentOutputException`` under fake tensors);
    the contraction over (H, E) traces, and on plain tensors gives the
    flattened product's bits."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import P, distribute
    from repro_torch.models import common as cm

    cfg = configs.get("qwen2.5-3b")
    h, e, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        rules = Rules(cfg, mesh)
        spec = rules.param_specs({"blocks": {"sub0": {"attn": {
            "wo": torch.empty(1, h, e, d, device="meta")}}}})
        spec = spec["blocks"]["sub0"]["attn"]["wo"][1:]
        with FakeTensorMode():
            wo = distribute(torch.empty(h, e, d, dtype=torch.bfloat16),
                            spec, mesh)
            assert set(wo.placements) == {Shard(0), Shard(1)}
            o = distribute(torch.empty(32, 8, 2, 8, e, dtype=torch.bfloat16),
                           P("data"), mesh)
            rec = dryrun.Recorder()
            with dryrun.recording(rec):
                out = cm.attn_out({"wo": wo}, o)
            assert tuple(out.shape) == (32, 8, d)
            assert out.placements[0] == Shard(0)
            assert out.placements[1] == Replicate()
            # a device's 2 rows x 8 tokens against its one head of wo
            assert rec.flops == 2 * (2 * 8) * (h // 16) * e * d
    gen = torch.Generator().manual_seed(1)
    wo = torch.randn(h, e, d, generator=gen).to(torch.bfloat16)
    o = torch.randn(2, 3, 2, h // 2, e, generator=gen).to(torch.bfloat16)
    want = o.reshape(2, 3, h * e) @ wo.reshape(h * e, d)
    assert torch.equal(cm.attn_out({"wo": wo}, o), want)
