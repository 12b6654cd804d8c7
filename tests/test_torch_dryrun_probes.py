"""The dry run's accounting probes (``repro_torch.launch.accounting``)
combined as the reference combines them, against the full-depth trace
of the same reduced configuration, for each branch of ``probe_plan``: a
(2, 2) ("data", "model") mesh over torch's fake process group of 4
ranks, fake tensors on the CPU.  The reference side is the arithmetic
itself (``tests/test_torch_dryrun.py`` holds ``probe_plan`` equal to the
reference's).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.reduced import reduced  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.accounting import probe_plan  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

COST_KEYS = ("flops",) + tuple(
    f"coll_{k}_{x}" for k in dryrun.COLLECTIVES for x in ("count", "bytes"))


# --------------------------------------------------------------------------
# the probes combined against the full trace
# --------------------------------------------------------------------------

# (arch, config overrides, (kind, S, B), bytes-accessed bound): the
# combination's bytes accessed are exact but on the SSD branch, whose
# per-chunk shard-local products' gradients grow faster than linearly in
# the chunk count (0.67 % on the production train_4k cell, a finding in
# PERF.md section 6), bounded here so that it does not grow.  The
# first-dense MoE and the hybrid run prefill to keep the file short; every
# production cell's train trace holds its FLOPs and collectives equal to
# the probes' (PERF.md section 5).
BRANCHES = {
    # dense: 3 layers = base + 2 x (blocks - base)
    "dense": ("qwen2.5-3b", dict(num_layers=3), ("train", 32, 4), 0),
    # first-dense MoE: dense0 + 3 MoE layers
    "moe_first_dense": ("deepseek-v2-236b", dict(num_layers=4),
                        ("prefill", 32, 4), 0),
    # hybrid: 3 superblocks of (rec, rec, attn)
    "hybrid": ("recurrentgemma-9b", dict(num_layers=9), ("prefill", 32, 4),
               0),
    # ssm train, the bilinear branch: 3 layers x 3 chunks of 8
    "ssm_train": ("mamba2-1.3b", dict(num_layers=3), ("train", 24, 4),
                  2e-2),
    # audio: 3 encoder and 3 decoder layers
    "audio": ("seamless-m4t-large-v2", dict(num_layers=3, enc_layers=3),
              ("prefill", 32, 4), 0),
}


@pytest.fixture(scope="module")
def fake4():
    """A fake world of 4 ranks and a (2, 2) ("data", "model") mesh."""
    with dryrun.fake_world(4):
        yield make_host_mesh(model=2, data=2, device_type="cpu")


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_probes_combined_equal_full_trace(branch, fake4):
    """For each branch of ``probe_plan`` (reduced configs made deep enough
    that the combination extrapolates): the probes' costs combined as the
    reference combines them equal the full-depth trace's, exactly: FLOPs
    and every collective's count and bytes; the probes' argument bytes
    combined alike equal the full trace's; bytes accessed as above."""
    arch, over, (kind, s, b), bytes_rel = BRANCHES[branch]
    cfg = dataclasses.replace(reduced(configs.get(arch)), **over)
    shape = ShapeConfig(kind, s, b, kind)
    _, combine = probe_plan(cfg, shape)
    traced = dryrun.trace_cell(cfg, shape, fake4,
                               {"sp_activations": kind == "train"}, {},
                               "cpu")
    full, cost = traced["full"], traced["cost"]
    for key in COST_KEYS:
        assert cost[key] == full[key], (branch, key, cost[key], full[key])
    assert cost["bytes_accessed"] == pytest.approx(
        full["bytes_accessed"], rel=bytes_rel, abs=0)
    assert full["flops"] > 0 and full["coll_total_bytes"] > 0
    mem = combine(traced["probe_memory"])
    assert mem["argument_bytes"] == traced["memory"]["argument_bytes"]
