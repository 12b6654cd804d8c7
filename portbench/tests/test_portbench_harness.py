"""The harness on the CPU: a cell added as data files runs and proves
correct; with the timed path broken underneath, ``correct`` comes out
false; a run loads neither JAX nor the JAX package; ``BENCHMARK.json``
keeps the contract's names and units; on a card, a short run of each
cell."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.fixtures import ROOT

FIXTURES = ("fixture_pod_fw_nat.fixture_enterprise",
            "fixture_pod_chain_dc.fixture_datacenter")


def _run(root, cell, seed=2**31 + 3, trace=False):
    return harness.run_cell(cell, seed, 1.0, trace, "cpu",
                            time.perf_counter(), root=root,
                            log=lambda *a: None)


@pytest.mark.parametrize("cell", FIXTURES)
def test_a_cell_added_as_files_runs_and_proves_correct(fixture_root, cell):
    out = _run(fixture_root, cell)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"pkts_per_s", "run_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert all(v == dict(value=0, limit=0) for v in out["checks"].values())


def test_traced_run_on_the_cpu_reads_no_device_metric(fixture_root):
    """Without a card the trace holds no device event: every reader
    returns nothing and no device number is printed."""
    out = _run(fixture_root, FIXTURES[0], trace=True)
    assert out["correct"] is True
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] == 0.0


def _frozen_state(monkeypatch, engine):
    """A step that returns the switch state it was given."""
    real = engine.scan_step

    def scan_step(*args, **kw):
        step = real(*args, **kw)

        def frozen(carry, xs, drain):
            new, ys = step(carry, xs, drain)
            return (carry[0],) + tuple(new[1:]), ys
        return frozen
    monkeypatch.setattr(engine, "scan_step", scan_step)


def _half_batch(monkeypatch, engine):
    """Split sees the first half of each chunk's packets alone."""
    real = engine.split_fn

    def split_fn(cfg, state, pkts, backend=None):
        b = pkts.alive.shape[-1]
        keep = torch.arange(b, device=pkts.alive.device) < b // 2
        return real(cfg, state, pkts.replace(alive=pkts.alive & keep),
                    backend=backend)
    monkeypatch.setattr(engine, "split_fn", split_fn)


def _altered_answer(monkeypatch, engine):
    """Merge flips one payload byte of each merged chunk's first row."""
    real = engine.merge_fn

    def merge_fn(cfg, state, pkts, backend=None):
        state, out = real(cfg, state, pkts, backend=backend)
        payload = out.payload.clone()
        payload[..., 0, 0] ^= 1
        return state, out.replace(payload=payload)
    monkeypatch.setattr(engine, "merge_fn", merge_fn)


@pytest.mark.parametrize("fault", (_frozen_state, _half_batch,
                                   _altered_answer))
@pytest.mark.parametrize("cell", FIXTURES)
def test_a_broken_timed_path_is_not_correct(fixture_root, monkeypatch, cell,
                                            fault):
    from repro_torch.switchsim import engine

    fault(monkeypatch, engine)
    out = _run(fixture_root, cell)
    assert out["correct"] is False
    assert out["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in out["checks"].values())


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(fixture_root):
    code = ("import time, pathlib\n"
            "from portbench import harness\n"
            f"root = pathlib.Path({str(fixture_root)!r})\n"
            f"for cell in {list(FIXTURES)!r}:\n"
            "    out = harness.run_cell(cell, 5, 0.05, False, 'cpu',"
            " time.perf_counter(), root=root, log=lambda *a: None)\n"
            "    assert out['correct'], out\n")
    loaded = _modules_after(code)
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    loaded = _modules_after("import portbench.reference.dataplane")
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract_names():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for m in spec["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for w in spec["workloads"]:
        assert f"{w['config']}.{w['traffic']}" == w["name"]
        assert (ROOT / "portbench" / "traffic" /
                f"{w['traffic']}.json").exists()
    assert 0 < 1 <= spec["run_seconds"] <= 51


@pytest.mark.card
@pytest.mark.parametrize("cell", ("pod_fw_nat.enterprise",
                                  "pod_chain_dc.datacenter"))
def test_a_short_run_of_each_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
