"""Fixtures of the benchmark's own tests.

Run them from the repository's root on the CPU:

    PYTHONPATH=src:. python -m pytest -q -p no:cacheprovider portbench/tests

Tests marked ``card`` need a CUDA card; they skip without one (decided in
the ``card`` fixture, never at import).
"""
from __future__ import annotations

import json
import shutil
import pytest
import torch

from portbench.tests.fixtures import ROOT, tiny, tiny_mix


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


@pytest.fixture
def fixture_root(tmp_path):
    """A throwaway benchmark root: the real metric readers, plus a fixture
    configuration and mix added as files and entries alone, as a later
    cell is added."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench" / "metrics", bench / "metrics")
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg_name, mix_name in (("pod_fw_nat", "enterprise"),
                               ("pod_chain_dc", "datacenter")):
        fixture = f"fixture_{cfg_name}"
        (bench / "configs" / f"{fixture}.json").write_text(
            json.dumps(tiny(cfg_name, name=fixture)))
        (bench / "traffic" / f"fixture_{mix_name}.json").write_text(
            json.dumps(tiny_mix(mix_name)))
        spec["configs"].append(dict(
            name=fixture, source="https://arxiv.org/abs/2006.05182",
            file=f"portbench/configs/{fixture}.json", reduced=["pipes"],
            why="a test fixture"))
        cell = f"{fixture}.fixture_{mix_name}"
        spec["workloads"].append(dict(
            name=cell, config=fixture, traffic=f"fixture_{mix_name}",
            chips=1, why="a test fixture"))
        for m in spec["per_layer"]:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
