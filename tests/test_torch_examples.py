"""The port's twins of the reference's examples run end to end on the CPU
(``--device cpu``), checked on the output lines the reference's own
example tests check (``tests/test_system.py``)."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, os.path.join(REPO, "examples", name),
                        "--device", "cpu"],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_torch_quickstart_example_runs():
    assert "functional equivalence: OK" in _run("torch_quickstart.py")


def test_torch_parked_decode_example_runs():
    out = _run("torch_parked_decode.py")
    assert "goodput gain" in out
    # the reference example's counters on the same reduced Gemma-7B flow
    assert "explicit_drops         2" in out
    assert "premature_evictions    0" in out
