"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package, and no module of it imports either."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_serving_modules_are_among_those_checked():
    """The serving slice's modules are imported by the subprocess check
    above and parsed by the AST check below."""
    mods = set(_modules())
    assert {"repro_torch.serving.pool", "repro_torch.serving.engine",
            "repro_torch.launch.serve", "repro_torch.models.common",
            "repro_torch.models.lm", "repro_torch.kernels.paged_attention",
            "repro_torch.configs.base", "repro_torch.configs.reduced",
            "repro_torch.configs.qwen2_5_3b"} <= mods


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_reference(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_kernel_sources_present_for_every_kernel_module():
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.build import SOURCES
    assert sorted(SOURCES) == sorted(f"{k}.cu" for k in KERNELS)
    for src in SOURCES:
        text = (PKG / "csrc" / src).read_text()
        assert "Replaces the TPU kernel" in text and "Bound:" in text
        assert 'extern "C" int pp_' in text
        assert "cudaGetLastError()" in text
