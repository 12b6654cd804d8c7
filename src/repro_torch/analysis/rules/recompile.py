"""RPL004 — one compiled program per configuration (port of
``repro.analysis.rules.recompile``).

The reference guards the jit boundary: static args must be hashable and
immutable, and a ``.shape`` formatted inside a traced function bakes one
shape into the trace.  The port has no trace, so the f-string half has no
counterpart (the kernel wrappers format shapes into their error messages on
purpose).  Its compiled program is the kernel library instead: ``nvcc``
builds ``csrc/*`` once into a shared library whose cache key is a digest of
``kernels/build.py``'s ``SOURCES`` and ``HEADERS``.

Flags:

  * a ``@dataclasses.dataclass`` class whose name ends in ``Config`` or
    ``Spec`` that is not declared ``frozen=True`` — the reference's check,
    unchanged: those classes are cache keys and shared settings, and a
    mutable one is unhashable or changes under its users' feet;
  * a file in ``csrc/`` that is listed in neither ``SOURCES`` nor
    ``HEADERS``: the digest does not cover it, so an edit to it reuses a
    stale library (or, for a ``.cu``, the kernel is never built);
  * ``ctypes.CDLL`` (and ``PyDLL``/``LoadLibrary``), an ``nvcc``
    subprocess or ``torch.utils.cpp_extension.load*`` outside
    ``kernels/build.py``: a second loader builds or loads outside the
    cache and can run a library other than the one the digest names.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (Project, Rule, SourceFile, dotted_name,
                                       module_strings, parse_file, str_const,
                                       text_finding, walk_calls)

STATIC_SUFFIXES = ("Config", "Spec")
LOADERS = ("CDLL", "PyDLL", "LoadLibrary")
SUBPROCESS = ("subprocess.run", "subprocess.Popen", "subprocess.call",
              "subprocess.check_call", "subprocess.check_output", "os.system")


def _dataclass_decorator(cls: ast.ClassDef) -> ast.AST | None:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if dotted_name(target).split(".")[-1] == "dataclass":
            return dec
    return None


def _frozen_true(dec: ast.AST) -> bool:
    if not isinstance(dec, ast.Call):
        return False    # bare @dataclass
    for kw in dec.keywords:
        if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _is_build_module(f: SourceFile) -> bool:
    return f.parts[-2:] == ("kernels", "build.py")


def _cpp_extension_names(tree: ast.AST) -> set[str]:
    """Bare names bound by ``from torch.utils.cpp_extension import load``."""
    return {a.asname or a.name for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom)
            and (n.module or "").endswith("cpp_extension")
            for a in n.names if a.name.startswith("load")}


def _runs_nvcc(call: ast.Call) -> bool:
    for node in ast.walk(call):
        s = str_const(node)
        if s is not None and "nvcc" in s:
            return True
        if isinstance(node, ast.Call) and \
                dotted_name(node.func).split(".")[-1] == "nvcc_path":
            return True
    return False


def _loader(call: ast.Call, ext_names: set[str]) -> str | None:
    name = dotted_name(call.func)
    leaf = name.split(".")[-1]
    if leaf in LOADERS and "ctypes" in name.split("."):
        return name
    if ("cpp_extension" in name.split(".") and leaf.startswith("load")) or \
            name in ext_names:
        return name
    if name in SUBPROCESS and _runs_nvcc(call):
        return f"{name}(nvcc ...)"
    return None


class RecompileRule(Rule):
    rule_id = "RPL004"
    title = "one compiled program per configuration"

    def check_file(self, f: SourceFile):
        if f.is_test:
            return
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not node.name.endswith(STATIC_SUFFIXES):
                continue
            dec = _dataclass_decorator(node)
            if dec is not None and not _frozen_true(dec):
                yield f.finding(
                    node, self.rule_id,
                    f"dataclass '{node.name}' is not frozen=True — "
                    "*Config/*Spec classes are cache keys and shared "
                    "settings and must be hashable and immutable")
        if _is_build_module(f):
            return
        ext_names = _cpp_extension_names(f.tree)
        for call in walk_calls(f.tree):
            what = _loader(call, ext_names)
            if what is not None:
                yield f.finding(
                    call, self.rule_id,
                    f"{what} outside kernels/build.py builds or loads a "
                    "kernel library outside the digest-keyed cache — go "
                    "through build.library()")

    def check_project(self, project: Project):
        for root in project.port_roots():
            build = parse_file(root / "kernels" / "build.py", project.root)
            listed = set((module_strings(build, "SOURCES") or ())
                         + (module_strings(build, "HEADERS") or ()))
            csrc = root / "csrc"
            if build is None or not csrc.is_dir():
                continue
            for p in sorted(csrc.iterdir()):
                if p.is_file() and p.name not in listed:
                    yield text_finding(
                        p, project.root, 1, self.rule_id,
                        f"csrc/{p.name} is in neither SOURCES nor HEADERS "
                        "of kernels/build.py — the build digest does not "
                        "cover it, so an edit to it reuses a stale library")
