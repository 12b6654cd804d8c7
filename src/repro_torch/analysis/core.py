"""The replint rule engine for the port: source model, findings, the
analysis loop, and the port's layout (port of ``repro.analysis.core``).

Stdlib only (``ast``, ``re``): nothing here imports ``torch``, ``jax`` or
the modules it analyses, so the lint runs where neither framework is
installed.  The finding format and the fingerprint are the reference's, so
one JSON report reads like the other.

Two rule granularities, as in the reference:

  * per-file  — ``Rule.check_file(SourceFile)`` visits one parsed module;
  * project   — ``Rule.check_project(Project)`` sees the whole analysed
    file set at once.

The reference's cross-file rules find their counterparts beside the file
they anchor on.  The port's contracts span one package, so the project
rules work per *port root*: the nearest ancestor of an analysed file that
holds ``kernels/build.py``.  From there they load ``backend/registry.py``,
``backend/ref.py``, ``kernels/build.py``, ``csrc/*.cu`` and the harness
``chip_smoke.py`` whether or not those are in the analysed set
(``--changed-only`` may hand a rule one side of its contract only).

Findings carry a content fingerprint (rule | path | source-line text) so
the suppression baseline survives unrelated line-number drift but expires
the moment the suppressed line itself changes.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
from pathlib import Path
from typing import Iterable, Iterator


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One structured violation: ``path:line RPLnnn message``."""

    path: str      # posix path, relative to the analysis root
    line: int      # 1-based
    rule: str      # "RPL001".."RPL007"
    message: str
    snippet: str = ""   # stripped source line, fingerprint input

    @property
    def fingerprint(self) -> str:
        """Stable identity for baseline matching: immune to line-number
        drift, invalidated when the flagged line's text changes."""
        key = f"{self.rule}|{self.path}|{self.snippet}"
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dict(path=self.path, line=self.line, rule=self.rule,
                    message=self.message, fingerprint=self.fingerprint)


def rel_path(path: Path, root: Path) -> str:
    """``path`` relative to ``root`` (posix), or as given when outside."""
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def text_finding(path: Path, root: Path, line: int, rule: str,
                 message: str) -> Finding:
    """A finding in a file that is not Python (``csrc/*.cu``) or that does
    not exist (a missing hot root's module): the snippet is the line's text,
    or empty."""
    try:
        lines = path.read_text(encoding="utf-8").splitlines()
    except (OSError, UnicodeDecodeError):
        lines = []
    snippet = lines[line - 1].strip() if 1 <= line <= len(lines) else ""
    return Finding(path=rel_path(path, root), line=line, rule=rule,
                   message=message, snippet=snippet)


@dataclasses.dataclass
class SourceFile:
    """One parsed module: path (relative, posix), text, AST, lines."""

    path: str
    text: str
    tree: ast.Module
    abspath: Path

    @property
    def lines(self) -> list[str]:
        return self.text.splitlines()

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    @property
    def parts(self) -> tuple[str, ...]:
        """Path segments — rules scope themselves by directory name
        (``nf``, ``switchsim``, ``kernels``, ``tests``, ...), which works
        identically for the real tree and for test fixture trees."""
        return tuple(Path(self.path).parts)

    def in_dir(self, *names: str) -> bool:
        return any(n in self.parts[:-1] for n in names)

    @property
    def is_test(self) -> bool:
        base = self.parts[-1]
        return base.startswith("test_") or base == "conftest.py" or \
            self.in_dir("tests")

    def finding(self, node: ast.AST | int, rule: str, message: str) -> Finding:
        line = node if isinstance(node, int) else node.lineno
        return Finding(path=self.path, line=line, rule=rule, message=message,
                       snippet=self.line_at(line))


@dataclasses.dataclass
class Project:
    """The analysed file set plus the root they are relative to."""

    root: Path
    files: list[SourceFile]

    def find(self, *suffixes: str) -> SourceFile | None:
        """First analysed file whose path ends with one of ``suffixes``
        (posix, e.g. ``"switchsim/engine.py"``)."""
        for sfx in suffixes:
            for f in self.files:
                if f.path == sfx or f.path.endswith("/" + sfx):
                    return f
        return None

    def load(self, path: Path) -> SourceFile | None:
        """The module at ``path``: the analysed copy when it is in the set,
        else parsed from disk; None when absent or unparsable."""
        target = path.resolve()
        for f in self.files:
            if f.abspath == target:
                return f
        return parse_file(target, self.root)

    def load_sibling(self, anchor: SourceFile,
                     relpath: str) -> SourceFile | None:
        """Load a file located relative to ``anchor``'s directory, whether
        or not it is part of the analysed set."""
        return self.load(anchor.abspath.parent / relpath)

    def port_roots(self) -> list[Path]:
        """Package roots of the port that the analysed files lie in."""
        return sorted({r for r in map(port_root, self.files) if r})


def port_root(f: SourceFile) -> Path | None:
    """The nearest ancestor of ``f`` holding ``kernels/build.py``."""
    for d in f.abspath.parents:
        if (d / "kernels" / "build.py").is_file():
            return d
    return None


class Rule:
    """Base class: subclasses set ``rule_id``/``title`` and override one
    or both check methods.  Rules must never raise on weird-but-valid
    code — a rule that cannot decide stays silent (lint, not a verifier)."""

    rule_id: str = "RPL000"
    title: str = ""

    def check_file(self, f: SourceFile) -> Iterable[Finding]:
        return ()

    def check_project(self, project: Project) -> Iterable[Finding]:
        return ()


def parse_file(path: Path, root: Path) -> SourceFile | None:
    try:
        text = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError):
        return None
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError:
        return None
    return SourceFile(path=rel_path(path, root), text=text, tree=tree,
                      abspath=path.resolve())


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py") if q.is_file())
        elif p.suffix == ".py" and p.is_file():
            yield p


def load_project(paths: Iterable[str | Path],
                 root: str | Path | None = None) -> Project:
    """Parse every .py under ``paths`` into a Project.  ``root`` anchors
    the relative paths findings report (default: cwd)."""
    rootp = Path(root) if root is not None else Path.cwd()
    files = []
    for p in iter_py_files(Path(p) for p in paths):
        sf = parse_file(p, rootp)
        if sf is not None:
            files.append(sf)
    return Project(root=rootp, files=files)


def analyze(project: Project, rules: Iterable[Rule]) -> list[Finding]:
    """Run every rule over the project; findings sorted by location."""
    findings: list[Finding] = []
    for rule in rules:
        for f in project.files:
            findings.extend(rule.check_file(f))
        findings.extend(rule.check_project(project))
    return sorted(set(findings))


# --------------------------------------------------------------------------
# Shared AST helpers used by several rules
# --------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> str:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; "" when not
    a plain dotted path."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def leaf_name(call: ast.Call) -> str:
    """The called name's last segment, also for ``f(x).g()`` chains."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return ""


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def walk_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def own_calls(fn: ast.FunctionDef) -> Iterator[ast.Call]:
    """Calls in ``fn``'s own body, not in the ``def``s nested in it."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        n = todo.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(n, ast.Call):
            yield n
        todo.extend(ast.iter_child_nodes(n))


def func_defs(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n


def params(fn: ast.FunctionDef) -> list[str]:
    """Parameter names in order, ``*args``/``**kw`` as written."""
    a = fn.args
    out = [x.arg for x in a.posonlyargs + a.args]
    if a.vararg:
        out.append("*" + a.vararg.arg)
    out += [x.arg for x in a.kwonlyargs]
    if a.kwarg:
        out.append("**" + a.kwarg.arg)
    return out


def top_defs(f: SourceFile) -> dict[str, ast.FunctionDef]:
    """Module-level functions by name."""
    return {n.name: n for n in f.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def qualified_def(f: SourceFile, qualname: str) -> ast.FunctionDef | None:
    """``"name"`` or ``"Class.method"`` at module level, else None."""
    head, _, tail = qualname.partition(".")
    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
    for n in f.tree.body:
        if tail and isinstance(n, ast.ClassDef) and n.name == head:
            for sub in n.body:
                if isinstance(sub, fn_types) and sub.name == tail:
                    return sub
        if not tail and isinstance(n, fn_types) and n.name == head:
            return n
    return None


def call_closure(f: SourceFile, roots: Iterable[ast.FunctionDef]
                 ) -> list[ast.FunctionDef]:
    """``roots`` closed over what they run in this module: nested ``def``s,
    module-level functions called by bare name, and ``self.<m>()`` methods
    of the class that defines the calling method."""
    top = top_defs(f)
    owner: dict[int, ast.ClassDef] = {}
    for cls in f.tree.body:
        if isinstance(cls, ast.ClassDef):
            for sub in ast.walk(cls):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    owner[id(sub)] = cls
    out: list[ast.FunctionDef] = []
    seen: set[int] = set()
    todo = list(roots)
    while todo:
        fn = todo.pop(0)
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        cls = owner.get(id(fn))
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub is not fn:
                todo.append(sub)
            if not isinstance(sub, ast.Call):
                continue
            if isinstance(sub.func, ast.Name) and sub.func.id in top:
                todo.append(top[sub.func.id])
            elif cls is not None and isinstance(sub.func, ast.Attribute) \
                    and dotted_name(sub.func.value) == "self":
                m = qualified_def(f, f"{cls.name}.{sub.func.attr}")
                if m is not None:
                    todo.append(m)
    return out


# --------------------------------------------------------------------------
# The port's layout, read from its own files
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    """One ``Primitive("<name>", R.<ref>, _kernel("<mod>", "<cuda>"),
    _kernel("<mod>", "<auto>"))`` call of ``backend/registry.py``."""

    name: str
    ref: str        # the plain version's name in backend/ref.py
    module: str     # kernels/<module>.py
    cuda: str       # the kernel launcher
    auto: str       # the device-resolved entry
    line: int


def registry_entries(registry: SourceFile | None) -> list[RegistryEntry]:
    """The registry's primitives, in order; calls of another shape are
    skipped (the rule stays silent on what it cannot read)."""
    out = []
    if registry is None:
        return out
    for call in walk_calls(registry.tree):
        if dotted_name(call.func) != "Primitive" or len(call.args) != 4:
            continue
        name, ref, cuda, auto = call.args
        kernels = [(str_const(k.args[0]), str_const(k.args[1]))
                   for k in (cuda, auto)
                   if isinstance(k, ast.Call) and len(k.args) == 2
                   and dotted_name(k.func) == "_kernel"]
        if str_const(name) is None or not isinstance(ref, ast.Attribute) \
                or len(kernels) != 2 or None in kernels[0] + kernels[1]:
            continue
        out.append(RegistryEntry(
            name=str_const(name), ref=ref.attr, module=kernels[0][0],
            cuda=kernels[0][1], auto=kernels[1][1], line=call.lineno))
    return out


def module_strings(f: SourceFile | None, name: str) -> tuple[str, ...] | None:
    """The string constants of a module-level ``NAME = ("a", "b", ...)``."""
    if f is None:
        return None
    for node in f.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets) and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [str_const(e) for e in node.value.elts]
            if None not in vals:
                return tuple(vals)
    return None


def chip_smoke_path(root: Path) -> Path | None:
    """The harness that drives every kernel: beside the package, or at the
    repository root of the ``src/`` layout."""
    for cand in (root / "chip_smoke.py", root.parent.parent / "chip_smoke.py"):
        if cand.is_file():
            return cand
    return None
