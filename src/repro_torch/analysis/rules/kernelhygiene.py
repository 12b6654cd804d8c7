"""RPL006 — kernel hygiene: the launcher matches its plain version and its
C entry point, and never falls back (port of
``repro.analysis.rules.kernelhygiene``).

The reference checks Pallas packages (``kernels/<name>/{ops,kernel,ref}.py``)
for signature parity with the oracle and for a real interpret path.  The
port has no interpret mode: a kernel is ``csrc/<name>.cu`` behind a
``ctypes`` launcher in ``kernels/<name>.py``, and ``auto`` picks the plain
version by the tensors' device.  Its contracts are these, each checked per
package root:

  (a) each registry entry's ``*_cuda`` launcher and ``auto`` entry exist,
      and the launcher takes its plain version's parameters — the registry
      swaps them by signature (the reference's signature parity);
  (b) every ``SIGNATURES`` entry of ``kernels/build.py`` matches the
      ``extern "C" int pp_*(...)`` prototype in ``csrc/*.cu`` in arity and
      width (pointer -> ``c_void_p``, ``int64_t`` -> ``c_int64``, ``int``
      -> ``c_int``, ``float`` -> ``c_float``), and every such prototype has
      an entry.  ``ctypes`` passes whatever ``argtypes`` says: a wrong width
      or a missing argument reaches the kernel as garbage, silently;
  (c) no fallback: no ``except`` handler in ``kernels/*.py`` or
      ``backend/registry.py`` returns, passes or calls a plain version, and
      every launcher calls ``require_cuda``, directly or through a helper
      in its module.  A launcher that quietly runs the plain version makes
      a kernel column measure PyTorch (the reference's silent-substrate
      fallback, which it guards through the interpret flag);
  (d) every registry launcher is called in the harness ``chip_smoke.py``,
      which holds each kernel against its plain version on the card.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path

from repro_torch.analysis.core import (Project, Rule, SourceFile,
                                       call_closure, chip_smoke_path,
                                       dotted_name, leaf_name, params,
                                       registry_entries, text_finding,
                                       top_defs, walk_calls)

C_TYPES = {"int64_t": "c_int64", "int": "c_int", "float": "c_float"}
PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(pp_\w+)\s*\(([^)]*)\)')


# --------------------------------------------------------------------------
# (b) the ctypes table and the C prototypes
# --------------------------------------------------------------------------

def _ctype_aliases(build: SourceFile) -> dict[str, str]:
    """Module-level names bound to ``ctypes.c_*``: ``_vp = ctypes.c_void_p``
    and ``_vp, _i64 = (ctypes.c_void_p, ctypes.c_int64)``."""
    out = {}
    for node in build.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t, v = node.targets[0], node.value
        pairs = (zip(t.elts, v.elts) if isinstance(t, ast.Tuple)
                 and isinstance(v, ast.Tuple) and len(t.elts) == len(v.elts)
                 else [(t, v)])
        for name, val in pairs:
            ct = dotted_name(val)
            if isinstance(name, ast.Name) and ct.startswith("ctypes.c_"):
                out[name.id] = ct.split(".")[-1]
    return out


def _eval_types(node: ast.AST, aliases: dict[str, str]) -> list[str] | None:
    """A ``SIGNATURES`` value (tuples of ctypes names, ``+`` and ``* n``)
    as a list of ctypes type names; None when it is not that shape."""
    if isinstance(node, ast.Tuple):
        out = []
        for e in node.elts:
            name = aliases.get(e.id) if isinstance(e, ast.Name) else (
                dotted_name(e).split(".")[-1]
                if dotted_name(e).startswith("ctypes.c_") else None)
            if name is None:
                return None
            out.append(name)
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = (_eval_types(node.left, aliases),
                _eval_types(node.right, aliases))
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        seq, n = node.left, node.right
        if isinstance(seq, ast.Constant):
            seq, n = n, seq
        a = _eval_types(seq, aliases)
        if a is None or not isinstance(n, ast.Constant) or \
                not isinstance(n.value, int):
            return None
        return a * n.value
    return None


def signature_table(build: SourceFile | None
                    ) -> dict[str, tuple[list[str] | None, int]]:
    """``SIGNATURES`` of ``kernels/build.py``: entry -> (ctypes names or
    None when unreadable, line of the entry)."""
    out: dict[str, tuple[list[str] | None, int]] = {}
    if build is None:
        return out
    aliases = _ctype_aliases(build)
    for node in build.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SIGNATURES"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out[k.value] = (_eval_types(v, aliases), k.lineno)
    return out


def _c_param_type(param: str) -> str | None:
    """``const void* ip`` -> c_void_p, ``int64_t n`` -> c_int64; None for
    a type ctypes has no entry for here."""
    if "*" in param:
        return "c_void_p"
    words = [w for w in param.replace("const", " ").split() if w]
    return C_TYPES.get(words[0]) if len(words) == 2 else None


def c_prototypes(csrc: Path) -> dict[str, tuple[list[str | None], Path, int]]:
    """``extern "C" int pp_*(...)`` in ``csrc/*.cu``: name -> (ctypes type
    per parameter, file, line)."""
    out = {}
    for p in sorted(csrc.glob("*.cu")):
        try:
            text = p.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError):
            continue
        # drop comments, keeping the line count
        text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group().count("\n"),
                      text, flags=re.S)
        text = re.sub(r"//[^\n]*", "", text)
        for m in PROTOTYPE.finditer(text):
            args = [a.strip() for a in m.group(2).split(",") if a.strip()]
            if args == ["void"]:
                args = []
            out[m.group(1)] = ([_c_param_type(a) for a in args], p,
                               text.count("\n", 0, m.start()) + 1)
    return out


# --------------------------------------------------------------------------
# (c) fallbacks
# --------------------------------------------------------------------------

def _plain_names(f: SourceFile) -> set[str]:
    """Names this module binds to plain versions: anything imported from
    a ``backend.ref`` module, and the module itself."""
    out = set()
    for node in ast.walk(f.tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[-2:] == ["backend", "ref"]:
            out.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[-1] == "backend":
            out.update(a.asname or a.name for a in node.names
                       if a.name == "ref")
    return out


def _fallback_handlers(f: SourceFile):
    plain = _plain_names(f)
    for node in ast.walk(f.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        body = ast.Module(body=node.body, type_ignores=[])
        calls_plain = any(
            dotted_name(c.func).split(".")[0] in plain
            or leaf_name(c).endswith("_plain")
            for c in walk_calls(body))
        returns = any(isinstance(n, (ast.Return, ast.Pass))
                      for n in ast.walk(body))
        if calls_plain or returns:
            yield node


class KernelHygieneRule(Rule):
    rule_id = "RPL006"
    title = "kernel hygiene"

    def check_project(self, project: Project):
        for root in project.port_roots():
            yield from self._check_root(project, root)

    def _check_root(self, project: Project, root: Path):
        reg = project.load(root / "backend" / "registry.py")
        ref = project.load(root / "backend" / "ref.py")
        build = project.load(root / "kernels" / "build.py")
        entries = registry_entries(reg)
        ref_defs = top_defs(ref) if ref is not None else {}

        # (a) the registry's pairs
        for e in entries:
            mod = project.load(root / "kernels" / f"{e.module}.py")
            defs = top_defs(mod) if mod is not None else {}
            for fn in (e.cuda, e.auto):
                if fn not in defs:
                    yield reg.finding(
                        e.line, self.rule_id,
                        f"registry entry '{e.name}' names "
                        f"kernels/{e.module}.py::{fn}, which does not exist")
            plain = ref_defs.get(e.ref)
            if plain is None:
                yield reg.finding(
                    e.line, self.rule_id,
                    f"registry entry '{e.name}' names plain version "
                    f"'{e.ref}', which backend/ref.py does not define")
            elif e.cuda in defs and params(defs[e.cuda]) != params(plain):
                yield mod.finding(
                    defs[e.cuda], self.rule_id,
                    f"launcher '{e.cuda}' takes {params(defs[e.cuda])} but "
                    f"its plain version '{e.ref}' takes {params(plain)} — "
                    "the registry swaps them by signature")

        # (b) SIGNATURES against the C prototypes
        table = signature_table(build)
        protos = c_prototypes(root / "csrc")
        for name, (types, line) in sorted(table.items()):
            proto = protos.get(name)
            if proto is None:
                yield build.finding(
                    line, self.rule_id,
                    f"SIGNATURES entry '{name}' has no extern \"C\" "
                    "prototype in csrc/*.cu")
            elif types is None:
                yield build.finding(
                    line, self.rule_id,
                    f"SIGNATURES entry '{name}' is not a tuple of ctypes "
                    "names this rule can read")
            elif len(types) != len(proto[0]):
                yield build.finding(
                    line, self.rule_id,
                    f"SIGNATURES entry '{name}' has {len(types)} arguments; "
                    f"its prototype ({proto[1].name}) has {len(proto[0])}")
            else:
                for i, (py, c) in enumerate(zip(types, proto[0])):
                    if py != c:
                        yield build.finding(
                            line, self.rule_id,
                            f"SIGNATURES entry '{name}' argument {i} is "
                            f"{py}; its prototype ({proto[1].name}) wants "
                            f"{c or 'a type ctypes is not told of'}")
        for name, (_, path, line) in sorted(protos.items()):
            if name not in table:
                yield text_finding(
                    path, project.root, line, self.rule_id,
                    f"extern \"C\" {name} has no SIGNATURES entry in "
                    "kernels/build.py — ctypes would call it with no "
                    "argtypes")

        # (c) no fallback; every launcher checks its device
        files = [reg] + [project.load(p) for p in
                         sorted((root / "kernels").glob("*.py"))]
        for f in files:
            if f is None:
                continue
            for h in _fallback_handlers(f):
                yield f.finding(
                    h, self.rule_id,
                    "except handler falls back (returns, passes or calls "
                    "a plain version) — the kernel path raises instead")
            if f.parts[-2:-1] != ("kernels",) or f.parts[-1] == "build.py":
                continue
            for name, fn in sorted(top_defs(f).items()):
                if not name.endswith("_cuda"):
                    continue
                if not any(leaf_name(c) == "require_cuda"
                           for g in call_closure(f, [fn])
                           for c in walk_calls(g)):
                    yield f.finding(
                        fn, self.rule_id,
                        f"launcher '{name}' never calls require_cuda — a "
                        "CPU tensor must raise, not run another path")

        # (d) the harness holds every launcher
        if not entries:
            return
        smoke_path = chip_smoke_path(root)
        smoke = project.load(smoke_path) if smoke_path else None
        used = set()
        if smoke is not None:
            used = {n.attr if isinstance(n, ast.Attribute) else n.id
                    for n in ast.walk(smoke.tree)
                    if isinstance(n, (ast.Attribute, ast.Name))}
        for e in entries:
            if e.cuda not in used:
                yield reg.finding(
                    e.line, self.rule_id,
                    f"launcher '{e.cuda}' is not called in chip_smoke.py — "
                    "no run holds the kernel against its plain version on "
                    "the card")
