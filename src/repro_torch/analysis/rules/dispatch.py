"""RPL001 — hot-path primitive math must flow through the backend registry
(port of ``repro.analysis.rules.dispatch``).

The contract is the reference's (DESIGN.md §9): every per-packet primitive
is implemented once as a plain version in ``backend/ref.py`` and once as a
kernel launcher in ``kernels/<module>.py``, and every dataplane call site
reaches it through ``registry.dispatch(name, backend)``.  A direct import
or call bypasses the backend axis: that stage runs one implementation
whatever the caller chose, and a launch count taken on the main path no
longer says which kernels the path ran.

The reference lists its primitives by hand.  Here the set is read from
``backend/registry.py`` itself, from its ``Primitive("<name>", R.<ref>,
_kernel("<mod>", "<launcher>"), _kernel("<mod>", "<auto>"))`` calls: the
plain versions, the ``*_cuda`` launchers and the ``auto`` entries, plus
the helpers ``backend/ref.py`` builds them from (``HELPERS``, where ref.py
defines them).  A new primitive is covered without editing this rule.

Flags, in dataplane modules (everything except ``backend/``, ``kernels/``,
``analysis/`` and test files; the harness ``chip_smoke.py`` calls the
launchers on purpose and is not in the port's scope):

  * importing one of those functions, or any ``*_cuda`` name, from a
    ``backend`` or ``kernels`` module (ALL_CAPS constants and the NF state
    types stay importable);
  * calls whose terminal name is one of them when the module does not
    define it locally.

A call carrying a ``backend=`` keyword is exempt: that is the signature of
the sanctioned dispatch-routed wrappers (``core/header.crc16_tag`` routes
through ``registry.dispatch`` and threads the caller's backend).
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.core import (Project, Rule, SourceFile,
                                       dotted_name, func_defs, parse_file,
                                       port_root, registry_entries,
                                       top_defs, walk_calls)

# The byte-level helpers backend/ref.py builds crc16_tag and maglev_select
# from; they are primitives' math without being registry entries.
HELPERS = ("crc16_bytes", "tag_bytes", "maglev_hash5")

# Modules allowed to touch primitives directly: the implementations
# themselves, their kernels, the tests that assert cross-impl parity, and
# this analyser.
EXEMPT_DIRS = ("backend", "kernels", "analysis", "tests")


def _scoped(f: SourceFile) -> bool:
    return not (f.in_dir(*EXEMPT_DIRS) or f.is_test
                or f.parts[-1] == "chip_smoke.py")


def primitive_names(root: Path) -> frozenset[str]:
    """Every function name the registry under ``root`` makes a primitive,
    with the ``backend/ref.py`` helpers it is built from."""
    reg = parse_file(root / "backend" / "registry.py", root)
    names: set[str] = set()
    for e in registry_entries(reg):
        names.update((e.ref, e.cuda, e.auto))
    ref = parse_file(root / "backend" / "ref.py", root)
    if ref is not None:
        names.update(h for h in HELPERS if h in top_defs(ref))
    return frozenset(names)


class DispatchRule(Rule):
    rule_id = "RPL001"
    title = "primitive math outside the backend dispatch"

    def check_project(self, project: Project):
        names: dict[Path, frozenset[str]] = {}
        for f in project.files:
            root = port_root(f) if _scoped(f) else None
            if root is None:
                continue
            if root not in names:
                names[root] = primitive_names(root)
            yield from self._check(f, names[root])

    def _check(self, f: SourceFile, prims: frozenset[str]):
        local_defs = {n.name for n in func_defs(f.tree)}
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    ("backend" in node.module.split(".")
                     or "kernels" in node.module.split(".")):
                for alias in node.names:
                    if alias.name in prims or alias.name.endswith("_cuda"):
                        yield f.finding(
                            node, self.rule_id,
                            f"imports primitive '{alias.name}' from "
                            f"'{node.module}' — dataplane call sites must "
                            "use registry.dispatch (constants are fine)")
        for call in walk_calls(f.tree):
            name = dotted_name(call.func)
            leaf = name.split(".")[-1] if name else ""
            if leaf in prims and leaf not in local_defs and \
                    not any(kw.arg == "backend" for kw in call.keywords):
                yield f.finding(
                    call, self.rule_id,
                    f"direct call to primitive '{leaf}' — route through "
                    "registry.dispatch so the backend axis covers this "
                    "stage")
