"""RPL002 — engine≡loop structural parity (port of
``repro.analysis.rules.parity``; the contract and the checks are the
reference's, because the port kept the shape of both halves).

The scanned engine (``engine.py``) and the host-side reference loop
(``simulate.py``) are the two halves of the repo's bit-exactness oracle:
every counter the engine bumps and every ``LinkTelemetry`` field it tallies
must be mirrored by the loop, or the oracle silently stops covering that
quantity.  The runtime tests only catch a divergence in the VALUES; this
rule catches the structural half — adding a counter or telemetry field to
one side without the other now fails lint, not review.

On the port the engine is ``switchsim/engine.py``'s step body (its
``C.bump(..., "recirc_budget_drops" | "fault_drops", ...)`` and the
``ys = dict(...)`` it returns each step) and the loop is
``simulate.py``'s ``simulate_loop`` and ``_simulate_loop_recirc``.

For every analyzed ``engine.py`` with a sibling ``simulate.py``:

  * the set of counter names bumped (``C.bump(..., "name", ...)``) in
    ``engine.py`` must equal the set bumped inside ``simulate.py``'s loop
    functions (any ``def`` whose name contains ``loop``);
  * the telemetry keys the engine surfaces in its per-step ``ys`` and the
    keys the loop accumulates (``tel["name"] += ...``) must each cover the
    ``LinkTelemetry`` field set (sibling ``telemetry.py``), and neither
    side may write a ``*_pkts``/``*_bytes`` key the struct does not carry.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (Project, Rule, SourceFile,
                                       dotted_name, str_const, walk_calls)


def bumped_counters(tree: ast.AST) -> dict[str, int]:
    """name -> first line for every ``...bump(..., "name", ...)`` call."""
    out: dict[str, int] = {}
    for call in walk_calls(tree):
        if dotted_name(call.func).split(".")[-1] != "bump":
            continue
        for arg in call.args:
            s = str_const(arg)
            if s is not None:
                out.setdefault(s, call.lineno)
                break
    return out


def loop_functions(f: SourceFile) -> list[ast.FunctionDef]:
    return [n for n in ast.walk(f.tree)
            if isinstance(n, ast.FunctionDef) and "loop" in n.name]


def engine_ys_keys(f: SourceFile) -> dict[str, int]:
    """Telemetry keys the engine's scan surfaces: keywords of a ``dict(...)``
    assigned to ``ys`` plus ``ys["key"] = ...`` stores."""
    out: dict[str, int] = {}
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets if isinstance(t, ast.Name)]
            if any(t.id == "ys" for t in targets) and \
                    isinstance(node.value, ast.Call) and \
                    dotted_name(node.value.func) == "dict":
                for kw in node.value.keywords:
                    if kw.arg:
                        out.setdefault(kw.arg, kw.value.lineno)
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name) and t.value.id == "ys":
                    key = str_const(t.slice)
                    if key:
                        out.setdefault(key, node.lineno)
    return out


def loop_tel_keys(fns: list[ast.FunctionDef]) -> dict[str, int]:
    """Keys of ``tel["name"] += ...`` accumulations across loop functions."""
    out: dict[str, int] = {}
    for fn in fns:
        for node in ast.walk(fn):
            target = None
            if isinstance(node, ast.AugAssign):
                target = node.target
            elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                target = node.targets[0]
            if isinstance(target, ast.Subscript) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id == "tel":
                key = str_const(target.slice)
                if key:
                    out.setdefault(key, node.lineno)
    return out


def tel_fields(f: SourceFile | None) -> set[str]:
    """Field names of the LinkTelemetry dataclass in telemetry.py."""
    if f is None:
        return set()
    for node in ast.walk(f.tree):
        if isinstance(node, ast.ClassDef) and node.name == "LinkTelemetry":
            return {s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)}
    return set()


def _looks_telemetry(key: str) -> bool:
    return key.endswith("_pkts") or key.endswith("_bytes")


class ParityRule(Rule):
    rule_id = "RPL002"
    title = "engine/loop structural parity"

    def check_project(self, project: Project):
        for eng in project.files:
            if eng.parts[-1] != "engine.py":
                continue
            sim = project.load_sibling(eng, "simulate.py")
            if sim is None:
                continue
            loops = loop_functions(sim)
            if not loops:
                continue

            eng_ctr = bumped_counters(eng.tree)
            loop_ctr: dict[str, int] = {}
            for fn in loops:
                for k, v in bumped_counters(fn).items():
                    loop_ctr.setdefault(k, v)
            for name in sorted(set(eng_ctr) - set(loop_ctr)):
                yield eng.finding(
                    eng_ctr[name], self.rule_id,
                    f"engine bumps counter '{name}' but no simulate.py loop "
                    "function mirrors it — the engine≡loop oracle no "
                    "longer covers this counter")
            for name in sorted(set(loop_ctr) - set(eng_ctr)):
                yield sim.finding(
                    loop_ctr[name], self.rule_id,
                    f"loop bumps counter '{name}' but engine.py does not — "
                    "the engine≡loop oracle no longer covers this "
                    "counter")

            fields = tel_fields(project.load_sibling(eng, "telemetry.py"))
            if not fields:
                continue
            ys = engine_ys_keys(eng)
            tel = loop_tel_keys(loops)
            for name in sorted(fields - set(ys)):
                yield eng.finding(
                    1, self.rule_id,
                    f"LinkTelemetry field '{name}' is never surfaced in the "
                    "engine's ys")
            for name in sorted(fields - set(tel)):
                yield sim.finding(
                    1, self.rule_id,
                    f"LinkTelemetry field '{name}' is never accumulated by "
                    "any simulate.py loop function")
            for name in sorted(k for k in ys
                               if _looks_telemetry(k) and k not in fields):
                yield eng.finding(
                    ys[name], self.rule_id,
                    f"engine surfaces telemetry-shaped ys key '{name}' that "
                    "is not a LinkTelemetry field — add the field or rename")
            for name in sorted(k for k in tel
                               if _looks_telemetry(k) and k not in fields):
                yield sim.finding(
                    tel[name], self.rule_id,
                    f"loop accumulates telemetry key '{name}' that is not a "
                    "LinkTelemetry field — add the field or rename")
