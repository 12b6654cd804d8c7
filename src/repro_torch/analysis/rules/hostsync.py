"""RPL005 — host synchronisation on the hot path (port of
``repro.analysis.rules.hostsync``).

The seed simulator paid a device->host round trip per chunk
(``int(jnp.sum(...))`` byte tallies); the engine exists to remove exactly
that.  On the port a ``.item()``, a ``.cpu()`` or an ``int()`` of a tensor
waits for the card, so inside the per-step path it serialises the host and
the device: the step's kernels no longer queue ahead of the host.

The reference finds its hot code from the trace (``jax.jit``, ``lax.scan``
bodies, ``shard_map``).  The port has no trace, so the hot functions are
named here (``HOT_ROOTS``, relative to the package root) and closed over
what they run in their module: nested ``def``s, module-level functions
called by bare name, and ``self.`` methods of the same class.  Every
public function of ``kernels/<name>.py`` (not ``build.py``) is a root too:
the launchers and their planners run once per call of a primitive.  A
root the tree no longer has is itself a finding, so a rename cannot leave
the rule with nothing to check.

Flags, inside hot functions:

  * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``
    (``torch.cuda.synchronize`` included) — a wait for the card;
  * ``nonzero``, ``unique``, ``masked_select`` and one-argument
    ``torch.where`` — their output size depends on the data, so the host
    waits to learn it;
  * ``np.*(...)`` — numpy on a tensor copies it to the host;
  * ``int(...)`` / ``float(...)`` / ``bool(...)`` of a call, subscript,
    operator or comparison, unless the argument is built only from host
    values: constants, ``.shape``, ``.size()``, ``.numel()``, ``.dim()``,
    ``.stride()``, ``.data_ptr()``, ``len()``, parameters annotated
    ``int``/``float``/``bool``, and local names assigned from these.

Out of scope:

  * the plain versions in ``backend/ref.py``: they are the CPU path and the
    tests' reference; on a card the registry runs the kernels instead;
  * the serving engine's per-token bookkeeping (``serving/engine.py``):
    like the reference's host-side engine it reads each sequence's length
    and token on the host every step (about 20 ``int(...)`` per token
    step).  Moving that onto the card is ROADMAP Queue B item 1, not a
    lint exemption.
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.core import (Finding, Project, Rule, SourceFile,
                                       call_closure, dotted_name, leaf_name,
                                       own_calls, qualified_def,
                                       text_finding, top_defs)

HOT_ROOTS = (
    ("switchsim/engine.py", "scan_step"),
    ("switchsim/engine.py", "_ShardRun.step"),
    ("core/park.py", "split_fn"),
    ("core/park.py", "recirc_fn"),
    ("core/park.py", "merge_fn"),
    ("nf/chain.py", "NF.__call__"),
    ("nf/chain.py", "Chain.run"),
)
SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")
DATA_SIZED = ("nonzero", "unique", "masked_select")
HOST_METHODS = ("size", "numel", "dim", "stride", "data_ptr")
HOST_FUNCS = ("len", "min", "max", "abs", "round", "int", "float", "bool")
HOST_TYPES = ("int", "float", "bool")


def _host_only(node: ast.AST, names: set[str]) -> bool:
    """True when ``node`` is built only from host values."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr == "shape" or _host_only(node.value, names)
    if isinstance(node, ast.Call):
        leaf = leaf_name(node)
        if isinstance(node.func, ast.Attribute) and leaf in HOST_METHODS:
            return True
        if dotted_name(node.func) in HOST_FUNCS or \
                dotted_name(node.func).startswith("math."):
            return all(_host_only(a, names) for a in node.args)
        return False
    if isinstance(node, (ast.Subscript, ast.BinOp, ast.UnaryOp, ast.BoolOp,
                         ast.Compare, ast.IfExp, ast.Tuple, ast.Slice)):
        return all(_host_only(c, names) for c in ast.iter_child_nodes(node)
                   if not isinstance(c, (ast.operator, ast.unaryop,
                                         ast.boolop, ast.cmpop,
                                         ast.expr_context)))
    return False


def _target_names(t: ast.AST) -> list[str]:
    return [n.id for n in ast.walk(t) if isinstance(n, ast.Name)]


def host_names(fn: ast.FunctionDef) -> set[str]:
    """Names that hold host values in ``fn``: parameters annotated as
    Python scalars, and locals assigned only from host values."""
    names = {a.arg for a in fn.args.posonlyargs + fn.args.args
             + fn.args.kwonlyargs
             if a.annotation is not None
             and dotted_name(a.annotation) in HOST_TYPES}
    assigns: list[tuple[list[str], ast.AST]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                assigns.append((_target_names(t), node.value))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                node.value is not None:
            assigns.append((_target_names(node.target), node.value))
        elif isinstance(node, ast.For) and isinstance(node.iter, ast.Call) \
                and dotted_name(node.iter.func) == "range":
            assigns.append((_target_names(node.target), node.iter))
    # a name is host only if every assignment to it is: shrink to a fixpoint
    cand = names | {n for targets, _ in assigns for n in targets}
    while True:
        bad = {n for targets, value in assigns
               if not _host_only(value, cand) for n in targets}
        nxt = cand - (bad - names)
        if nxt == cand:
            return cand
        cand = nxt


def _sync(call: ast.Call, names: set[str]) -> str | None:
    """Why ``call`` waits for the card, or None."""
    name = dotted_name(call.func)
    leaf = leaf_name(call)
    attr = isinstance(call.func, ast.Attribute)
    if attr and leaf in SYNC_METHODS and not call.args:
        return f".{leaf}() waits for the card and copies to the host"
    if attr and leaf in DATA_SIZED:
        return (f"{leaf}() has a data-dependent output size: the host "
                "waits for the card to learn it")
    if name == "torch.where" and len(call.args) == 1 and not call.keywords:
        return ("one-argument torch.where is nonzero(): the host waits for "
                "the card to learn its size")
    if name.split(".")[0] in ("np", "numpy"):
        return f"{name}() on the hot path copies a tensor to the host"
    if name in HOST_TYPES and call.args and isinstance(
            call.args[0], (ast.Call, ast.Subscript, ast.BinOp, ast.UnaryOp,
                           ast.BoolOp, ast.Compare)) and \
            not _host_only(call.args[0], names):
        return (f"{name}() of a computed value waits for the card (the "
                "seed's per-chunk int(jnp.sum(...)) defect class)")
    return None


def hot_functions(project: Project, root: Path
                  ) -> tuple[list[tuple[SourceFile, list[ast.FunctionDef]]],
                             list[Finding]]:
    """The hot functions under ``root``, per module, and a finding for each
    root in ``HOT_ROOTS`` that the tree no longer has."""
    out, missing = [], []
    by_file: dict[str, list[str]] = {}
    for rel, qual in HOT_ROOTS:
        by_file.setdefault(rel, []).append(qual)
    for p in sorted((root / "kernels").glob("*.py")):
        if p.name not in ("build.py", "__init__.py"):
            by_file.setdefault(f"kernels/{p.name}", [])
    for rel, quals in by_file.items():
        f = project.load(root / rel)
        fns = []
        for qual in quals:
            fn = qualified_def(f, qual) if f is not None else None
            if fn is None:
                missing.append(text_finding(
                    root / rel, project.root, 1, HostSyncRule.rule_id,
                    f"hot root '{qual}' is gone from {rel} — rename it in "
                    "RPL005's HOT_ROOTS so the rule keeps checking the "
                    "hot path"))
            else:
                fns.append(fn)
        if f is None:
            continue
        if rel.startswith("kernels/"):
            fns += [fn for name, fn in top_defs(f).items()
                    if not name.startswith("_")]
        out.append((f, call_closure(f, fns)))
    return out, missing


class HostSyncRule(Rule):
    rule_id = "RPL005"
    title = "host sync in hot path"

    def check_project(self, project: Project):
        for root in project.port_roots():
            hot, missing = hot_functions(project, root)
            yield from missing
            for f, fns in hot:
                for fn in fns:
                    names = host_names(fn)
                    for call in own_calls(fn):
                        why = _sync(call, names)
                        if why is not None:
                            yield f.finding(
                                call, self.rule_id,
                                f"{why} — inside hot function "
                                f"'{fn.name}'; keep the value on the card "
                                "and read it after the run")
