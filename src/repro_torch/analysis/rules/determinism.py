"""RPL003 — process-nondeterminism ban (port of
``repro.analysis.rules.determinism``, the salted-``hash()`` class).

A Maglev table build of the reference once keyed on builtin ``hash(name)``:
``PYTHONHASHSEED`` salts string hashes per process, so every fresh
interpreter built a different permutation table, self-consistent within a
run and unreproducible across runs.  The port's tables come from the same
explicit splitmix64 (``nf/maglev.py``).  This rule bans the defect class.

Everywhere, tests included, as in the reference:

  * builtin ``hash(...)`` — salted for str/bytes, never reproducible;
  * iterating a ``set`` (literal, ``set(...)`` call, or comprehension) —
    iteration order depends on the salted hashes; iterate ``sorted(...)``.

In the package only (tests and the harness ``chip_smoke.py`` time and
seed on purpose):

  * the wall clock: ``time.time``, ``time_ns``, ``perf_counter``,
    ``perf_counter_ns``, ``monotonic``, ``monotonic_ns``,
    ``clock_gettime``, ``clock_gettime_ns``.  The reference bans
    ``time.time`` and ``time.time_ns`` alone; the port times with
    ``perf_counter``, which is as much a wall clock when it feeds logic.
    Timing-only uses belong in the suppression baseline, where the
    exemption is visible.  One module is exempt by name: the package's
    span recorder, ``repro_torch/trace.py`` (the ``trace.py`` beside
    ``kernels/``).  It reads the clock to stamp spans for a device trace
    and for nothing else: no result, table or branch of the program
    depends on what it reads, and its stamps change with every run as the
    trace's own do;
  * torch's process-global generator: a draw without a ``generator=``
    keyword (``torch.rand``, ``randn``, ``randint``, ``randperm``,
    ``multinomial``, ``normal``, ``bernoulli``, ``poisson``, the
    ``*_like`` forms, and the in-place ``uniform_``, ``normal_``, ...), and
    ``torch.manual_seed``, ``torch.seed``, ``torch.cuda.manual_seed(_all)``,
    which reseed state that every other caller shares.  The reference has
    no counterpart: JAX has no global generator;
  * numpy's global generator: ``np.random.<draw>`` and
    ``np.random.seed``.  Seeded generators (``default_rng(seed)``,
    ``SeedSequence``, ``RandomState(seed)``) stay allowed.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import (Rule, SourceFile, dotted_name,
                                       port_root, walk_calls)

WALL_CLOCK = frozenset({"time", "time_ns", "perf_counter", "perf_counter_ns",
                        "monotonic", "monotonic_ns", "clock_gettime",
                        "clock_gettime_ns"})
TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "multinomial", "normal",
    "bernoulli", "poisson", "rand_like", "randn_like", "randint_like"})
INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "exponential_", "bernoulli_",
    "geometric_", "cauchy_", "log_normal_"})
TORCH_RESEEDS = frozenset({"torch.manual_seed", "torch.seed",
                           "torch.cuda.manual_seed",
                           "torch.cuda.manual_seed_all"})
NUMPY_SEEDED = frozenset({"default_rng", "SeedSequence", "Generator",
                          "RandomState", "BitGenerator", "PCG64",
                          "PCG64DXSM", "MT19937", "Philox", "SFC64"})


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and dotted_name(node.func) in ("set",
                                                                 "frozenset"):
        return True
    return False


def _clock_aliases(tree: ast.AST) -> dict[str, str]:
    """Bare names bound by ``from time import perf_counter [as pc]``."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name in WALL_CLOCK:
                    out[alias.asname or alias.name] = f"time.{alias.name}"
    return out


def _is_recorder(f: SourceFile) -> bool:
    """``f`` is the package's span recorder: ``trace.py`` at the root of
    the port (beside ``kernels/build.py``)."""
    return f.parts[-1] == "trace.py" and port_root(f) == f.abspath.parent


def _reads_clock(call: ast.Call, clocks: dict[str, str]) -> bool:
    name = dotted_name(call.func)
    parts = name.split(".")
    return name in clocks or (len(parts) == 2 and parts[0] == "time"
                              and parts[1] in WALL_CLOCK)


def _program_finding(call: ast.Call, clocks: dict[str, str]) -> str | None:
    """Why ``call`` draws on process state, or None."""
    name = dotted_name(call.func)
    parts = name.split(".")
    seeded = any(kw.arg == "generator" for kw in call.keywords)
    if _reads_clock(call, clocks):
        return (f"{clocks.get(name, name)}() feeds wall-clock "
                "nondeterminism into the program — derive logic from "
                "seeds/config; timing-only uses belong in the suppression "
                "baseline")
    if name in TORCH_RESEEDS:
        return (f"{name}() reseeds torch's process-global generator, which "
                "every other caller shares — pass a torch.Generator")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in TORCH_DRAWS \
            and not seeded:
        return (f"{name}() without generator= draws from torch's "
                "process-global generator — pass a seeded torch.Generator")
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in INPLACE_DRAWS and not seeded:
        return (f".{call.func.attr}() without generator= draws from torch's "
                "process-global generator — pass a seeded torch.Generator")
    if len(parts) == 3 and parts[0] in ("np", "numpy") and \
            parts[1] == "random" and parts[2] not in NUMPY_SEEDED:
        return (f"{name}() uses numpy's process-global generator — draw "
                "from np.random.default_rng(seed)")
    return None


class NondeterminismRule(Rule):
    rule_id = "RPL003"
    title = "process-nondeterministic construct"

    def check_file(self, f: SourceFile):
        program = not (f.is_test or f.parts[-1] == "chip_smoke.py")
        clocks = _clock_aliases(f.tree) if program else {}
        recorder = program and _is_recorder(f)
        for call in walk_calls(f.tree):
            if dotted_name(call.func) == "hash":
                yield f.finding(
                    call, self.rule_id,
                    "builtin hash() is PYTHONHASHSEED-salted per process — "
                    "use an explicit mix (e.g. splitmix64, cf. "
                    "nf/maglev.py) so table builds reproduce")
                continue
            if recorder and _reads_clock(call, clocks):
                continue    # the recorder's span stamps: timing only
            why = _program_finding(call, clocks) if program else None
            if why is not None:
                yield f.finding(call, self.rule_id, why)
        for node in ast.walk(f.tree):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                iters.extend(g.iter for g in node.generators)
            for it in iters:
                if _is_set_expr(it):
                    yield f.finding(
                        it, self.rule_id,
                        "iterating a set: order is salted-hash-dependent, "
                        "so anything built from it varies per process — "
                        "iterate sorted(...) instead")
