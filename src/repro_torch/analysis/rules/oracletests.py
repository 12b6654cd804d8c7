"""RPL007 — oracle-test discipline: bit-exact claims get exact asserts
(port of ``repro.analysis.rules.oracletests``).

The engine≡loop and cross-backend contracts are bit-exact (integer packet
bytes, counters, telemetry), and so is most of the port against the
reference.  A test that asserts such a contract with a tolerance quietly
weakens it to "approximately reproduces", and a real divergence (an
off-by-one counter, a truncated byte) can hide inside the tolerance.

The scoping is the reference's: test functions whose name or class marks
them as exactness oracles (``oracle``, ``bitexact``, ``parity``,
``engine``+``loop``, ``cross_backend``, ``backends_match``, or any test
calling a ``*oracle*`` helper), plus ``bit_for_bit``, the port's tests'
own word for it.

Flags there: ``assert_close``, ``assert_allclose``, ``allclose``,
``isclose`` and ``approx``, and ``rtol=``/``atol=`` keywords on other
calls, unless every tolerance given is a literal 0 and both are given
(``rtol=0, atol=0``; ``rel=0, abs=0`` for ``approx``).  torch's
``assert_close`` is exact on integer tensors whatever its tolerances, but
the AST cannot see a dtype, so an exact assert says so with zeros.
Genuinely approximate comparisons belong in the suppression baseline with
the numerical justification spelled out.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.core import Rule, SourceFile, dotted_name, walk_calls

EXACTNESS = re.compile(
    r"oracle|bit_?exact|bit_for_bit|parity|cross_?backend|backends?_match"
    r"|engine.*loop|loop.*engine|matches_loop|matches_engine")

APPROX_CALLS = ("assert_close", "assert_allclose", "allclose", "isclose",
                "approx")
ZERO_PAIRS = (("rtol", "atol"), ("rel", "abs"))


def _exactness_scoped(fn: ast.FunctionDef, classname: str) -> bool:
    if EXACTNESS.search(f"{classname} {fn.name}".lower()):
        return True
    return any("oracle" in dotted_name(c.func).lower()
               for c in walk_calls(fn))


def _zero(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == 0 and \
        not isinstance(node.value, bool)


def _exact_tolerances(call: ast.Call) -> bool:
    """Both tolerances of one pair given, each a literal 0."""
    kws = {kw.arg: kw.value for kw in call.keywords if kw.arg}
    return any(all(k in kws and _zero(kws[k]) for k in pair)
               for pair in ZERO_PAIRS)


class OracleTestRule(Rule):
    rule_id = "RPL007"
    title = "approximate assert in a bit-exactness test"

    def check_file(self, f: SourceFile):
        if not f.is_test:
            return
        for cls, fn in _test_functions(f.tree):
            if not fn.name.startswith("test_"):
                continue
            if not _exactness_scoped(fn, cls):
                continue
            for call in walk_calls(fn):
                leaf = dotted_name(call.func).split(".")[-1]
                exact = _exact_tolerances(call)
                if leaf in APPROX_CALLS:
                    if not exact:
                        yield f.finding(
                            call, self.rule_id,
                            f"{leaf}() in a bit-exactness test weakens the "
                            "oracle to 'approximately equal' — assert "
                            "exact equality (torch.equal / ==, or "
                            "rtol=0, atol=0)")
                    continue
                for kw in call.keywords:
                    if kw.arg in ("rtol", "atol") and not _zero(kw.value):
                        yield f.finding(
                            call, self.rule_id,
                            f"{kw.arg}= tolerance in a bit-exactness test — "
                            "assert exact equality (torch.equal / ==)")


def _test_functions(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            yield "", node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    yield node.name, sub
