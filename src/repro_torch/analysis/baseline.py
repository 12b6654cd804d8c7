"""Suppression baseline: the only sanctioned way to silence a finding
(port of ``repro.analysis.baseline``, same file format).

There are deliberately no inline ``# replint: ignore`` pragmas — every
exemption lives in one committed JSON file (``replint_torch_baseline.json``
for the port; the reference keeps ``replint_baseline.json``) where review
can see it, diff it, and count it.  Policy, as in DESIGN.md §11: the
baseline may SHRINK, never GROW; ``tests/test_torch_analysis.py`` pins the
entry count and the budget only ever gets lowered.

Entries match findings by fingerprint (rule | path | source-line text),
so they survive line-number drift but expire when the suppressed line
itself changes.  An entry that matches nothing is *stale* and fails the
run: a fixed violation must leave the baseline in the same PR.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from repro_torch.analysis.core import Finding

DEFAULT_BASELINE = "replint_torch_baseline.json"


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    fingerprint: str
    rule: str
    path: str
    justification: str   # required, human-written — why this is exempt

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Baseline:
    path: Path | None
    entries: list[BaselineEntry]

    def __len__(self) -> int:
        return len(self.entries)

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[BaselineEntry]]:
        """Partition ``findings`` into (unsuppressed, suppressed) and
        return the stale baseline entries that matched nothing."""
        by_fp = {e.fingerprint: e for e in self.entries}
        unsuppressed, suppressed = [], []
        hit: set[str] = set()
        for f in findings:
            entry = by_fp.get(f.fingerprint)
            if entry is not None:
                suppressed.append(f)
                hit.add(entry.fingerprint)
            else:
                unsuppressed.append(f)
        stale = [e for e in self.entries if e.fingerprint not in hit]
        return unsuppressed, suppressed, stale


def load_baseline(path: str | Path | None) -> Baseline:
    """Load the baseline; a missing file is an empty baseline (new trees
    start clean), but a malformed one is an error — silence must never be
    the result of a parse failure."""
    if path is None:
        return Baseline(path=None, entries=[])
    p = Path(path)
    if not p.exists():
        return Baseline(path=p, entries=[])
    data = json.loads(p.read_text(encoding="utf-8"))
    entries = []
    for raw in data.get("suppressions", []):
        missing = {"fingerprint", "rule", "path", "justification"} - set(raw)
        if missing:
            raise ValueError(
                f"{p}: baseline entry {raw!r} missing keys {sorted(missing)}")
        if not str(raw["justification"]).strip():
            raise ValueError(
                f"{p}: baseline entry for {raw['path']} ({raw['rule']}) has "
                "an empty justification — every exemption must say why")
        entries.append(BaselineEntry(
            fingerprint=raw["fingerprint"], rule=raw["rule"],
            path=raw["path"], justification=raw["justification"]))
    return Baseline(path=p, entries=entries)


def render_baseline(findings: list[Finding], note: str = "") -> str:
    """Serialise findings as a fresh baseline skeleton (``--write-baseline``).
    Justifications are emitted empty ON PURPOSE: loading rejects them, so
    a generated baseline cannot be committed without a human writing the
    why for every entry."""
    return json.dumps({
        "_policy": "shrink-only: entries may be removed, never added without "
                   "review; tests/test_torch_analysis.py pins the count",
        "_note": note,
        "suppressions": [
            {"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
             "line": f.line, "message": f.message, "justification": ""}
            for f in findings],
    }, indent=2) + "\n"
