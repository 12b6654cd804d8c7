"""Command line for the port's replint: ``python -m repro_torch.analysis``
(port of ``repro.analysis.cli``, same options, report and exit codes).

Default scope: the package ``src/repro_torch`` and the port's test files
``tests/test_torch_*.py``, against ``replint_torch_baseline.json``.

Exit codes: 0 clean (all findings baseline-suppressed or none), 1 any
unsuppressed finding OR stale baseline entry (a fixed violation must leave
the baseline in the same PR), 2 usage/environment error.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.analysis.baseline import (DEFAULT_BASELINE, load_baseline,
                                     render_baseline)
from repro_torch.analysis.core import analyze, load_project
from repro_torch.analysis.rules import ALL_RULES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="replint for the PyTorch + CUDA port "
                    "(RPL001-RPL007 rebuilt for torch, ctypes and CUDA)")
    p.add_argument("paths", nargs="*",
                   help="files/directories to analyze (default: "
                        "src/repro_torch and tests/test_torch_*.py)")
    p.add_argument("--json", metavar="FILE",
                   help="write findings + baseline accounting as JSON")
    p.add_argument("--baseline", metavar="FILE", default=DEFAULT_BASELINE,
                   help=f"suppression baseline (default: {DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write current findings as a baseline skeleton "
                        "(justifications left empty on purpose) and exit")
    p.add_argument("--changed-only", nargs="?", const="HEAD",
                   metavar="GIT_BASE",
                   help="only analyze .py files changed vs GIT_BASE "
                        "(default HEAD); cross-file rules still load their "
                        "counterpart files")
    p.add_argument("--select", metavar="IDS",
                   help="comma-separated rule ids to run (e.g. "
                        "RPL001,RPL003)")
    p.add_argument("--list-rules", action="store_true",
                   help="list rule ids and titles, then exit")
    return p


def default_paths() -> list[str]:
    """The port and its tests, relative to the working directory."""
    tests = Path("tests").glob("test_torch_*.py")
    return ["src/repro_torch", *sorted(p.as_posix() for p in tests)]


def _changed_files(base: str, scope: list[str]) -> list[str] | None:
    """Changed .py files vs ``base`` that live under one of ``scope``."""
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "--diff-filter=d", base,
             "--", "*.py"],
            capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"replint: --changed-only: git diff failed: {e}",
              file=sys.stderr)
        return None
    scope_paths = [Path(s).resolve() for s in scope]
    picked = []
    for line in out.splitlines():
        p = Path(line.strip())
        if not p.exists():
            continue
        rp = p.resolve()
        if any(rp == s or s in rp.parents for s in scope_paths):
            picked.append(str(p))
    return picked


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)

    rules = list(ALL_RULES)
    if args.select:
        wanted = {s.strip() for s in args.select.split(",") if s.strip()}
        unknown = wanted - {r.rule_id for r in ALL_RULES}
        if unknown:
            print(f"replint: unknown rule ids: {sorted(unknown)}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.rule_id in wanted]

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.rule_id}  {r.title}")
        return 0

    paths = list(args.paths) or default_paths()
    if args.changed_only:
        changed = _changed_files(args.changed_only, paths)
        if changed is None:
            return 2
        if not changed:
            print("replint: no changed .py files in scope — clean")
            if args.json:
                Path(args.json).write_text(json.dumps(
                    {"findings": [], "suppressed": [], "stale_baseline": [],
                     "baseline_count": 0, "files_analyzed": 0}, indent=2))
            return 0
        paths = changed

    project = load_project(paths)
    findings = analyze(project, rules)

    if args.write_baseline:
        Path(args.write_baseline).write_text(render_baseline(
            findings, note=f"generated over {' '.join(paths)}"))
        print(f"replint: wrote {len(findings)} skeleton entries to "
              f"{args.write_baseline} — fill in every justification "
              "before committing")
        return 0

    try:
        baseline = load_baseline(None if args.no_baseline else args.baseline)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"replint: bad baseline: {e}", file=sys.stderr)
        return 2
    unsuppressed, suppressed, stale = baseline.split(findings)
    # Staleness is only provable for entries inside the analyzed scope: an
    # absent finding for a file we never parsed proves nothing.  This also
    # covers --changed-only, which sees a file subset by design.
    if args.changed_only:
        stale = []
    else:
        scope = [Path(p).resolve() for p in paths]
        ran = {r.rule_id for r in rules}
        stale = [e for e in stale
                 if e.rule in ran
                 and any(Path(e.path).resolve() == s
                         or s in Path(e.path).resolve().parents
                         for s in scope)]

    for f in unsuppressed:
        print(f.render())
    for e in stale:
        print(f"{e.path} {e.rule} STALE baseline entry "
              f"{e.fingerprint}: the finding it suppressed is gone — "
              "remove it (baseline may shrink, never grow)")

    if args.json:
        Path(args.json).write_text(json.dumps({
            "findings": [f.as_dict() for f in unsuppressed],
            "suppressed": [f.as_dict() for f in suppressed],
            "stale_baseline": [e.as_dict() for e in stale],
            "baseline_count": len(baseline),
            "files_analyzed": len(project.files),
        }, indent=2) + "\n")

    n, s = len(unsuppressed), len(suppressed)
    tail = f" ({s} suppressed by baseline)" if s else ""
    if n or stale:
        print(f"replint: {n} finding(s){tail}, "
              f"{len(stale)} stale baseline entr(y/ies) "
              f"over {len(project.files)} files")
        return 1
    print(f"replint: clean{tail} over {len(project.files)} files")
    return 0
