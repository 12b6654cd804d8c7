"""The port's replint rule set (RPL001–RPL007) — one module per invariant,
each the reference's contract rebuilt for PyTorch, ctypes and CUDA (port
of ``repro.analysis.rules``).
"""
from __future__ import annotations

from repro_torch.analysis.core import Rule
from repro_torch.analysis.rules.determinism import NondeterminismRule
from repro_torch.analysis.rules.dispatch import DispatchRule
from repro_torch.analysis.rules.hostsync import HostSyncRule
from repro_torch.analysis.rules.kernelhygiene import KernelHygieneRule
from repro_torch.analysis.rules.oracletests import OracleTestRule
from repro_torch.analysis.rules.parity import ParityRule
from repro_torch.analysis.rules.recompile import RecompileRule

ALL_RULES: tuple[Rule, ...] = (
    DispatchRule(),
    ParityRule(),
    NondeterminismRule(),
    RecompileRule(),
    HostSyncRule(),
    KernelHygieneRule(),
    OracleTestRule(),
)


def rule_by_id(rule_id: str) -> Rule:
    for r in ALL_RULES:
        if r.rule_id == rule_id:
            return r
    raise KeyError(rule_id)
