"""Scenario matrix (port of ``repro.scenarios``; DESIGN.md §8).

Declarative scenario specs (``spec``), a registry of named families
(``registry``, populated by ``matrix`` with the paper's evaluation grid),
the runner (``runner``) that executes batchable points as one
``run_pipes`` call, and the adversarial family with its graceful-
degradation gates (``adversarial``, DESIGN.md §10).
"""
from repro_torch.scenarios.adversarial import (adversarial_family,
                                               bounds_for, degradation_block,
                                               degradation_metrics)
from repro_torch.scenarios.matrix import pipeline_grid, recirc_grid
from repro_torch.scenarios.registry import family, names, register
from repro_torch.scenarios.runner import (OracleMismatch, Prepared,
                                          ScenarioResult, default_rows,
                                          prepare, run_matrix, run_prepared,
                                          verify_oracle)
from repro_torch.scenarios.spec import (ScenarioSpec, build_chain,
                                        compile_key, grid, make_packets,
                                        resolve_workload, steer)

__all__ = [
    "family", "names", "register", "pipeline_grid", "recirc_grid",
    "OracleMismatch", "Prepared", "ScenarioResult", "default_rows",
    "prepare", "run_matrix", "run_prepared", "verify_oracle",
    "ScenarioSpec", "build_chain", "compile_key", "grid", "make_packets",
    "resolve_workload", "steer",
    "adversarial_family", "bounds_for", "degradation_block",
    "degradation_metrics",
]
