"""replint for the port: project-specific static analysis of
``repro_torch`` (port of ``repro.analysis``, DESIGN.md §11).

The port's results rest on contracts that nothing else checks: every
per-packet primitive goes through the backend registry, the engine and the
host loop mirror each other's counters and telemetry, table builds and
programs are process-deterministic, the kernel library is built once from
exactly the sources its cache key covers, the per-step path does not wait
for the card, every ``ctypes`` entry matches its C prototype and never
falls back to the plain version, and bit-exact tests assert exactly.
RPL001-RPL007 keep the reference's ids and contracts; each rule's
docstring says how it reads them on PyTorch, ``ctypes`` and CUDA, and what
of the JAX form has no counterpart here.

Stdlib only: it imports neither ``torch`` nor ``jax``, and nothing of
``repro`` (not even ``repro.analysis``), so it runs where neither framework
is installed.

CLI: ``python -m repro_torch.analysis [paths...] [--json out.json]``
(default paths ``src/repro_torch`` and ``tests/test_torch_*.py``, default
baseline ``replint_torch_baseline.json``).
"""
from repro_torch.analysis.baseline import (Baseline,  # noqa: F401
                                           BaselineEntry, load_baseline)
from repro_torch.analysis.core import (Finding, Project,  # noqa: F401
                                       Rule, SourceFile, analyze,
                                       load_project)
from repro_torch.analysis.rules import ALL_RULES, rule_by_id  # noqa: F401
