"""Named scenario families (copy of ``repro.scenarios.registry``).

A *family* is a named factory ``(tiny: bool) -> list[ScenarioSpec]``.
Families are registered at import time by ``repro_torch.scenarios.matrix``
(the paper's evaluation grid); ad-hoc experiments can register their own
without touching the shipped matrix.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.scenarios.spec import ScenarioSpec

_FAMILIES: dict[str, Callable[[bool], list[ScenarioSpec]]] = {}


def register(name: str):
    """Decorator: register a scenario-family factory under ``name``."""
    def deco(factory: Callable[[bool], list[ScenarioSpec]]):
        if name in _FAMILIES:
            raise ValueError(f"scenario family {name!r} already registered")
        _FAMILIES[name] = factory
        return factory
    return deco


def family(name: str, tiny: bool = False) -> list[ScenarioSpec]:
    """Expand one registered family; raises KeyError with the known names."""
    if name not in _FAMILIES:
        raise KeyError(
            f"unknown scenario family {name!r}; registered: {names()}")
    specs = _FAMILIES[name](tiny)
    seen = [s.name for s in specs]
    if len(set(seen)) != len(seen):
        raise ValueError(f"family {name!r} has duplicate scenario names")
    return specs


def names() -> list[str]:
    return sorted(_FAMILIES)
