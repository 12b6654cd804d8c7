"""Helpers of the benchmark's tests: its configurations and mixes at a
size a CPU test holds."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def tiny(config_name: str, **over) -> dict:
    """A configuration file of the benchmark at a size a CPU test holds:
    3 pipes, smaller tables, so occupancy, skips and (with the lane)
    recirculation all happen."""
    config = json.loads(
        (ROOT / "portbench" / "configs" / f"{config_name}.json").read_text())
    config.update(pipes=3, capacity=128, nat_capacity=256,
                  flows_per_pipe=64, fw_rules=5)
    config.update(over)
    return config


def tiny_mix(mix_name: str, **over) -> dict:
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{mix_name}.json")
                     .read_text())
    mix.update(chunk=64, steps=4, scenarios=2, checked=2)
    mix.update(over)
    return mix
