"""Device resolution shared by every entry point of the port.

Entry points default to ``"cuda"``.  A CUDA request on a machine without a
card raises instead of quietly running on the CPU: a CPU run is asked for
explicitly (the tests pass ``device="cpu"``).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def card_line(device: str | torch.device) -> str:
    """What a measurement on ``device`` ran on: for a card, its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them;
    ``"cpu"`` otherwise."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()
