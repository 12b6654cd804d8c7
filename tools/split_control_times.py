"""Time one source tree's ``split_control`` CUDA kernel at the paths'
shapes, on one card.

    python3 tools/split_control_times.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so that two trees, such as an unpacked ``git
archive`` of an earlier commit and this one, are timed on the same inputs
and the same card, one process each, in turns (earlier, this, this,
earlier).  For each shape of ``chip_smoke.SPLIT_SHAPES`` (8 x 256, the
stream's 1 x 256 and 1 x 64, the chain's 2 x 256; the same seeded inputs
in every tree): the kernel's result against its plain version, exactly;
its time by CUDA events (``chip_smoke.device_ms``: the median of 30
launches with the queue kept full); the device duration of one traced
call; and the bound.  Prints the card's name and power limit, then one
JSON line.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_control_times: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(Path(opts.src).resolve()), str(ROOT)]
    import chip_smoke as C
    from repro_torch.backend import ref as R
    from repro_torch.device import card_line
    from repro_torch.kernels import split_control

    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(f"card: {card}; src {opts.src}")
    gen = torch.Generator().manual_seed(C.SEED + 1)
    shapes = C.split_shapes(gen, dev)
    rows = {}
    for label, args in shapes.items():
        label = label or "8x256"
        C.same_all(f"split_control {label}",
                   split_control.split_control_cuda(*args),
                   R.split_control(*args))
        rows[label] = dict(ms=C.device_ms(
            lambda: split_control.split_control_cuda(*args)),
            **C.split_bound(args))
        C.bound(rows[label])
    # the profiles last: profiling slows the launches that follow it
    C.device_busy(lambda d: split_control.split_control_cuda(
        *shapes[""]), dev)
    for label, args in shapes.items():
        for _ in range(3):  # a profile may record no device event at all
            prof = C.device_busy(
                lambda d: split_control.split_control_cuda(*args), dev)
            if prof["kernels"]:
                break
        if prof["kernels"] != 1:
            raise AssertionError(f"split_control {label}: one call ran "
                                 f"{prof['kernels']} device kernels")
        rows[label or "8x256"]["profiler_ms"] = prof["busy_s"] * 1e3
    print(card)
    print(json.dumps({"src": opts.src, "split_control": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
