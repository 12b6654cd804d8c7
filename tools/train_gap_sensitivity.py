"""How far the train phase's card-vs-CPU gaps move when one run's
learning rate is off, on one device.

    PYTHONPATH=src python3 tools/train_gap_sensitivity.py [--device cpu]

For each config of ``chip_smoke.TRAIN_REDUCED``: ``launch.train`` for
``chip_smoke.TRAIN_STEPS`` steps at its default learning rate, then again
with the rate 10 % and 2 % higher, on the same device, parameters and
batches; prints ``chip_smoke.train_gaps`` of each pair (largest loss gap,
last grad norm gap relative, parameter update gap relative) beside the
phase's bounds, then one JSON line.  A bound that a 10 % fault does not
pass is a bound that can catch an optimizer fault on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FAULTS = (1.10, 1.02)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    opts = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch.launch.train import RunConfig, train

    rows = []
    for name in C.TRAIN_REDUCED:
        run = dict(arch=name, steps=C.TRAIN_STEPS, log_every=0,
                   device=opts.device)
        base = train(RunConfig(**run))
        for f in FAULTS:
            lr = RunConfig(arch=name).lr * f
            gaps = C.train_gaps(name, base, train(RunConfig(lr=lr, **run)))
            rows.append({"name": name, "lr_factor": f, "loss": gaps[0],
                         "grad_norm_rel": gaps[1], "update_rel": gaps[2]})
            print(f"{name}: learning rate x {f}: max |dloss| {gaps[0]} "
                  f"(bound {C.TRAIN_LOSS_ERR}), last grad norm relative "
                  f"{gaps[1]} (bound {C.TRAIN_GNORM_REL}), update relative "
                  f"{gaps[2]} (bound {C.TRAIN_UPDATE_REL})", flush=True)
    print(json.dumps({"device": opts.device, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
