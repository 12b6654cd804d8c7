"""Print the dry run's costs of the reduced cells that
``tests/test_torch_dryrun_probes.py`` traces, for one source tree.

    PYTHONPATH=src python tools/dryrun_probe_costs.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` traces the cells
(this checkout's by default), so that two trees, such as an unpacked
``git archive`` of an earlier commit and this one, are traced on the same
cells and compared.  Each cell is the full-depth trace of
``dryrun.trace_cell`` on a fake (2, 2) ("data", "model") mesh of 4 ranks
(fake tensors on the CPU; no card, no device memory): the five branches of
the test's ``BRANCHES`` and reduced Mixtral-8x7B's train step (MoE on the
train path).  Prints one line a cell (FLOPs, collective bytes, bytes
accessed, peak) and then one JSON line of every cost and memory number.
~1 min on one core.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EXTRA = {"moe_train": ("mixtral-8x7b", {}, ("train", 32, 4), None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch traces")
    opts = ap.parse_args()
    sys.path[:0] = [str(Path(opts.src).resolve()), str(ROOT / "tests")]
    warnings.simplefilter("ignore")
    from test_torch_dryrun_probes import BRANCHES

    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    with dryrun.fake_world(4):
        mesh = make_host_mesh(model=2, data=2, device_type="cpu")
        for name, (arch, over, (kind, s, b), _) in (BRANCHES | EXTRA).items():
            cfg = dataclasses.replace(reduced(configs.get(arch)), **over)
            traced = dryrun.trace_cell(cfg, ShapeConfig(kind, s, b, kind),
                                       mesh, {"sp_activations":
                                              kind == "train"}, {}, "cpu")
            full, mem = traced["full"], traced["memory"]
            out[name] = dict(cost=full, memory=mem)
            print(f"{name} ({arch} {kind} {b} x {s}): flops {full['flops']}, "
                  f"collective bytes {full['coll_total_bytes']}, bytes "
                  f"accessed {full['bytes_accessed']}, peak "
                  f"{mem['peak_bytes']} B")
    print(json.dumps({"src": opts.src, "cells": out}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
