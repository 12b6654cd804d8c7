"""The dry run's decode cells with the cache carried in place: the
reference's optimized overrides plus ``decode_carry_cache``, a setting
the dry run's own CLI does not take (its ``--opt`` is the reference's
choice, which leaves the flag off).

    PYTHONPATH=src python3 tools/dryrun_carry_cache.py --device cpu \\
        [--arch gemma-7b] [--shape decode_32k] [--mesh both]

For each mesh: ``run_cell`` with ``optimized_overrides`` as the CLI's
``--opt`` gives them (tag ``opt``), then the same with
``decode_carry_cache=True`` (tag ``opt_carry``); the records go to
``dryrun_results_torch/`` as the CLI's do, and one JSON line compares
each pair's FLOPs, bytes accessed, collective bytes, argument and peak
bytes per device.  Counts of a fake trace on the host: no device time.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--device", default="cpu")
    opts = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.launch.dryrun import optimized_overrides, run_cell

    meshes = (["single", "multipod"] if opts.mesh == "both"
              else [opts.mesh])
    lm_kw, rules_kw = optimized_overrides(opts.arch, opts.shape)
    rows = {}
    for mesh in meshes:
        pair = {}
        for tag, extra in (("opt", {}),
                           ("opt_carry", {"decode_carry_cache": True})):
            rec = run_cell(opts.arch, opts.shape, mesh,
                           lm_overrides={**lm_kw, **extra},
                           rules_overrides=rules_kw, tag=tag,
                           device=opts.device)
            if rec["status"] != "ok":
                print(json.dumps({"error": rec}))
                return 1
            pair[tag] = dict(
                flops=rec["cost"]["flops"],
                bytes_accessed=rec["cost"]["bytes_accessed"],
                coll_total_bytes=rec["cost"]["coll_total_bytes"],
                argument_bytes=rec["memory"]["argument_bytes"],
                peak_bytes=rec["memory"]["peak_bytes"])
        rows[mesh] = pair
    print(json.dumps({"dryrun_carry_cache": {
        "arch": opts.arch, "shape": opts.shape, "lm_overrides": lm_kw,
        "rules_overrides": rules_kw, "cells": rows}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
