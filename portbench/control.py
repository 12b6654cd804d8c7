"""The control of a cell's comparison, at the cell's own size: for each seed,
the program's scenario runs and the control (the plain reference with NAT's
walk reading the table as each call found it, so two packets of one new
flow in one step no longer share a mapping: the per-packet sequential
semantics that P4's registers guarantee, broken) are each held to the
reference, as a benchmark run holds its sample.  The program has to read
0 on every number, the control above 0 on one at least.  Run it on the
card from the root of a checkout:

    python3 portbench/control.py --workload pod_fw_nat.enterprise \
        --seeds 2147483700 2147483701 2147483702
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import generator, harness  # noqa: E402
from portbench.reference import dataplane as ref  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.packet import PacketBatch
    from repro_torch.switchsim.engine import run_pipes

    dev = torch.device("cuda:0")
    c = harness.load_cell(args.workload)
    config, mix = c["config"], c["mix"]
    print(f"card: {harness.card_line(dev)}; {args.workload}", flush=True)
    for seed in args.seeds:
        traces, rules = generator.draw(config, mix, seed, dev)
        cfg, chain = harness.build_program(config, mix, rules)
        sw, rchain = harness.build_reference(config, mix, rules)
        for i in range(mix["checked"]):
            t0 = time.perf_counter()
            res = run_pipes(cfg, chain, PacketBatch(**traces[i]),
                            window=config["window"], backend="auto",
                            device=dev)
            got = harness.program_output(res)
            del res
            want = ref.run(sw, rchain, traces[i])
            program = harness.diff(got, want)
            del got
            control = harness.diff(
                ref.run(sw, rchain, traces[i], sequential_nat=False), want)
            print(f"seed {seed} scenario {i}: program {program}; control "
                  f"{control} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        del traces
    return 0


if __name__ == "__main__":
    sys.exit(main())
