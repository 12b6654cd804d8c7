"""The pipe sweep behind the cells' pipe counts: for each cell and each pipe
count, the scenario run's wall, the device's idle share and kernels a step
(``--trace 1``'s readers over one traced block) and the memory peak.  Run
it on the card from the root of a checkout:

    python3 portbench/sweep.py --cells pod_fw_nat.enterprise \
        pod_chain_dc.datacenter --pipes 128 256 512 --runs 12 --seed 11
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import generator, harness  # noqa: E402


def sweep_point(cell: str, pipes: int, runs: int, seed: int, dev) -> str:
    from repro_torch.core.packet import PacketBatch
    from repro_torch.switchsim.engine import run_pipes

    c = harness.load_cell(cell)
    config, mix = dict(c["config"], pipes=pipes), c["mix"]
    torch.cuda.reset_peak_memory_stats(dev)
    traces, rules = generator.draw(config, mix, seed, dev)
    batches = [PacketBatch(**t) for t in traces]
    cfg, chain = harness.build_program(config, mix, rules)

    def run(i):
        res = run_pipes(cfg, chain, batches[i], window=config["window"],
                        backend="auto", device=dev)
        harness.sync(dev)
        return res

    for i in range(len(batches)):
        run(i)
    walls = []
    for k in range(runs):
        t0 = time.perf_counter()
        run(k % len(batches))
        walls.append(time.perf_counter() - t0)
    by_name, intervals, wall, _, _ = harness.trace_block(
        run, len(batches), dev, harness.TRACE_RUNS)
    steps = mix["steps"] + config["window"] + int(config["recirculation"])
    busy = harness.union_seconds(intervals)
    peak = torch.cuda.max_memory_allocated(dev)
    offered = pipes * mix["steps"] * mix["chunk"]
    med = statistics.median(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    del traces, batches
    gc.collect()
    torch.cuda.empty_cache()
    lines = [f"sweep {cell} pipes {pipes}: run median {med * 1e3:.3f} ms "
             f"(min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}) "
             f"over {runs} runs = {offered / med:.1f} offered pkt/s; traced "
             f"{harness.TRACE_RUNS} runs: busy {busy:.6f} of {wall:.6f} s, "
             f"idle {100 * (1 - busy / wall):.2f} %, "
             f"{len(intervals) / (harness.TRACE_RUNS * steps):.1f} device "
             f"events a step; memory peak {peak} B"]
    lines += [f"    {sec * 1e3:10.3f} ms {cnt:7d}x {name[:100]}"
              for name, (cnt, sec) in top]
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--pipes", nargs="+", type=int, required=True)
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)  # the allocator's peak needs a live context
    print(f"card: {harness.card_line(dev)}; torch {torch.__version__}",
          flush=True)
    for cell in args.cells:
        for pipes in args.pipes:
            print(sweep_point(cell, pipes, args.runs, args.seed, dev),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
