"""Put one benchmark cell's device time and idle gaps down to the engine's
host spans, and measure what recording them costs, on one card.

    python3 tools/span_trace.py --workload pod_fw_nat.enterprise \
        --seed 2147483711 [--seconds 10] [--runs 8] [--out FILE]

The cell is set up as ``portbench/run.py`` sets it up (``BENCHMARK.json``,
the traces drawn on the card from ``--seed``, the same warm-up), then:

1. one scenario run with ``repro_torch.trace`` recording and one without:
   their results must be equal (``portbench.harness.diff``), and the
   recorded one equal to the plain reference's;
2. four untraced windows of ``--seconds`` each, spans off / on / on / off:
   runs, packets a second and the median run wall of each;
3. the benchmark's traced block (``harness.trace_block``: ``--runs``
   scenario runs, device activity alone), for its idle share;
4. a span block (``portbench.spans.trace_span_block``: the same with spans
   recording): the per-layer numbers, the idle split against the block's
   own idle share, the host and device ms a run of every span name, the
   largest idle gaps by span, the clock check of the custom kernels'
   launches, and the seconds the block took.

Prints the card's name and power limit, the lines above, then one JSON
line, which ``--out FILE`` also writes.  Exits non-zero without a card or
when a check fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def window(run, n_traces: int, seconds: float, offered: int) -> dict:
    walls = []
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        t0 = time.perf_counter()
        run(len(walls) % n_traces)
        end = time.perf_counter()
        walls.append(end - t0)
    return dict(runs=len(walls), pkts_per_s=len(walls) * offered / (
        end - start), wall_ms_median=statistics.median(walls) * 1e3)


def measure(workload: str, seed: int, seconds: float, runs: int,
            log=print) -> dict:
    from portbench import generator, harness, spans
    from portbench.reference import dataplane as ref
    from repro_torch import trace
    from repro_torch.core.packet import PacketBatch
    from repro_torch.switchsim.engine import run_pipes

    dev = torch.device("cuda", 0)
    c = harness.load_cell(workload)
    config, mix = c["config"], c["mix"]
    traces, rules = generator.draw(config, mix, seed, dev)
    batches = [PacketBatch(**t) for t in traces]
    cfg, chain = harness.build_program(config, mix, rules)
    n_traces = len(traces)
    pipes, steps, chunk = traces[0]["src_ip"].shape
    offered = pipes * steps * chunk

    def run(i):
        res = run_pipes(cfg, chain, batches[i], window=config["window"],
                        backend="auto", device=dev)
        harness.sync(dev)
        return res

    held = [run(i) for i in range(n_traces)]
    run(0)
    del held
    log(f"card: {harness.card_line(dev)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {workload}, seed {seed}")

    # 1. recording on and off give the same result, and the reference's
    off = harness.program_output(run(0))
    with trace.recording():
        on = harness.program_output(run(0))
    same = harness.diff(on, off)
    sw, rchain = harness.build_reference(config, mix, rules)
    want = ref.run(sw, rchain, traces[0])
    checked = harness.diff(on, want)
    del off, on, want
    log(f"recording on against off: {same}; against the reference: "
        f"{checked}")

    # 2. the cost of recording, untraced
    cost = []
    for record in (False, True, True, False):
        if record:
            with trace.recording():
                w = window(run, n_traces, seconds, offered)
        else:
            w = window(run, n_traces, seconds, offered)
        cost.append(dict(spans=record, **w))
        log(f"window, spans {'on ' if record else 'off'}: {w}")

    # 3. the benchmark's traced block, device activity alone
    harness.trace_block(run, n_traces, dev, 1)
    for _ in range(3):
        t0 = time.perf_counter()
        _, intervals, wall, _, _ = harness.trace_block(run, n_traces, dev,
                                                       runs)
        block_a_s = time.perf_counter() - t0
        if intervals:
            break
    idle_a = 100.0 * (1.0 - harness.union_seconds(intervals) / wall)
    log(f"traced block: {len(intervals)} device events, idle "
        f"{idle_a:.6f} % of {wall:.6f} s; the block took {block_a_s:.3f} s")

    # 4. the span block
    for _ in range(3):
        t0 = time.perf_counter()
        block = spans.trace_span_block(run, n_traces, dev, runs)
        if block.ops:
            break
        log("span block: the profiler recorded no device event; taken again")
    if not block.ops:
        raise SystemExit("span block: no device event in three profiles")
    values = spans.metrics(block)
    idle_b = spans.idle_pct(block)
    by_layer = spans.device_by_layer(block)
    host = spans.host_ms_per_run(block)
    gaps = spans.idle_gaps(block)
    clock = spans.clock_check(block)
    block_b_s = time.perf_counter() - t0
    total = sum(by_layer.values())
    linked = sum(e - s for s, e, launch, _ in block.ops
                 if launch is not None) / 1e9
    split = (values["device.idle_in_steps_pct"]
             + values["device.idle_at_edges_pct"])
    log(f"span block: {len(block.ops)} device events over {block.runs} runs"
        f" and {block.steps} steps, {len(block.spans)} spans; idle "
        f"{idle_b:.6f} % of {block.wall_s:.6f} s (in steps + at edges "
        f"{split:.6f} %); launch linked for {100 * linked / total:.3f} % of "
        f"device time; {100 * by_layer.get(spans.OUTSIDE, 0) / total:.3f} % "
        f"of it outside run_pipes; the block and its reading took "
        f"{block_b_s:.3f} s")
    for k, v in values.items():
        log(f"metric {k} {v:.6f}")
    for name in sorted(set(host) | set(by_layer)):
        log(f"span {name}: host {host.get(name, 0.0):.3f} ms a run, device "
            f"{1e3 * by_layer.get(name, 0.0) / block.runs:.3f} ms a run")
    for label, sec in gaps:
        log(f"idle {sec * 1e3:10.3f} ms  {label}")
    for k, v in clock.items():
        log(f"clock {k}: {v}")

    out = dict(workload=workload, seed=seed, card=harness.card_line(dev),
               identical=same, reference=checked, cost=cost,
               traced_block=dict(idle_pct=idle_a, wall_s=wall,
                                 seconds=block_a_s),
               span_block=dict(idle_pct=idle_b, wall_s=block.wall_s,
                               seconds=block_b_s, runs=block.runs,
                               steps=block.steps, device_events=len(block.ops),
                               linked_share=linked / total,
                               outside_share=by_layer.get(spans.OUTSIDE, 0)
                               / total),
               metrics=values, device_s_by_layer=by_layer,
               host_ms_per_run=host, idle_gaps=gaps, clock=clock)
    ok = (not any(same.values()) and not any(checked.values())
          and abs(split - idle_b) <= 0.1
          and all(v["inside_share"] is None or v["inside_share"] >= 0.99
                  for v in clock.values()))
    out["ok"] = ok
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--out")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("span_trace: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.set_num_threads(1)
    out = measure(opts.workload, opts.seed, opts.seconds, opts.runs)
    if opts.out:
        Path(opts.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
