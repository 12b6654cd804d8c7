"""The port's benchmark harness, driven by data.

``python3 portbench/run.py --workload <config>.<mix> --seed <n> --seconds
<s> --trace <0|1>`` finds the cell in ``BENCHMARK.json``, its deployment in
``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<mix>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``; a later cell, mix or metric is files and
entries, not code.

One run:

1. draws ``scenarios`` traces on the card from ``--seed``
   (``portbench.generator``) and builds the system under test,
   ``repro_torch``'s engine (``switchsim.engine.run_pipes``), from the
   configuration;
2. warms up with one scenario run of each trace (the first run in a
   checkout also builds the CUDA kernels);
3. runs scenarios back to back for ``--seconds``, cycling through the
   traces.  A scenario run starts from fresh switch and NF state and ends
   when its ``PipesResult`` is on the host and the card has synchronised;
4. with ``--trace 1``, traces a block of scenario runs (device activity
   alone) for the per-layer metrics and the breakdown;
5. reads the memory peak, then checks a seeded sample of the window's
   results against the plain reference (``portbench.reference``): every
   merged packet, the final switch tables and registers, the counters,
   the per-pipe link telemetry and the occupancy series must be equal;
6. prints one JSON line, last on standard output.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from portbench import generator
from portbench.reference import dataplane as ref

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_RUNS = 8        # scenario runs in the traced block
CHECK_NAMES = ("merged_rows_wrong", "state_words_wrong", "counters_wrong",
               "telemetry_wrong")


# --------------------------------------------------------------------------
# the cell's files
# --------------------------------------------------------------------------

def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry, deployment, traffic mix and metrics, found by the
    names in ``BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r} (have "
                         f"{sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    bench = root / spec["paths"][0]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(
        cell=cell,
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                       .read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
        metrics_dir=bench / "metrics")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------------
# the two sides: the program under test and the plain reference
# --------------------------------------------------------------------------

def build_program(config: dict, mix: dict, rules: list):
    """(ParkConfig, Chain) of ``repro_torch`` for the deployment."""
    from repro_torch.core.park import ParkConfig
    from repro_torch.nf.chain import Chain
    from repro_torch.nf.firewall import Firewall
    from repro_torch.nf.maglev import MaglevLB
    from repro_torch.nf.nat import Nat

    cfg = ParkConfig(capacity=config["capacity"], max_exp=config["max_exp"],
                     pmax=mix["pmax"], recirculation=config["recirculation"],
                     recirc_frac=config.get("recirc_frac", 0.0))
    make = dict(
        fw=lambda: Firewall(rules=tuple(rules)),
        nat=lambda: Nat(nat_ip=config["nat_ip"],
                        capacity=config["nat_capacity"],
                        base_port=config["nat_base_port"],
                        max_exp=config["nat_max_exp"]),
        lb=lambda: MaglevLB(backends=tuple(config["lb_backends"]),
                            table_size=config["lb_table_size"]))
    return cfg, Chain(tuple(make[nf]() for nf in config["chain"]))


def build_reference(config: dict, mix: dict, rules: list):
    """(Switch, chain) of the plain reference for the deployment."""
    sw = ref.Switch(capacity=config["capacity"], max_exp=config["max_exp"],
                    recirculation=config["recirculation"],
                    recirc_frac=config.get("recirc_frac", 0.0),
                    pmax=mix["pmax"],
                    window=config["window"])
    make = dict(
        fw=lambda: ref.Firewall(tuple(rules)),
        nat=lambda: ref.Nat(capacity=config["nat_capacity"],
                            base_port=config["nat_base_port"],
                            max_exp=config["nat_max_exp"],
                            nat_ip=config["nat_ip"]),
        lb=lambda: ref.Maglev(tuple(config["lb_backends"]),
                              config["lb_table_size"]))
    return sw, tuple(make[nf]() for nf in config["chain"])


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_output(res) -> dict:
    """A ``PipesResult`` in the form of the reference's output."""
    pipes = len(res.per_pipe_counters)

    def per_pipe(rows, name):
        return torch.tensor([int(r[name]) for r in rows], dtype=torch.int64)

    return dict(
        merged={n: getattr(res.merged, n) for n in ref.FIELDS},
        state={k: getattr(res.state, k) for k in (
            "tbl_idx", "clk", "meta_exp", "meta_clk", "meta_len", "ptable")},
        counters={n: per_pipe(res.per_pipe_counters, n)
                  for n in ref.COUNTERS},
        nat_stale_hits=torch.tensor(
            [int(res.per_pipe_nf_counters[p].get("nat_stale_hits", 0))
             for p in range(pipes)], dtype=torch.int64),
        telemetry={n: per_pipe([t.as_dict() for t in
                                res.per_pipe_telemetry], n)
                   for n in ref.TELEMETRY},
        occ=torch.as_tensor(res.per_pipe_occ_series).to(torch.int64))


def diff(got: dict, want: dict) -> dict:
    """How far an output lies from the reference's: merged rows with any
    field or payload byte different, differing words of the final switch
    tables and registers, differing per-pipe counters (NAT's stale hits
    among them), and differing per-pipe telemetry totals and occupancy
    samples.  A tensor of the wrong shape counts every element wrong."""

    def wrong(a, b):
        if a.shape != b.shape:
            return torch.ones(b.shape, dtype=torch.bool)
        return a.to(b.device) != b

    rows = torch.zeros(want["merged"]["alive"].shape, dtype=torch.bool)
    for n in ref.FIELDS:
        w = wrong(got["merged"][n], want["merged"][n])
        rows |= (w.any(-1) if n == "payload" else w).cpu()

    def total(kind):
        return sum(int(wrong(got[kind][k], v).sum())
                   for k, v in want[kind].items())

    return dict(
        merged_rows_wrong=int(rows.sum()),
        state_words_wrong=total("state"),
        counters_wrong=total("counters") + int(
            wrong(got["nat_stale_hits"], want["nat_stale_hits"]).sum()),
        telemetry_wrong=total("telemetry") + int(
            wrong(got["occ"], want["occ"]).sum()))


# --------------------------------------------------------------------------
# the traced runs
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads: the traced block's device
    events, busy time and wall, the engine steps it ran, the summed
    counters and telemetry of its scenario runs, and the deployment's
    configuration."""

    kernels: dict          # device event name -> [count, seconds]
    device_events: int
    busy_s: float
    window_s: float
    steps: int
    counters: dict
    telemetry: dict
    config: dict

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose base name is in ``names``."""
        return sum(sec for name, (_, sec) in self.kernels.items()
                   if base_name(name) in names)


def base_name(name: str) -> str:
    """A kernel's identifier: ``(anonymous namespace)::foo_kernel(Args)``
    and ``void ns::foo_kernel<T>(Args)`` -> ``foo_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split(" ")[-1].split("::")[-1]


def union_seconds(intervals: list) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, *_ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e6


def trace_block(run, n_traces: int, dev, runs: int):
    """Profile ``runs`` scenario runs with device activity alone.  Returns
    (device events by name, device intervals (start us, end us, name),
    wall s, the results' summed counters and telemetry)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counters, telemetry = {}, {}
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(runs):
            res = run(k % n_traces)
            for n, v in res.counters.items():
                counters[n] = counters.get(n, 0) + v
            for n, v in res.telemetry.as_dict().items():
                telemetry[n] = telemetry.get(n, 0) + v
            del res
        sync(dev)
        wall = time.perf_counter() - t0
    by_name, intervals = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e6
            intervals.append((e.time_range.start, e.time_range.end, e.name))
    return by_name, intervals, wall, counters, telemetry


def idle_gaps(intervals: list, top: int = 10) -> list:
    """The device's idle gaps in a traced block, each named by the device
    operation that ended it (what the host was preparing to launch), summed
    by that name: the ``top`` largest."""
    by_label: dict = {}
    end = None
    for s, e, name in sorted(intervals):
        if end is not None and s > end:
            label = "before " + name[:100]
            by_label[label] = by_label.get(label, 0.0) + (s - end) / 1e6
        end = e if end is None else max(end, e)
    return sorted(([k, v] for k, v in by_label.items()),
                  key=lambda kv: -kv[1])[:top]


def load_reader(metrics_dir: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or torch.cuda.get_device_name(dev)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev) + ", power limit not read"


# --------------------------------------------------------------------------
# one run of a cell
# --------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, root: Path = ROOT,
             log=print) -> dict:
    """One benchmark run of a cell; returns the result line's object."""
    from repro_torch.core.packet import PacketBatch
    from repro_torch.switchsim.engine import (goodput_gain_from_telemetry,
                                              run_pipes)

    dev = torch.device(device)
    c = load_cell(workload, root)
    config, mix = c["config"], c["mix"]
    t_import = time.perf_counter()
    traces, rules = generator.draw(config, mix, seed, dev)
    batches = [PacketBatch(**t) for t in traces]
    cfg, chain = build_program(config, mix, rules)
    window = config["window"]
    n_traces = len(traces)
    pipes, steps, chunk = traces[0]["src_ip"].shape
    offered = pipes * steps * chunk

    def run(i):
        res = run_pipes(cfg, chain, batches[i], window=window,
                        backend="auto", device=dev)
        sync(dev)
        return res

    t_draw = time.perf_counter()
    # warm-up: every trace once, all results held and one more run on top,
    # so the allocator holds the window's footprint (a kept result a trace
    # and a run in flight) before the window opens
    held = [run(i) for i in range(n_traces)]
    run(0)
    del held
    rng = random.Random(seed)
    kept, seen, walls, full_gc = {}, [0] * n_traces, [], []
    start = time.perf_counter()
    setup_s = start - t_start
    deadline, end = start + seconds, start
    while end < deadline:
        i = len(walls) % n_traces
        gen2 = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        res = run(i)
        end = time.perf_counter()
        walls.append(end - t0)
        full_gc.append(gc.get_stats()[2]["collections"] - gen2)
        seen[i] += 1
        # a uniform sample, drawn from the seed, of each trace's runs
        if rng.random() * seen[i] < 1.0:
            kept[i] = res
        del res
    window_s = end - start
    runs = len(walls)
    log(f"card: {card_line(dev)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(f"window: {runs} scenario runs of {pipes} pipes x {steps} steps x "
        f"{chunk} packets ({offered} offered packets a run) in "
        f"{window_s:.6f} s after {setup_s:.6f} s of set-up; run walls "
        f"median {statistics.median(walls) * 1e3:.6f} ms, max "
        f"{max(walls) * 1e3:.6f} ms")
    slow = sorted(range(runs), key=lambda k: -walls[k])[:8]
    log(f"set-up: {t_import - t_start:.3f} s to the imports' end, "
        f"{t_draw - t_import:.3f} s to draw the traces, "
        f"{start - t_draw:.3f} s of warm-up; slowest runs (index: ms, "
        f"full collections of Python's garbage collector in the run) "
        + ", ".join(f"{k}: {walls[k] * 1e3:.3f} {full_gc[k]}" for k in slow)
        + f"; {sum(full_gc)} full collections in the window")
    any_res = next(iter(kept.values()))
    log(f"goodput: {goodput_gain_from_telemetry(any_res.telemetry)}")
    log(f"counters: {any_res.counters}; NF {any_res.nf_counters}")
    log(f"telemetry: {any_res.telemetry.as_dict()}")

    metrics, device_info = {}, dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        count=1)
    breakdown = None
    if not trace:
        values = dict(
            pkts_per_s=runs * offered / window_s,
            run_ms_p95=statistics.quantiles(
                walls, n=100, method="inclusive")[94] * 1e3 if runs > 1
            else walls[0] * 1e3,
            setup_s=setup_s)
        for m in c["end_to_end"]:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    elif dev.type != "cuda":
        # no device to trace: a CPU run writes no device metric
        device_info.update(busy_s=0.0, window_s=0.0)
    else:
        # a process's first profile can record no device event (torch
        # 2.11): it is thrown away, and one that recorded nothing is taken
        # again
        trace_block(run, n_traces, dev, 1)
        for _ in range(3):
            by_name, intervals, wall, counters, telemetry = trace_block(
                run, n_traces, dev, TRACE_RUNS)
            if intervals:
                break
            log("trace: the profiler recorded no device event; taken again")
        lane = 1 if config["recirculation"] else 0
        ctx = TraceContext(
            kernels=by_name, device_events=len(intervals),
            busy_s=union_seconds(intervals), window_s=wall,
            steps=TRACE_RUNS * (steps + window + lane), counters=counters,
            telemetry=telemetry, config=config)
        for m in c["per_layer"]:
            value = load_reader(c["metrics_dir"], m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        device_info.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        breakdown = dict(device_ops=[[n[:120], v[1]] for n, v in top],
                         idle_gaps=idle_gaps(intervals))
        log(f"trace: {TRACE_RUNS} scenario runs, {ctx.steps} engine steps, "
            f"{ctx.device_events} device events, busy {ctx.busy_s:.6f} s "
            f"of {wall:.6f} s")
    device_info["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    # -- correctness: a seeded sample of the window's results --------------
    checked = rng.sample(sorted(kept), min(mix["checked"], len(kept)))
    kept = {i: kept[i] for i in checked}   # the others' memory is freed
    del any_res, batches
    sw, rchain = build_reference(config, mix, rules)
    checks = dict.fromkeys(CHECK_NAMES, 0)
    failed = 0
    t0 = time.perf_counter()
    for i in checked:
        want = ref.run(sw, rchain, traces[i])
        got = diff(program_output(kept.pop(i)), want)
        del want
        failed += any(got.values())
        for k, v in got.items():
            checks[k] += v
    log(f"check: scenarios {checked} of {n_traces} against the reference "
        f"in {time.perf_counter() - t0:.3f} s")
    correct = bool(checked) and not any(checks.values())
    out = dict(correct=correct, attempted=runs, failed=failed,
               metrics=metrics, device=device_info)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: dict(value=v, limit=0) for k, v in checks.items()}
    return out


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)["cell"]
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards; "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    # one process with one CPU thread: the host's share of a step is
    # Python and launches, and idle pool threads only contend for cores
    torch.set_num_threads(1)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {found}", file=sys.stderr)
        return 1
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
