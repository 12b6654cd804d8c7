"""Run the PyTorch port's dataplane, LM stack and training on one NVIDIA
card and check them.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero):

1. Card and build: the card's name and power limit (``nvidia-smi``), then
   ``nvcc`` builds the CUDA kernels from ``src/repro_torch/csrc``.
2. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes plus edge cases (B = 256 and 264, M = 4096, W = 160 and
   352, R = 1 and 20, duplicate and masked rows, every packet of a pipe
   naming one row, two masked packets on one row; maglev at (P, B) =
   (2, 256), (2, 320) and (1, 264) with a shared 251-entry table, a
   per-pipe table mixing the live and degraded tables, a 65537-entry table
   and dead rows), compared exactly.  Split's and Merge's control kernels
   (``split_control``, ``merge_stage``) are held exactly against their
   plain versions (registers, tables, decisions, CRCs, gathered rows) at
   8 pipes x 256 packets, M 4096, W 160 and 352, on a table smaller than
   the batch (M 64, 256 packets), without a pipe axis, with every packet
   masked, and for Merge on returning packets with flipped CRCs,
   out-of-range and negative tags with valid CRCs, explicit drops,
   duplicate tags and a second match with pp_clk 0 after a free; and for
   the kernel's blocks of slot ranges, contested slots on both sides of a
   range boundary, M 4100 (15 ranges of 288 slots) and every packet on one
   slot (each case prints its blocks a pipe, N).  Merge's packet
   transformation (``merge_payload``) is held exactly against its plain
   version (payload, length, alive, pp_valid and the five pp_* fields) at
   both benchmark cells' shapes (256 x 256 and 512 x 256 packets of pmax
   1450, W 160 and 352), at pmax 100 and 300 below W, at pmax 13, with two
   pipe axes and none, on strided rows, and at B = 0 (no launch), its
   inputs unchanged.  Split's kernel also at
   1 x 4096 packets over M 64 (each slot walked dozens of times, also
   against ``ref.split_rounds``), M 4100, TI at M - 1 with CLK at its
   wrap, and past its shared memory (its packet lists in a device-memory
   scratch) at 1 x 17879 packets over M 4096 and at 1 x 11000 over M 2**20
   (no slot named twice), both also against ``split_rounds``.  The NF
   chain's kernel
   (``nf_chain``) is held exactly against its plain version (headers,
   drops, NAT tables, ``stale_hits``, states) on FW -> NAT at 8 pipes x
   256 packets, FW -> NAT -> LB with a per-pipe ``lb_up`` mix, NAT alone
   at capacity 8, 12 (every probe window overlaps) and 16 (exhaustion,
   CLOCK aging, stale hits), one flow 256 times (256 waves), flows hashing
   into the table's last 12 or first 4 slots (windows wrap), 3 flows
   repeated in a batch, no pipe axis with a 0-d flag, 1 x 2048 (8 schedule
   chunks), capacity 16384 (shared memory near full) and 32768 (the walk
   in device memory; also with 3 flows repeated), the MAC swap alone and a
   chain of 12 NFs, past the stage limit (two launches); each case prints
   its NAT wave depth (``ref.nat_waves``).  Past the one-block limits:
   ``payload_store`` at 1 pipe x 16384 packets (M 4096, W 160, the same
   row on both sides of the tile boundary) in two launches of at most
   12288 packets, and ``merge_stage`` at M = 2**20, B = 256 (128 blocks of
   8192 slots, in shared memory) on honest and contested tags, each exact
   and timed beside its plain version, at 1 x 14336 packets (past the
   227 KB of shared memory, in a device-memory scratch), and at the largest
   batch in shared memory and 1 x 13487 and 1 x 13488 packets at M 4096
   (whose layout falls in the kernel's 48 B of static shared memory, so in
   the scratch), each followed by further calls, all exact.  Each
   wrapper call must add exactly one
   launch to its kernel's count (``nf_chain`` one per 8 stages,
   ``payload_store`` one per tile).  Each
   kernel is timed (median of 30 launches, CUDA events; ``split_control``
   also at the stream's 1 x 256 and 1 x 64 and the chain's 2 x 256,
   ``SPLIT_SHAPES``; ``merge_payload`` at the two benchmark cells'
   shapes) beside its plain version, one PyTorch library call
   where one computes the same function, and its bound: the larger of
   the bytes it must move over
   3.35 TB/s and its 32-bit operations over 67 T/s.
3. The quickstart flow at full width (enterprise, 256 packets, default
   ParkConfig, Firewall -> NAT): Split, chain and Merge on the card,
   wire-identical to the chain run on whole packets.
4. The engine at full geometry: ``run_pipes`` with 8 pipes over 16384
   steered enterprise packets (chunk 256, window 2, capacity 4096,
   max_exp 2, pmax 2048, 20 firewall rules -> NAT), and ``run_engine`` with
   one recirculating pipe (352-byte rows) over 4096 of those packets, each
   on the card with the kernels and on the CPU with the plain versions
   from the same seeded inputs (the CPU run also prints the NAT wave depth
   of every pipe's NAT call); counters, telemetry, NF counters,
   occupancy and merged wire bytes must be identical, the goodput gain
   positive, and every kernel of the path launched during each card run:
   ``split_control`` once per Split call, ``merge_stage`` and
   ``merge_payload`` once per Merge call and ``nf_chain`` once per
   ``Chain.run`` call; the standalone ``crc16`` and ``payload_fetch``
   never (their code runs inside the first two), nor ``acl_match`` and ``maglev`` (theirs runs inside
   ``nf_chain``).
5. The §7 chain: the ``chain`` scenario family at full geometry (FW ->
   NAT -> Maglev LB; datacenter and enterprise traffic from a 1024-flow
   pool, 16384 packets, capacity 4096, max_exp 4, parking with and without
   recirculation) through ``run_matrix`` on the card (backend ``auto``)
   and on the CPU from the same seed, one ``run_matrix`` call per batched
   group of two points.  Per point the counters, telemetry, NF counters,
   occupancy and gain must be identical; ``verify_oracle`` must hold on
   every CPU point; the datacenter gain must be positive and higher with
   recirculation; the four kernels of the chain must launch during the
   card run, with the same counts per Split, Merge and ``Chain.run`` call
   as phase 4.
5a. Fabric: phase 4's ``pipes8`` through ``run_pipes(devices=n)`` for n
   = 1, 2, 8 (``FABRIC_DEVICES``): 8 logical devices
   (``distributed.force_host_devices``), the n shards of 8 / n pipes run
   in turn on the one card; then phase 5's recirculation group at
   ``devices=2`` through ``run_matrix``.  Each identical to its
   one-device run and to the CPU run of phase 4 / 5 (counters, telemetry,
   NF counters, occupancy, merged wire bytes), with the launches per
   Split, Merge and ``Chain.run`` call of phase 4 (about n times the
   one-device counts, as found); the wall, offered pkt/s and launches per
   device count beside the card's name and power limit.
6. Parked-KV serving at full width: ``repro_torch.launch.serve`` on
   Qwen2.5-3B (full config, 36 layers, weights from a seeded generator on
   the card), 4 requests of prompt 128 and gen 32, max_batch 4, 16-token
   pages, 256 pages, request 2 cancelled after 16 decode steps; once with
   the ``paged_attention`` kernel (backend ``auto``) and once replayed,
   teacher-forced, with the plain version on the card.  Pool counters,
   pages, generations, drops and header/payload bytes must be identical;
   splits = merges + explicit drops + evictions + occupancy with occupancy
   0; the logits within 0.25 of each other; the generated tokens equal
   wherever the plain top-2 margin exceeds twice that error; and the
   kernel launched exactly layers x token steps times.  Then reduced
   Gemma-7B through the reference test's lifecycle (admit two, three
   steps, finish, cancel) on the card and on the CPU from the same
   weights: integer stats identical, logits within 0.08.
7. Traces, after the timed runs of phases 2-6: the first steps of the 8-pipe run, of
   each chain group, of a serving prefill and of a stream segment, timed
   untraced and then repeated under ``torch.profiler``, give device
   kernels per step and the device's busy time against the untraced wall
   time.  One traced call of
   ``split_control``, ``merge_stage``, ``payload_store``, ``nf_chain``,
   ``merge_payload`` (256 x 256 x 1450) and of ``paged_attention``
   (engine and batched shapes) must each run
   exactly one device kernel (``split_control`` at each of
   ``SPLIT_SHAPES``); its duration goes into the kernels line
   (``profiler_ms``).
8. Stream: the streaming driver at the reference streaming bench's full
   geometry: a ``SyntheticSource`` of 1024 steps x 256 packets (pmax 2048,
   a 1,000,000-flow pool, diurnal load of period 512, seed 0) through
   ``run_stream`` (capacity 4096, max_exp 2, recirculation with a 0.25
   lane, NAT at capacity 16384, window 2, segments of 128, reservoir 4096)
   on the card.  ``replay_oracle`` over the first 4 segments on the card
   (streamed = materialized exactly); the first 2 segments of 32 steps on
   the card and on the CPU identical (counters, telemetry, NF counters,
   peak occupancy, latency, occupancy segments); the whole run with a
   positive goodput gain, p50/p99/p999, peak device memory (after a
   2-segment run) grown by at most one segment's trace, and
   ``split_control`` / ``merge_stage`` / ``nf_chain`` launched once per
   Split / Merge / ``Chain.run`` call; then 128 steps in segments of 48,
   card against CPU, twice: 352-byte rows with the lane (window 2) and
   160-byte rows without it (window 1).
9. Adversarial: the ``adversarial`` family at full geometry (11 points:
   ``exhaust_f{00,25,75}_b{8,64}``, ``churn_{slow,fast}``,
   ``lb_kill_recover``, ``failover_{drain,drop}``) through ``run_matrix``
   on the card (backend ``auto``) and on the CPU from the same seed, one
   call per batched group: per point identical results, identical
   ``degradation_block``s, every gate ok but the one the reference fails
   too at this geometry (``KNOWN_FRAGILE_GATES``, reported), and the
   launches per call of phase 4; ``verify_oracle`` (the host loop on the
   card) on every card point.
10. LM: Mixtral-8x7B at full width (16 of its 32 layers: all 32 do not
    fit in 80 GB; seeded random weights drawn one layer slice at a time)
    served like phase 6 (4 requests of 64 + 16 tokens, request 2
    cancelled after 8 steps) with the ``paged_attention`` kernel and
    replayed with the plain version, the kernel shadowing every plain call
    on the replay's inputs within the reference's tolerances; logits are
    compared on the token steps whose request was routed alike by every
    MoE layer in both runs so far (a near tie rounded apart changes the
    request's KV history; the first such step is printed with its top-k
    margin), launches = layers x token steps.  Then ``LM.prefill`` of 128
    tokens + one ``decode_step`` against ``LM.forward_train`` (batch 2, MoE
    capacity 8.0) at full width on the six configs of ``LM_STACK``, each
    within the reference's relative 0.06; past it, the same run with the
    weights cast to f32 layer by layer must hold it (else a fault), and
    the bf16 logits are held to the f32 run's within 0.25 at the
    positions routed alike.  After each of the six, one more decode from
    the same cache with ``decode_carry_cache`` and
    ``assume_uniform_decode`` (the positions are uniform there), under the
    same routing: its logits bit for bit the functional decode's and the
    cache it returns the caller's tensors (same storage), both decode
    walls and peaks of device memory printed beside the card's name and
    power limit.  RecurrentGemma-9B's full 38 layers overflow
    in the reference's own model (ROADMAP C0g): reported, and the run is
    held again on its first 8 layers.  Then the ten reduced configs'
    forward, prefill and decode, card against CPU from the same weights,
    logits within 0.08 (past it, within twice the CPU run's own bf16 error
    against its f32 run).  Walls, tokens/s and peak device memory go into
    an ``lm`` JSON line.
11. Train (no kernel of the port lies on this path; every launch count of
    the phase must stay 0): ``launch.train`` on reduced Qwen2.5-3B and
    Mixtral-8x7B for 10 steps on the CPU and on the card from the same
    parameters and batches, the card taking the CPU run's MoE routing
    (the steps where its own router would differ are printed), loss
    curves within 0.01, the last grad norm within 0.01 relative and the
    parameters' update over the run within 0.15 relative; kill and resume on the card (20 steps saving at
    10, against 10 with ``stop_after`` then a resumed run) bit for bit
    under ``torch.use_deterministic_algorithms``; Qwen2.5-3B at its
    published widths (36 layers, seeded random weights) taking two AdamW
    steps on 2 x 1024 tokens of the synthetic stream under each remat
    policy (``minimal``, ``dots``, ``off``): finite losses, the second
    below the first, parameters moved, the three policies' first-step
    loss and grad norm within 1e-3 relative; each step's wall, its split
    at the gradient hook (forward + backward, ``apply_updates``) and the
    peak device memory beside the card's name and power limit, and a
    ``train`` JSON line.
11a. Model parallel, after the train phase has freed its memory: an NCCL
    process group of world size 1 (it raises if the group does not
    form) and a (1, 1) ("data", "model") mesh; the train phase's
    full-width Qwen2.5-3B weights and 2 x 1024 batch laid out by
    ``Rules.state_spec`` / ``batch_spec``, one AdamW step through
    ``train_step(..., shard=rules.act_shard())`` with ``vocab_parallel``
    off and on, each step's loss and grad norm within TRAIN_LOSS_ERR and
    TRAIN_GNORM_REL of the train phase's first ``minimal`` step (the
    exact differences and whether they are 0 printed); the same step
    over microbatches of one row, and with int8 error-feedback
    compression, each on the mesh against the same step without one
    (loss, grad norm and the parameters' update within the train phase's
    bounds, the exact differences printed); ``launch.train`` on the mesh
    against the run without one, without and with ``compress_grads``
    (reduced Qwen2.5-3B, ``MP_TRAIN_STEPS`` steps, the train phase's
    bounds);
    ``quantized_psum`` over the group on the card against the plain
    requantization, bit for bit.  No kernel launches; a ``fabric`` /
    ``model_parallel`` JSON line.
11b. The dry run (``launch/dryrun.py``), in a child process of its own
    (the parent holds an NCCL group; ``--dryrun-child OUT.json`` runs it
    alone): Qwen2.5-3B at its published widths, 4 of its 36 layers, one
    ``train_step`` on 2 x 1024 tokens over a one-rank NCCL (1, 1) mesh
    under ``FlopCounterMode``, against the dry run's trace of the same
    step on a (1, 1) fake mesh of device type ``cuda``: FLOPs equal, the
    predicted peak within 10 % of ``max_memory_allocated``; then
    ``run_cell`` on Qwen2.5-3B decode_32k over the 16 x 16 mesh and on
    Mixtral-8x7B decode_32k over 2 x 16 x 16 (full width and depth,
    fake process group, fake tensors): each ``ok``, its trace seconds and
    fit printed, no kernel launched, device memory unchanged; the phase
    within 120 s.  Then the example twins ``examples/torch_quickstart.py``
    and ``torch_parked_decode.py`` on the card, each in a process that
    must exit 0.  A ``dryrun`` JSON line.
12. The ``lm`` and ``kernels`` JSON lines (launches per path,
    ``launches_stream``, ``launches_adversarial``, ``launches_fabric``
    per device count and, for
    ``paged_attention``, ``launches_mixtral`` included), the card line,
    and the final ``ok`` line.

Phase 2 also holds ``paged_attention`` against its plain version within
the reference's atol 0.02 / rtol 0.05 at the reference's sweep shapes, the
engine's (B, K, G, E) = (1, 2, 8, 128) with 16-token pages, a batched
(8, 2, 8, 128) with up to 2048 tokens, Gemma's (2, 16, 1, 256), f32 and
head_dim 16, and -1 pages inside and after the length, a length on a page
boundary, lengths 1 and 0; and across the kernel's split-K boundaries: a
length ending mid-split, a split of -1 pages only inside the length,
splits wholly past the length, B = 1 with MP = 128 and length 17, G = 1 at
E = 256 over several splits, G = 20 (three blocks of query rows) and
4-token pages under 16-token tiles.  A request with no live token must
give zeros.  It is timed at the engine and batched shapes
beside ``F.scaled_dot_product_attention`` on K/V gathered beforehand (the
gather timed apart) and its bound: the larger of the live K/V, q, output
and page-table bytes over 3.35 TB/s and 4 B K G len E operations over
989 TFLOP/s.

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # non-tensor 32-bit rate, the same data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core rate, the same sheet
# 32-bit integer operations per packet: crc16 takes 4 byte extractions
# (2 ops), and per byte 12 (csrc/crc16.cuh: the byte-wise update); acl_match
# a compare and an or per rule.
CRC16_OPS = 4 * 2 + 4 * 12
# maglev: four multiply-xor steps, a mask and a modulo per packet
MAGLEV_OPS = 4 * 2 + 2
# NAT's walk per live packet: the hash (7), and per probe slot a wrap, two
# key compares, an expiry test and the three ballots' predicates (6), plus
# the rewrite (2)
NAT_OPS = 7 + 8 * 6 + 2
SEED = 20200611
RECIRC1_PACKETS = 4096  # the chain phase runs recirculation at full depth
PROFILE_STEPS = 2  # traced steps of each dataplane trace: each traced
                   # step costs ~24k device kernels of profiler bookkeeping,
                   # and with 4 steps the traces took over half the run
PROFILE_TOKENS = 8  # traced token steps of the serving prefill
# the reference streaming bench's full geometry
# (benchmarks/bench_streaming.py FULL)
STREAM = dict(steps=1024, chunk=256, pmax=2048, capacity=4096, window=2,
              segment_len=128, reservoir=4096, flows=1_000_000,
              load_period=512)
# degradation gates that the reference fails too on other seeds of the same
# geometry (ROADMAP C0f): reported, not required
KNOWN_FRAGILE_GATES = (("failover_drain", "recovery_steps"),)
CRC16_TPU = "src/repro/kernels/crc16/kernel.py:40"
FETCH_TPU = "src/repro/kernels/payload_fetch/kernel.py:49"
REPLACES = {
    "crc16": CRC16_TPU,
    "payload_store": "src/repro/kernels/payload_store/kernel.py:49",
    "payload_fetch": FETCH_TPU,
    "acl_match": "src/repro/kernels/acl_match/kernel.py:28",
    "maglev": "src/repro/kernels/maglev/kernel.py:37",
    "paged_attention": "src/repro/kernels/paged_attention/kernel.py:68",
    # the control kernels run crc16's (and payload_fetch's) device code
    # on Split's and Merge's path
    "split_control": CRC16_TPU,
    "merge_stage": f"{CRC16_TPU}, {FETCH_TPU}",
    # the NF chain's kernel runs acl_match's and maglev's device code
    "nf_chain": "src/repro/kernels/acl_match/kernel.py:28, "
                "src/repro/kernels/maglev/kernel.py:37",
    # Merge's packet transformation: no TPU kernel, the reference's jnp
    "merge_payload": "none (jnp in src/repro/core/park.py:416 merge_fn)",
}
# the kernels of the Split -> FW -> NAT -> Merge path (phase 4), and of the
# §7 chain (phase 5); the standalone crc16 and payload_fetch kernels are off
# those paths (their code runs inside split_control and merge_stage), and so
# are acl_match and maglev (their code runs inside nf_chain)
DATAPLANE_KERNELS = ("split_control", "payload_store", "merge_stage",
                     "nf_chain", "merge_payload")
CHAIN_KERNELS = DATAPLANE_KERNELS
INSIDE_CONTROL = ("crc16", "payload_fetch")
INSIDE_CHAIN = ("acl_match", "maglev")
# paged attention against its plain version: the reference's tolerances
# (tests/test_kernels.py), and the bounds of the serving phase
PAGED_ATOL, PAGED_RTOL = 0.02, 0.05
SERVE_LOGIT_ERR = 0.25     # full width: kernel run vs plain replay
# the LM phase's full-width runs: (config, layers on the card; None = all).
# Mixtral's 16 of 32 layers are the serving run's weights (~47 GB of
# bf16: all 32 do not fit in 80 GB); DeepSeek-V2 runs dense0 and 2 MoE
# layers, Qwen2-VL 16 of 80
LM_STACK = (("mixtral-8x7b", 16), ("deepseek-v2-236b", 3),
            ("qwen2-vl-72b", 16), ("recurrentgemma-9b", None),
            ("mamba2-1.3b", None), ("seamless-m4t-large-v2", None))
# full-depth runs whose residual stream overflows in the reference's own
# model (ROADMAP C0g: its recurrent blocks skip their pre-norm): reported,
# not required; the invariant is held again on the depth given here
OVERFLOWS_IN_REFERENCE = {"recurrentgemma-9b": 8}
LM_BATCH, LM_PREFILL, LM_CACHE_LEN = 2, 128, 160
LM_VISION_TOKENS = 64   # the VLM stub's patch embeddings, an 8 x 8 grid
LM_ENC_FRAMES = 128     # the speech stub's frames
# prefill + decode against forward (tests/test_decode_consistency.py)
SELF_REL = 0.06
REDUCED_LOGIT_ERR = 0.08   # reduced Gemma: card vs CPU (the reference's
                           # engine tolerance, tests/test_serving.py)
# the train phase: reduced configs card vs CPU (steps of launch.train's
# defaults: seq 128, batch 8); kill and resume; Qwen2.5-3B at full width,
# two AdamW steps on one (batch, seq) draw of the synthetic stream per
# remat policy.  Card vs CPU bounds (``train_gaps``) on the loss curve,
# the last step's grad norm and the parameters' update over the run: a
# learning rate 10 % off on one side moves these by 0.048-0.052,
# 0.025-0.032 and 0.23-0.27 on the CPU, a 2 % one by 0.011-0.014,
# 0.005-0.008 and 0.10-0.16 (tools/train_gap_sensitivity.py); the card
# against the CPU in PERF.md section 6
TRAIN_REDUCED = ("qwen2.5-3b", "mixtral-8x7b")
TRAIN_STEPS = 10
TRAIN_LOSS_ERR = 0.01
TRAIN_GNORM_REL = 0.01
TRAIN_UPDATE_REL = 0.15
FULL_TRAIN_SHAPE = (2, 1024)
REMAT_REL = 1e-3


def device_ms(fn, reps: int = 30) -> float:
    """Median device time of one call of ``fn``, in ms.  A sleep kernel
    keeps the card busy while the host enqueues each call, so the events
    bracket device work and not launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    cycles = int(host_s * 4e9) + 200_000
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def once(name: str, fn, *args):
    """``fn(*args)``, a kernel wrapper, which must add exactly one launch
    to kernel ``name``'s count."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()[name]
    out = fn(*args)
    n = launch_counts()[name] - before
    if n != 1:
        raise AssertionError(f"{name}: one wrapper call added {n} launches "
                             "to its count, not 1")
    return out


def must_equal(name: str, got, want) -> int:
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max abs err {err}")
    return err


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def store_inputs(gen, pipes, b, m, w, dev, dups=True):
    table = torch.randint(0, 256, (pipes, m, w), generator=gen,
                          dtype=torch.uint8)
    payload = torch.randint(0, 256, (pipes, b, w), generator=gen,
                            dtype=torch.uint8)
    idx = torch.stack([torch.randperm(m, generator=gen)[:b]
                       for _ in range(pipes)]).to(torch.int32)
    enb = torch.rand((pipes, b), generator=gen) < 0.7
    if dups:  # duplicate enabled rows, and rows out of range
        idx[:, 5] = idx[:, 1]
        idx[:, 9] = idx[:, 1]
        enb[:, [1, 5, 9]] = True
        idx[:, 12] = -1
        idx[:, 13] = m + 3
    return [x.to(dev) for x in (table, payload, idx, enb)]


def fetch_inputs(gen, pipes, b, m, w, dev):
    table = torch.randint(0, 256, (pipes, m, w), generator=gen,
                          dtype=torch.uint8)
    idx = torch.stack([torch.randperm(m - 1, generator=gen)[:b]
                       for _ in range(pipes)]).to(torch.int32)
    mask = torch.rand((pipes, b), generator=gen) < 0.6
    idx = torch.where(mask, idx, 0)   # masked-off rows carry pp_ti = 0
    idx[:, 3] = m + 7                 # matched, out of range: clamped read
    mask[:, 3] = True
    return [x.to(dev) for x in (table, idx, mask)]


def maglev_inputs(gen, pipes, b, dev, dead=(7,)):
    """Five (pipes, b) int32 header fields over the whole int32 range;
    the ``dead`` rows are all zero, as the engine's dead rows are."""
    fields = [torch.randint(-(1 << 31), (1 << 31) - 1, (pipes, b),
                            generator=gen, dtype=torch.int32)
              for _ in range(5)]
    for f in fields:
        f[:, list(dead)] = 0
    return [f.to(dev) for f in fields]


def maglev_tables(gen, pipes, dev) -> dict:
    from repro_torch.nf.maglev import MaglevLB, build_table, degraded_table
    lb = MaglevLB()
    live = torch.from_numpy(build_table(lb.backends, 251))
    down = torch.from_numpy(degraded_table(lb.backends, 251, 3))
    big = torch.randint(0, len(lb.backends), (pipes, 65537), generator=gen,
                        dtype=torch.int32)
    tables = {
        "shared 251": live,
        "per-pipe 251": torch.stack([(down if p % 2 == 0 else live)
                                     for p in range(pipes)]),
        "shared 65537": big[0],
        "per-pipe 65537": big,
    }
    return {k: v.to(dev) for k, v in tables.items()}


def check_kernels(dev) -> dict:
    from repro_torch.backend import ref as R
    from repro_torch.kernels import acl_match, crc16, maglev, payload_fetch
    from repro_torch.kernels import payload_store
    from repro_torch.nf.maglev import MaglevLB

    gen = torch.Generator().manual_seed(SEED)
    err = dict.fromkeys(REPLACES, 0)
    for n in (256, 264, 2048):
        ti = torch.randint(0, 65536, (n,), generator=gen, dtype=torch.int32)
        clk = torch.randint(1, 65536, (n,), generator=gen, dtype=torch.int32)
        ti, clk = ti.to(dev), clk.to(dev)
        err["crc16"] = max(err["crc16"], must_equal(
            f"crc16 n={n}", once("crc16", crc16.crc16_tag_cuda, ti, clk),
            R.crc16_tag(ti, clk)))
    for b in (256, 264):
        for r in (1, 20):
            ip = torch.randint(0, 64, (8, b), generator=gen,
                               dtype=torch.int32).to(dev)
            rules = torch.randint(0, 64, (r,), generator=gen,
                                  dtype=torch.int32).to(dev)
            err["acl_match"] = max(err["acl_match"], must_equal(
                f"acl_match b={b} r={r}",
                once("acl_match", acl_match.acl_match_cuda, ip, rules),
                R.acl_match(ip, rules)))
    for pipes, b, w in ((8, 256, 160), (1, 264, 352), (1, 264, 160),
                        (8, 264, 352)):
        t, p, i, e = store_inputs(gen, pipes, b, 4096, w, dev)
        # every packet of a pipe names one row (pipe 0 as -1, the last row)
        one = torch.arange(pipes, device=dev)[:, None] * 11 + 3
        one = one.expand(pipes, b).to(torch.int32).clone()
        one[0] = -1
        for label, ix, en in (("", i, e), (" all-off", i, torch.zeros_like(e)),
                              (" one row", one, e),
                              (" one row all-on", one, torch.ones_like(e))):
            got = once("payload_store", payload_store.payload_store_cuda,
                       t.clone(), p, ix, en)
            want = R.payload_store(t.clone(), p, ix, en)
            err["payload_store"] = max(err["payload_store"], must_equal(
                f"payload_store {pipes}x{b}x{w}{label}", got, want))
        t, i, mk = fetch_inputs(gen, pipes, b, 4096, w, dev)
        # two masked packets on one row (a second Merge match with pp_clk
        # 0 after a free): both receive the row, read before the clear
        i2, mk2 = i.clone(), mk.clone()
        i2[:, 1] = i2[:, 0]
        mk2[:, :2] = True
        for label, ix, mm in (("", i, mk),
                              (" all-off", i, torch.zeros_like(mk)),
                              (" one row twice", i2, mk2)):
            g1, t1 = once("payload_fetch", payload_fetch.payload_fetch_cuda,
                          t.clone(), ix, mm)
            g2, t2 = R.payload_fetch(t.clone(), ix, mm)
            err["payload_fetch"] = max(
                err["payload_fetch"],
                must_equal(f"payload_fetch rows {pipes}x{b}x{w}{label}",
                           g1, g2),
                must_equal(f"payload_fetch table {pipes}x{b}x{w}{label}",
                           t1, t2))
    bips = torch.tensor(MaglevLB().backends, dtype=torch.int32, device=dev)
    for pipes, b in ((2, 256), (2, 320), (1, 264)):
        fields = maglev_inputs(gen, pipes, b, dev, dead=(7, b - 1))
        for label, table in maglev_tables(gen, pipes, dev).items():
            err["maglev"] = max(err["maglev"], must_equal(
                f"maglev {pipes}x{b} {label}",
                once("maglev", maglev.maglev_select_cuda, *fields, table,
                     bips),
                R.maglev_select(*fields, table, bips)))
    err["split_control"], err["merge_stage"] = check_control(gen, dev)
    err["merge_payload"] = check_merge_payload(dev)
    err["nf_chain"] = check_nf_chain(gen, dev)
    big = check_past_limits(gen, dev)
    for name, r in big.items():
        err[name] = max(err[name], r.pop("max_abs_err"))
    torch.cuda.synchronize()
    print("kernels vs plain: exact on every case, one launch per call "
          "(B 256/264, W 160/352, R 1/20, duplicates, masked, out of range, "
          "every packet on one row, one row fetched twice; maglev (P, B) "
          "2x256/2x320/1x264, shared and per-pipe tables of 251 and 65537, "
          "dead rows; split_control, merge_stage, merge_payload and "
          "nf_chain as listed above)")
    return err, big


def tiled_store_inputs(gen, b, m, w, dev):
    """``payload_store``'s arguments for one pipe of ``b`` packets past
    ``MAX_PACKETS`` (rows drawn with repeats, 70 % enabled), with the same
    row named on both sides of each tile boundary: by the boundary's last
    and first packets, and by packets 8 before and 2 after it."""
    from repro_torch.kernels.payload_store import MAX_PACKETS
    table = torch.randint(0, 256, (1, m, w), generator=gen, dtype=torch.uint8)
    payload = torch.randint(0, 256, (1, b, w), generator=gen,
                            dtype=torch.uint8)
    idx = torch.randint(0, m, (1, b), generator=gen, dtype=torch.int32)
    enb = torch.rand((1, b), generator=gen) < 0.7
    for edge in range(MAX_PACKETS, b, MAX_PACKETS):
        for before, after in ((edge - 1, edge), (edge - 8, edge + 2)):
            idx[0, after] = idx[0, before]
            enb[0, [before, after]] = True
    return [x.to(dev) for x in (table, payload, idx, enb)]


def check_past_limits(gen, dev) -> dict:
    """Phase 2 past the kernels' one-block limits (sizes that once
    raised): ``payload_store`` at 1 pipe x 16384 packets, M 4096, W
    160 in consecutive tiles of ``MAX_PACKETS`` (two launches a call), and
    ``merge_stage`` at M = 2**20, B = 256 (128 blocks of 8192 slots, 7424 B
    of bitmaps and staged rows a block, in shared memory) on honest and
    contested tags, at 1 x 14336 packets, M 4096 (past the 227 KB of
    shared memory, so in a device-memory scratch), and around the block's
    limit less the kernel's 48 B of static shared memory: the largest batch
    in shared memory, then 1 x 13487 and 1 x 13488 (in the scratch), each
    followed by more calls that must succeed.  One launch a
    ``merge_stage`` call.  Each exact against its plain version, the first
    two timed beside it."""
    from repro_torch.backend import ref as R
    from repro_torch.kernels import launch_counts, merge_stage
    from repro_torch.kernels import payload_store as PS

    rows = {}
    b, m, w = 16384, 4096, 160
    t, p, i, e = tiled_store_inputs(gen, b, m, w, dev)
    tiles = -(-b // PS.MAX_PACKETS)
    before = launch_counts()["payload_store"]
    got = PS.payload_store_cuda(t.clone(), p, i, e)
    launches = launch_counts()["payload_store"] - before
    if launches != tiles:
        raise AssertionError(f"payload_store 1x{b}: {launches} launches, "
                             f"not {tiles} tiles")
    err = must_equal(f"payload_store 1x{b}x{w} in {tiles} tiles", got,
                     R.payload_store(t.clone(), p, i, e))
    # rows drawn with repeats: each distinct enabled row is written once,
    # from its last writer's payload, whatever the number of writers
    written = int(torch.unique(i[e]).numel())
    rows["payload_store"] = dict(
        max_abs_err=err, shape=f"1 x {b}, M {m}, W {w}", launches=tiles,
        ms=device_ms(lambda: PS.payload_store_cuda(t, p, i, e)),
        plain_ms=device_ms(lambda: R.payload_store(t, p, i, e), reps=5),
        bound_bytes=written * w * 2 + b * 5, bound_ops=0)
    print(f"payload_store 1x{b}x{w}, M {m}: exact in {tiles} launches "
          f"(duplicate rows across each tile boundary)")

    err = 0
    # C6: the largest batch in shared memory at M 4096, then the two whose
    # layout falls in the kernel's static 48 B (once refused, leaving a
    # stale error for the next call), each followed by further calls
    last = (merge_stage.MAX_SHARED - merge_stage.shared_bytes(0, 4096)) // 17
    for label, b, m, corrupt, in_scratch in (
            ("honest", 256, 1 << 20, False, False),
            ("last in shared memory", last, 4096, False, False),
            ("static-shared boundary", 13487, 4096, False, True),
            ("static-shared boundary", 13488, 4096, True, True),
            ("device-memory scratch", 14336, 4096, True, True),
            ("contested", 256, 1 << 20, True, False)):
        scratch = merge_stage.shared_bytes(b, m) > merge_stage.MAX_SHARED
        if scratch != in_scratch:
            raise AssertionError(f"merge_stage 1x{b} M {m}: shared memory "
                                 f"{merge_stage.shared_bytes(b, m)} B")
        margs = merge_args(gen, (1,), b, m, w, dev, corrupt)
        got = once("merge_stage", merge_stage.merge_stage_cuda,
                   margs[0].clone(), *margs[1:])
        want = R.merge_stage(margs[0].clone(), *margs[1:])
        err = max(err, same_all(f"merge_stage 1x{b} M {m} {label}", got,
                                want))
        if corrupt and not bool(want[1]["matched"][..., 7].all()):
            raise AssertionError(f"merge_stage 1x{b} M {m}: the second "
                                 "match after a free did not match")
        n, span = merge_stage.slot_ranges(m)
        print(f"merge_stage 1x{b}, M {m}, {label} tags: exact, one launch "
              f"of N {n} blocks of {span} slots, "
              f"{merge_stage.shared_bytes(b, m)} B a block in "
              f"{'device' if scratch else 'shared'} memory")
    matched = int(want[1]["matched"].sum())
    rows["merge_stage"] = dict(
        max_abs_err=err, shape=f"1 x {b}, M {m}, W {w}, contested tags",
        launches=1,
        ms=device_ms(lambda: merge_stage.merge_stage_cuda(*margs)),
        plain_ms=device_ms(lambda: R.merge_stage(*margs), reps=5),
        bound_bytes=24 * m + b * 31 + b * w + matched * w * 2,
        bound_ops=b * CRC16_OPS)
    for name, r in rows.items():
        bound(r)
        print(f"time {name} {r['shape']}: kernel {r['ms']:.6f} ms in "
              f"{r['launches']} launch(es), plain {r['plain_ms']:.6f} ms, "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}")
    return rows


def bound(r: dict, ops_per_s: float = FP32_OPS_PER_S) -> None:
    """``bound_ms`` and ``bound_by`` of a timing row from its bytes and
    operations."""
    by_bytes = r["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = r["bound_ops"] / ops_per_s * 1e3
    r["bound_ms"] = max(by_bytes, by_ops)
    r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"


def leaves(out) -> list:
    """The tensors of a primitive's output, in order (None skipped)."""
    if out is None:
        return []
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in leaves(v)]
    return [t for v in out for t in leaves(v)]


def control_state(gen, lead, m, max_exp, dev):
    """Registers and metadata tables of ``lead`` pipes, about 1 - 1 /
    (max_exp + 1) of the slots live, the clock 40 short of its wrap."""
    exp = torch.randint(0, max_exp + 1, lead + (m,), generator=gen,
                        dtype=torch.int32)
    gens = torch.where(exp > 0, torch.randint(
        1, 1 << 16, lead + (m,), generator=gen, dtype=torch.int32), 0)
    lens = torch.where(exp > 0, torch.randint(
        1, 161, lead + (m,), generator=gen, dtype=torch.int32), 0)
    ti = torch.randint(0, m, lead, generator=gen, dtype=torch.int32)
    clk = torch.full(lead, (1 << 16) - 40, dtype=torch.int32)
    return [x.to(dev) for x in (ti, clk, exp, gens, lens)]


def split_args(gen, cfg, lead, b, dev, alive_frac=0.9) -> list:
    """``split_control``'s arguments: ParkConfig's scalars, a state from
    ``control_state`` and packets of 0-1499 payload bytes."""
    ti, clk, exp, gens, lens = control_state(gen, lead, cfg.capacity,
                                             cfg.max_exp, dev)
    alive = torch.rand(lead + (b,), generator=gen) < alive_frac
    plen = torch.randint(0, 1500, lead + (b,), generator=gen,
                         dtype=torch.int32)
    return [cfg.capacity, cfg.max_exp, cfg.max_clk, cfg.min_park_len,
            cfg.pass_bytes, ti, clk, exp, gens, lens, alive.to(dev),
            plen.to(dev)]


def merge_args(gen, lead, b, m, w, dev, corrupt=False, plant=None) -> list:
    """``merge_stage``'s arguments: a random payload table, metadata from
    ``control_state`` and returning packets whose tags name live slots
    (distinct slots when B <= M), 10 % with a stale generation, 20 %
    explicit drops, header-less returns carrying zero tags as Split emits
    them.  ``corrupt`` plants, in every pipe, flipped CRCs (packets 0-1),
    an out-of-range and a negative tag with valid CRCs (2-3), a duplicate
    tag (5 repeats 4) and a second match with pp_clk 0 after a free (7
    names 6's live slot).  ``plant="boundary"`` adds two contested slots
    on either side of the kernel's first range boundary (packets 8-11:
    each slot matched, then matched again with pp_clk 0 after the free);
    ``plant="one slot"`` sends every packet to slot 5, a third of them
    with pp_clk 0."""
    from repro_torch.backend import ref as R
    from repro_torch.core.packet import OP_DROP
    from repro_torch.kernels.merge_stage import slot_ranges

    _, _, exp, gens, lens = control_state(gen, lead, m, 2, "cpu")
    table = torch.randint(0, 256, lead + (m, w), generator=gen,
                          dtype=torch.uint8)
    shape = lead + (b,)
    pipes = math.prod(lead)
    if b <= m:
        slots = torch.stack([torch.randperm(m, generator=gen)[:b]
                             for _ in range(pipes)]).reshape(shape)
    else:
        slots = torch.randint(0, m, shape, generator=gen)
    alive = torch.rand(shape, generator=gen) < 0.9
    valid = alive & (torch.rand(shape, generator=gen) < 0.97)
    enb = (torch.rand(shape, generator=gen) < 0.8).to(torch.int32)
    op = torch.where(torch.rand(shape, generator=gen) < 0.2, OP_DROP,
                     0).to(torch.int32)
    stale = torch.rand(shape, generator=gen) < 0.1
    if corrupt:
        slots[..., 5] = slots[..., 4]
        slots[..., 7] = slots[..., 6]
        exp.scatter_(-1, slots[..., 6:7], 1)
        gens.scatter_(-1, slots[..., 6:7], 77)
        alive[..., :8] = True
        valid[..., :8] = True
        enb[..., :8] = 1
        stale[..., :8] = False
    zero_clk = torch.zeros(shape, dtype=torch.bool)
    if plant == "boundary":
        edge = slot_ranges(m)[1]
        for k, v in ((8, edge - 1), (9, edge - 1), (10, edge), (11, edge)):
            slots[..., k] = v
        zero_clk[..., [9, 11]] = True
        picked = slice(8, 12)
    elif plant == "one slot":
        slots[...] = 5
        zero_clk[..., 1::3] = True
        picked = slice(None)
    if plant is not None:
        exp.scatter_(-1, slots[..., picked], 1)
        gens.scatter_(-1, slots[..., picked], 55)
        for x in (alive, valid):
            x[..., picked] = True
        enb[..., picked] = 1
        stale[..., picked] = False
    ti = slots.to(torch.int32)
    clk = torch.gather(gens, -1, slots)
    clk = torch.where(stale, clk + 1, clk)
    clk = torch.where(zero_clk, 0, clk)
    if corrupt:
        ti[..., 2], ti[..., 3] = m + 3, -1
        clk[..., 2] = clk[..., 3] = gens[..., m - 1]
        clk[..., 7] = 0
    ti = torch.where(enb == 1, ti, 0)
    clk = torch.where(enb == 1, clk, 0)
    crc = R.crc16_tag(ti, clk)
    if corrupt:
        crc[..., :2] ^= 1
    return [x.to(dev) for x in (table, exp, gens, lens, alive, valid, enb,
                                op, ti, clk, crc)]


def same_all(label, got, want) -> int:
    """Every tensor of a kernel's output against the plain version's."""
    got, want = leaves(got), leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} outputs, plain "
                             f"version {len(want)}")
    return max(must_equal(f"{label} output {k}", g, v)
               for k, (g, v) in enumerate(zip(got, want)))


# merge_payload at the benchmark cells' shapes (pod_fw_nat.enterprise,
# pod_chain_dc.datacenter): label, pipes, B, pmax, W
MERGE_PAYLOAD_CELLS = (("256x256 pmax 1450 W160", 256, 256, 1450, 160),
                       ("512x256 pmax 1450 W352", 512, 256, 1450, 352))


def merge_payload_args(gen, lead, b, pmax, w, dev) -> list:
    """``merge_payload``'s arguments, with decisions as ``merge_stage``
    makes them: 30 % of the packets header-less returns (disabled), 45 %
    matched (a tenth of them explicit drops), 5 % premature, 5 % CRC
    failures, the rest none of these.  A matched packet carries a parked
    prefix of 0..W bytes (zeros in the parked row otherwise) and what is
    left of 0..pmax bytes; in every pipe packet 0 ends exactly at pmax
    after its prefix is put back, packet 1 matches with a prefix of 0
    bytes and packet 2 returns header-less with a full payload."""
    shape = lead + (b,)
    u = torch.rand(shape, generator=gen)
    disabled, matched = u < 0.3, (u >= 0.3) & (u < 0.75)
    premature, crc_fail = (u >= 0.75) & (u < 0.8), (u >= 0.8) & (u < 0.85)
    drop = matched & (torch.rand(shape, generator=gen) < 0.1)
    park_len = torch.randint(0, w + 1, shape, generator=gen,
                             dtype=torch.int32)
    total = torch.randint(0, pmax + 1, shape, generator=gen,
                          dtype=torch.int32)
    if b >= 3:
        for x, v in ((matched, (True, True, False)), (drop, (False,) * 3),
                     (disabled, (False, False, True)),
                     (premature, (False,) * 3), (crc_fail, (False,) * 3)):
            x[..., :3] = torch.tensor(v)
        park_len[..., 0] = min(w, pmax)
        park_len[..., 1] = 0
        total[..., :3] = pmax
    park_len = torch.where(matched, park_len, 0)
    plen = torch.where(matched & ~drop, torch.clamp(total - park_len, min=0),
                       total).to(torch.int32)
    alive = torch.rand(shape, generator=gen) < 0.95
    valid = torch.rand(shape, generator=gen) < 0.9
    fields = [torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                            dtype=torch.int32) for _ in range(5)]
    payload = torch.randint(0, 256, shape + (pmax,), generator=gen,
                            dtype=torch.uint8)
    parked = torch.randint(0, 256, shape + (w,), generator=gen,
                           dtype=torch.uint8)
    parked = torch.where(matched[..., None], parked, 0)
    return [x.to(dev) for x in (payload, plen, alive, valid, *fields, parked,
                                matched, premature, crc_fail, disabled, drop,
                                park_len)]


def merge_payload_bound(args) -> dict:
    """What ``merge_payload`` must move on ``args``: every output byte
    written once; of a forwarded packet the restored and carried bytes
    under its new length read once, of any other packet its whole row; 35
    bytes of header fields and decisions read and 26 written a packet."""
    payload, plen, parked = args[0], args[1], args[9]
    matched, disabled, drop, park_len = args[10], args[13], args[14], args[15]
    pmax, w = payload.shape[-1], parked.shape[-1]
    fetch = matched & ~drop
    shift = torch.where(fetch, park_len, 0).to(torch.int64)
    end = torch.clamp(plen.to(torch.int64) + shift, 0, pmax)
    restored = torch.clamp(torch.minimum(shift, end), max=w)
    carried = torch.clamp(end - shift, min=0)
    reads = torch.where(disabled | fetch, restored + carried, pmax)
    n = plen.numel()
    return dict(bound_bytes=n * pmax + int(reads.sum()) + n * (35 + 26),
                bound_ops=0)


def check_merge_payload(dev) -> int:
    """Phase 2 for ``merge_payload``: every output against the plain version
    on the same inputs, exactly, at both benchmark cells' shapes, at a
    ``pmax`` below W (160 and 352), at pmax 13 (chunks across rows), with
    two pipe axes and none, on payload and parked rows that are views of
    wider rows (strided, read in place), and at B = 0 (no launch); the
    inputs stay as they were (the outputs are new tensors)."""
    from repro_torch.backend import ref as R
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import merge_payload as MP

    # a generator of its own, so that phase 2's other draws stay as they were
    gen = torch.Generator().manual_seed(SEED + 8)
    err = 0
    cases = [(label, (p,), b, pmax, w)
             for label, p, b, pmax, w in MERGE_PAYLOAD_CELLS] + [
        ("4x64 pmax 100 < W 160", (4,), 64, 100, 160),
        ("4x64 pmax 300 < W 352", (4,), 64, 300, 352),
        ("3x37 pmax 13 (chunks across rows)", (3,), 37, 13, 160),
        ("2x3x50 pmax 1000 W352 (two pipe axes)", (2, 3), 50, 1000, 352),
        ("no pipe axis, 264 packets pmax 2048", (), 264, 2048, 160),
        ("8x256 strided rows", (8,), 256, 1462, 176)]
    for label, lead, b, pmax, w in cases:
        args = merge_payload_args(gen, lead, b, pmax, w, dev)
        if "strided" in label:  # rows of 1450 and 160 bytes inside wider
            args[0], args[9] = args[0][..., 5:1455], args[9][..., 8:168]
        kept = [args[0].clone(), args[9].clone()]
        got = once("merge_payload", MP.merge_payload_cuda, *args)
        want = R.merge_payload(*args)
        err = max(err, same_all(f"merge_payload {label}", got, want))
        if not (torch.equal(args[0], kept[0]) and
                torch.equal(args[9], kept[1])):
            raise AssertionError(f"merge_payload {label}: an input changed")
        fwd = args[13] | (args[10] & ~args[14])
        print(f"merge_payload {label}: exact, one launch; "
              f"{int(fwd.sum())} of {fwd.numel()} packets forwarded")
    args = merge_payload_args(gen, (4,), 0, 1450, 160, dev)
    before = launch_counts()["merge_payload"]
    got = MP.merge_payload_cuda(*args)
    if launch_counts()["merge_payload"] != before:
        raise AssertionError("merge_payload B 0: launched")
    if [(t.shape, t.dtype) for t in got] != [
            (t.shape, t.dtype) for t in R.merge_payload(*args)]:
        raise AssertionError("merge_payload B 0: outputs differ in shape")
    print("merge_payload 4x0: no launch, empty outputs of the plain "
          "version's shapes")
    return err


# split_control's shapes on the paths (M 4096): pipes8's, the stream's
# fresh packets and its 0.25 recirculation lane's retries (352-byte rows),
# and a chain group's (max_exp 4)
SPLIT_SHAPES = (("", 8, 256, dict(max_exp=2)),
                ("1x256 W352", 1, 256, dict(max_exp=2, recirculation=True)),
                ("1x64 W352", 1, 64, dict(max_exp=2, recirculation=True)),
                ("2x256 chain", 2, 256, dict(max_exp=4)))


def split_shapes(gen, dev) -> dict:
    """``split_args`` at each of ``SPLIT_SHAPES``, by label ("" is
    pipes8's 8 x 256, drawn from ``gen``; the others from a generator of
    their own, so that they leave ``gen``'s later draws as they were)."""
    from repro_torch.core.park import ParkConfig
    own = torch.Generator().manual_seed(SEED + 6)
    return {label: split_args(gen if not label else own,
                              ParkConfig(capacity=4096, **kw), (pipes,), b,
                              dev)
            for label, pipes, b, kw in SPLIT_SHAPES}


def split_bound(args) -> dict:
    """``split_control``'s bound on ``args``: the tables and registers read
    and written once (they come out as new tensors), 5 bytes in and 20 out
    per packet; the CRC's operations."""
    m, ti, alive = args[0], args[5], args[10]
    n = alive.numel()
    return dict(bound_bytes=ti.numel() * (24 * m + 16) + n * 25,
                bound_ops=n * CRC16_OPS)


def check_control(gen, dev) -> tuple[int, int]:
    """Phase 2 for Split's and Merge's control kernels: every output
    against the plain version on the same inputs, exactly."""
    from repro_torch.backend import ref as R
    from repro_torch.core.park import ParkConfig
    from repro_torch.kernels import merge_stage, split_control

    e_split = e_merge = 0
    base = ParkConfig(capacity=4096, max_exp=2)
    m64 = ParkConfig(capacity=64, max_exp=2)
    scratch_b = split_control.MAX_SHARED // 13 + 1
    # the cases of the slot-range design draw from a generator of their
    # own, so that they leave ``gen``'s later draws as they were
    own = torch.Generator().manual_seed(SEED + 7)
    for g, (label, cfg, lead, b, frac, plain) in [(gen, c) for c in (
            ("8x256 M4096 W160", base, (8,), 256, 0.9, "loop"),
            ("8x256 M4096 W352",
             ParkConfig(capacity=4096, max_exp=2, recirculation=True),
             (8,), 256, 0.9, "loop"),
            ("1x256 M64 (batch larger than the table)", m64, (1,), 256, 0.9,
             "loop"),
            ("no pipe axis, 264 packets", base, (), 264, 0.9, "loop"),
            ("8x256 all masked", base, (8,), 256, 0.0, "loop"))] + [
            (own, c) for c in (
            ("1x4096 M64 (each slot walked dozens of times)", m64, (1,), 4096,
             1.0, "both"),
            ("8x256 M4100 (a ragged last range)",
             ParkConfig(capacity=4100, max_exp=2), (8,), 256, 0.9, "loop"),
            ("8x256 M4096, TI at M-1 and CLK at the wrap", base, (8,), 256,
             0.9, "loop"),
            (f"1x{scratch_b} M4096 (lists in device-memory scratch)", base,
             (1,), scratch_b, 0.9, "both"),
            ("1x11000 M2^20 (distinct slots, lists in device-memory "
             "scratch)", ParkConfig(capacity=1 << 20, max_exp=2), (1,),
             11000, 0.9, "both"))]:
        args = split_args(g, cfg, lead, b, dev, frac)
        if "at the wrap" in label:
            args[5].fill_(cfg.capacity - 1)
            args[6].fill_(cfg.max_clk - 1)
        got = once("split_control", split_control.split_control_cuda, *args)
        plains = dict(loop=(R.split_control,), rounds=(R.split_rounds,),
                      both=(R.split_control, R.split_rounds))[plain]
        for fn in plains:
            e_split = max(e_split, same_all(
                f"split_control {label} vs {fn.__name__}", got, fn(*args)))
        n, span = split_control.slot_ranges(cfg.capacity)
        scratch = split_control.shared_bytes(b, cfg.capacity) \
            > split_control.MAX_SHARED
        if scratch != ("scratch" in label):
            raise AssertionError(
                f"split_control {label}: "
                f"{split_control.shared_bytes(b, cfg.capacity)} B a block")
        print(f"split_control {label}: exact vs "
              f"{' and '.join(fn.__name__ for fn in plains)}; N {n} blocks a "
              f"pipe of {span} slots, {int(got[1]['enb'].sum())} parked, "
              f"{int(got[1]['evicted'].sum())} evicted, lists in "
              f"{'device' if scratch else 'shared'} memory")
    for label, lead, b, m, w, corrupt, masked, plant in (
            ("8x256 M4096 W160", (8,), 256, 4096, 160, False, False, None),
            ("8x256 M4096 W352", (8,), 256, 4096, 352, False, False, None),
            ("8x256 M4096 W160 corrupted", (8,), 256, 4096, 160, True, False,
             None),
            ("8x256 M4096 W352 corrupted", (8,), 256, 4096, 352, True, False,
             None),
            ("1x256 M64 (batch larger than the table)", (1,), 256, 64, 160,
             True, False, None),
            ("no pipe axis, 264 packets", (), 264, 4096, 160, True, False,
             None),
            ("8x256 all masked", (8,), 256, 4096, 160, False, True, None),
            ("8x256 M4096 W160, contested slots on a range boundary", (8,),
             256, 4096, 160, True, False, "boundary"),
            ("8x256 M4100 W160 corrupted", (8,), 256, 4100, 160, True, False,
             "boundary"),
            ("2x256 M4096 W160, every packet on slot 5", (2,), 256, 4096,
             160, False, False, "one slot")):
        table, *rest = merge_args(gen, lead, b, m, w, dev, corrupt, plant)
        if masked:
            rest[5] = torch.zeros_like(rest[5])  # pp_enb
        got = once("merge_stage", merge_stage.merge_stage_cuda,
                   table.clone(), *rest)
        want = R.merge_stage(table.clone(), *rest)
        e_merge = max(e_merge, same_all(f"merge_stage {label}", got, want))
        matched = want[1]["matched"]
        if corrupt and not bool(matched[..., 7].all()):
            raise AssertionError(f"merge_stage {label}: the second match "
                                 "after a free did not match")
        if plant == "boundary" and not bool(matched[..., 8:12].all()):
            raise AssertionError(f"merge_stage {label}: the boundary slots "
                                 "did not match twice each")
        n, span = merge_stage.slot_ranges(m)
        print(f"merge_stage {label}: exact; N {n} blocks a pipe of {span} "
              f"slots, {int(matched.sum())} matched")
    return e_split, e_merge


def nf_chain_inputs(gen, kinds, lead, b, cap, dev, flows=512, up=None,
                    alive=0.9, crowd=0):
    """``nf_chain``'s arguments for the chain ``kinds`` (``fw``: up to 10
    rules from the flow pool and 10 from outside it; ``nat``: capacity
    ``cap``; ``lb``: fault target 3,
    ``up`` its flag): packets of ``lead`` pipes x ``b`` drawn from
    ``flows`` (src_ip, src_port) flows, a share ``alive`` of them alive,
    and NAT tables with about a third of the slots live, a third aged out
    and a third free, their keys drawn from the same flows so that hits,
    stale hits and inserts all happen.  ``crowd`` > 0 draws the flows
    among those that hash into the table's last ``crowd`` slots or its
    first 4, so that the probe windows wrap at its end.  Returns
    ``(chain, fields, stages)``."""
    from repro_torch.backend.ref import NF_FIELDS, nat_hash
    from repro_torch.nf.chain import Chain
    from repro_torch.nf.firewall import Firewall
    from repro_torch.nf.macswap import MacSwap
    from repro_torch.nf.maglev import MaglevLB
    from repro_torch.nf.nat import Nat

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    shape = lead + (b,)
    pool_ip = ints(1, 1 << 30, (flows,))
    pool_port = ints(1024, 65536, (flows,))
    if crowd:
        ip, port = ints(1, 1 << 30, (1 << 20,)), ints(1024, 65536, (1 << 20,))
        h = nat_hash(ip, port, cap)
        near = ((h >= cap - crowd) | (h < 4)).nonzero()[:flows, 0]
        pool_ip, pool_port = ip[near], port[near]
    pick = torch.randint(0, flows, shape, generator=gen)
    fields = dict(
        alive=torch.rand(shape, generator=gen) < alive,
        src_ip=pool_ip[pick], dst_ip=ints(-(1 << 31), (1 << 31) - 1, shape),
        src_port=pool_port[pick], dst_port=ints(1024, 65536, shape),
        proto=torch.where(torch.rand(shape, generator=gen) < 0.8, 17,
                          6).to(torch.int32),
        src_mac=ints(0, (1 << 31) - 1, shape),
        dst_mac=ints(0, (1 << 31) - 1, shape))
    rules = tuple(int(v) for v in torch.cat([pool_ip[:min(10, flows // 4)],
                                             ints(1 << 30, 1 << 31, (10,))]))
    make = dict(fw=lambda: Firewall(rules=rules),
                nat=lambda: Nat(capacity=cap),
                lb=lambda: MaglevLB(fault_target=3), macswap=MacSwap)
    chain = Chain(tuple(make[k]() for k in kinds))
    pipes = lead[0] if lead else None
    states = []
    for nf, st in zip(chain.nfs, chain.init_state("cpu", pipes)):
        if isinstance(nf, Nat):
            tab = lead + (cap,)
            slot_flow = torch.randint(0, flows, tab, generator=gen)
            kind = torch.randint(0, 3, tab, generator=gen)
            st = dict(key_ip=torch.where(kind < 2, pool_ip[slot_flow], -1),
                      key_port=torch.where(kind < 2, pool_port[slot_flow],
                                           -1),
                      exp=torch.where(kind == 0, ints(1, nf.max_exp + 1, tab),
                                      0),
                      stale_hits=ints(0, 5, lead))
        if isinstance(st, dict):
            st = {k: v.to(dev) for k, v in st.items()}
        elif torch.is_tensor(st):
            st = st.to(dev)
        states.append(st)
    ctx = None if up is None else {"lb_up": up.to(dev)}
    stages = chain.stages(tuple(states), ctx)
    return chain, tuple(fields[f].to(dev) for f in NF_FIELDS), stages


def check_nf_chain(gen, dev) -> int:
    """Phase 2 for the NF chain's kernel: headers, drops, NAT tables and
    ``stale_hits`` against the plain version on the same inputs, exactly,
    one launch per call (two past the stage limit)."""
    from repro_torch.backend import ref as R
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import nf_chain as NC

    mix = torch.tensor([True, False, True, True, False, True, False, True])
    cases = (
        ("8x256 fw,nat C4096", ("fw", "nat"), (8,), 256, 4096, {}),
        ("1x256 nat C4096, one flow 256 times", ("nat",), (1,), 256, 4096,
         dict(flows=1, alive=1.0)),
        ("2x256 nat C4096, flows hashing into the last 12 or first 4 slots "
         "(windows wrap)", ("nat",), (2,), 256, 4096,
         dict(flows=64, crowd=12)),
        ("2x256 nat C12 (every window overlaps)", ("nat",), (2,), 256, 12,
         dict(flows=40)),
        ("1x2048 fw,nat C4096 (8 schedule chunks)", ("fw", "nat"), (1,),
         2048, 4096, {}),
        ("2x320 fw,nat C32768 in device memory, 3 flows repeated",
         ("fw", "nat"), (2,), 320, 32768, dict(flows=3)),
        ("8x256 fw,nat,lb C4096, per-pipe lb_up", ("fw", "nat", "lb"),
         (8,), 256, 4096, dict(up=mix)),
        ("2x256 nat C8 (exhaustion, CLOCK, stale hits)", ("nat",), (2,),
         256, 8, dict(flows=40)),
        ("2x256 nat C16", ("nat",), (2,), 256, 16, dict(flows=40)),
        ("2x256 fw,nat C64, 3 flows repeated", ("fw", "nat"), (2,), 256, 64,
         dict(flows=3)),
        ("no pipe axis, 264 fw,nat,lb C4096, lb_up 0-d down",
         ("fw", "nat", "lb"), (), 264, 4096, dict(up=torch.tensor(False))),
        ("2x320 fw,nat C16384 (shared memory near full)", ("fw", "nat"),
         (2,), 320, 16384, {}),
        ("2x320 fw,nat C32768 (walk in device memory)", ("fw", "nat"), (2,),
         320, 32768, {}),
        ("8x256 macswap", ("macswap",), (8,), 256, 8, {}),
        ("2x256 (fw,nat,lb,macswap) x 3, past the stage limit",
         ("fw", "nat", "lb", "macswap") * 3, (2,), 256, 64,
         dict(up=torch.tensor([True, False]))),
    )
    err = 0
    for label, kinds, lead, b, cap, kw in cases:
        _, fields, stages = nf_chain_inputs(gen, kinds, lead, b, cap, dev,
                                            **kw)
        # on copies of the fields: the plain version hands back the fields
        # that no stage writes, and so does the kernel, which must not
        # write into them
        want = R.nf_chain(tuple(f.clone() for f in fields), stages)
        launches = -(-len(stages) // NC.MAX_STAGES)
        before = launch_counts()["nf_chain"]
        got = NC.nf_chain_cuda(fields, stages)
        if launch_counts()["nf_chain"] - before != launches:
            raise AssertionError(f"nf_chain {label}: one call added "
                                 f"{launch_counts()['nf_chain'] - before} "
                                 f"launches, not {launches}")
        err = max(err, same_all(f"nf_chain {label}", got, want))
        nat = [k for k, st in enumerate(stages) if st.kind == "nat"]
        stale = sum(int(want[2][k].stale_hits.sum()
                        - stages[k].state.stale_hits.sum())
                    for k in nat)
        depth = nat_depths(fields, stages)
        waves = (f"NAT wave depth a pipe mean {statistics.mean(depth):.2f}, "
                 f"max {max(depth)}" if depth else "no NAT")
        print(f"nf_chain {label}: exact; {int(want[1].sum())} dropped, "
              f"{stale} stale hits, {launches} launch(es); {waves}")
        if "nat" in kinds and cap == 8 and not stale:
            raise AssertionError(f"nf_chain {label}: no stale hit to check")
    return err


def nat_depths(fields, stages) -> list[int]:
    """The wave depth (``ref.nat_waves``) of each pipe at each NAT stage of
    a chain, on the header fields that reach the stage."""
    from repro_torch.backend import ref as R
    depths = []
    for k, st in enumerate(stages):
        if st.kind == "nat":
            alive, src_ip, _, src_port = R.nf_chain(fields, stages[:k])[0][:4]
            waves = R.nat_waves(src_ip, src_port, alive, st.consts.capacity)
            depths += waves.reshape(-1, waves.shape[-1]).amax(-1).tolist()
    return depths


@contextlib.contextmanager
def recording_nat_depths():
    """The wave depth of each pipe of every NAT call that the plain version
    (``ref.nat_insert``) runs while the block runs: a CPU run, which the
    card run beside it must match exactly."""
    from repro_torch.backend import ref as R
    depths, plain = [], R.nat_insert

    def recorded(src_ip, src_port, alive, *rest):
        waves = R.nat_waves(src_ip, src_port, alive, rest[3])
        depths.extend(waves.reshape(-1, waves.shape[-1]).amax(-1).tolist())
        return plain(src_ip, src_port, alive, *rest)

    R.nat_insert = recorded
    try:
        yield depths
    finally:
        R.nat_insert = plain


def depth_line(label: str, depths: list[int]) -> str:
    return (f"{label}: NAT wave depth a pipe call mean "
            f"{statistics.mean(depths):.2f}, max {max(depths)} over "
            f"{len(depths)} pipe calls")


def nf_chain_bound(fields, stages) -> dict:
    """Bytes and operations ``nf_chain`` must spend on these inputs: the
    header fields that the stages read (``NF_READS``) read once and those
    they write (``NF_WRITES``) written once, and the drops written; each
    NAT table read and written once and its stale_hits; the rules, LB
    tables and backends read once.  Operations for the live packets only:
    2 per rule, NAT's walk, maglev's hash."""
    from repro_torch.backend.ref import NF_FIELDS, NF_READS, NF_WRITES
    alive = fields[0]
    n, live = alive.numel(), int(alive.sum())
    size = dict(zip(NF_FIELDS, (f.element_size() for f in fields)))
    read = {f for st in stages for f in NF_READS[st.kind]}
    written = {f for st in stages for f in NF_WRITES[st.kind]}
    nbytes = n * (sum(size[f] for f in read) + sum(size[f] for f in written)
                  + 1)
    ops = 0
    for st in stages:
        if st.kind == "fw":
            nbytes += st.state.rules.numel() * 4
            ops += live * 2 * st.state.rules.numel()
        elif st.kind == "nat":
            nbytes += 2 * 4 * sum(t.numel() for t in st.state)
            ops += live * NAT_OPS
        elif st.kind == "lb":
            lb = st.state
            nbytes += 4 * sum(t.numel() for t in (lb.table, lb.backend_ips,
                                                  lb.table_down)
                              if t is not None)
            ops += live * MAGLEV_OPS
    return dict(bound_bytes=nbytes, bound_ops=ops)


def time_kernels(dev) -> dict:
    """Times at the 8-pipe main path shapes: 8 pipes x 256 packets,
    M = 4096, W = 160, R = 20 (Split's and Merge's control kernels on
    ``split_args`` / ``merge_args`` inputs, max_exp 2; the NF chain FW ->
    NAT at capacity 4096 on ``nf_chain_inputs``); maglev, and the NF chain
    FW -> NAT -> LB, at the chain path's 2 pipes x 256 packets with the
    shared 251-entry table and 8 backends; ``split_control`` also at the
    stream's and the chain's shapes (``SPLIT_SHAPES``); ``merge_payload``
    at the benchmark cells' shapes (``MERGE_PAYLOAD_CELLS``)."""
    from repro_torch.backend import ref as R
    from repro_torch.kernels import acl_match, crc16, maglev, payload_fetch
    from repro_torch.kernels import merge_payload, merge_stage, nf_chain
    from repro_torch.kernels import payload_store, split_control
    from repro_torch.nf.maglev import MaglevLB, build_table

    gen = torch.Generator().manual_seed(SEED + 1)
    pipes, b, m, w = 8, 256, 4096, 160
    rows = {}

    ti = torch.randint(0, 4096, (pipes, b), generator=gen,
                       dtype=torch.int32).to(dev)
    clk = torch.randint(1, 65536, (pipes, b), generator=gen,
                        dtype=torch.int32).to(dev)
    n = ti.numel()
    rows["crc16"] = dict(
        ms=device_ms(lambda: crc16.crc16_tag_cuda(ti, clk)),
        plain_ms=device_ms(lambda: R.crc16_tag(ti, clk)),
        library_ms=None, bound_bytes=n * 12, bound_ops=n * CRC16_OPS)

    ip = torch.randint(0, 1 << 30, (pipes, b), generator=gen,
                       dtype=torch.int32).to(dev)
    rules = ip.flatten()[:20].clone()
    rows["acl_match"] = dict(
        ms=device_ms(lambda: acl_match.acl_match_cuda(ip, rules)),
        plain_ms=device_ms(lambda: R.acl_match(ip, rules)),
        library_ms=device_ms(lambda: torch.isin(ip, rules)),
        bound_bytes=n * 5 + rules.numel() * 4,
        bound_ops=n * rules.numel() * 2)

    t, p, i, e = store_inputs(gen, pipes, b, m, w, dev, dups=False)
    flat = t.view(pipes * m, w)
    pipe_off = (torch.arange(pipes, device=dev) * m)[:, None]
    sel = e.flatten()
    lib_rows = (i.to(torch.int64) + pipe_off).flatten()[sel]
    lib_src = p.reshape(pipes * b, w)[sel]
    enabled = int(sel.sum())
    rows["payload_store"] = dict(
        ms=device_ms(lambda: payload_store.payload_store_cuda(t, p, i, e)),
        plain_ms=device_ms(lambda: R.payload_store(t, p, i, e)),
        library_ms=device_ms(lambda: flat.index_copy_(0, lib_rows, lib_src)),
        bound_bytes=enabled * w * 2 + n * 5, bound_ops=0)

    t, i, mk = fetch_inputs(gen, pipes, b, m, w, dev)
    matched = int(mk.sum())
    rows["payload_fetch"] = dict(
        ms=device_ms(lambda: payload_fetch.payload_fetch_cuda(t, i, mk)),
        plain_ms=device_ms(lambda: R.payload_fetch(t, i, mk)),
        library_ms=None,
        bound_bytes=matched * w * 2 + n * w + n * 5, bound_ops=0)

    for label, args in split_shapes(gen, dev).items():
        rows[f"split_control {label}".strip()] = dict(
            ms=device_ms(lambda: split_control.split_control_cuda(*args)),
            plain_ms=device_ms(lambda: R.split_control(*args)),
            library_ms=None, **split_bound(args))

    margs = merge_args(gen, (pipes,), b, m, w, dev)
    _, d, _, _ = R.merge_stage(margs[0].clone(), *margs[1:])
    matched = int(d["matched"].sum())
    rows["merge_stage"] = dict(
        ms=device_ms(lambda: merge_stage.merge_stage_cuda(*margs)),
        plain_ms=device_ms(lambda: R.merge_stage(*margs)),
        library_ms=None,
        # the tables read and written once, 22 header bytes in and 9 of
        # decisions out per packet, the (B, W) rows out, each matched row
        # read once and cleared once (every tag here is in range)
        bound_bytes=pipes * 24 * m + n * 31 + n * w + matched * w * 2,
        bound_ops=n * CRC16_OPS)

    lb = MaglevLB()
    fields = maglev_inputs(gen, 2, 256, dev, dead=())
    table = torch.from_numpy(build_table(lb.backends, 251)).to(dev)
    bips = torch.tensor(lb.backends, dtype=torch.int32, device=dev)
    n = fields[0].numel()
    rows["maglev"] = dict(
        ms=device_ms(lambda: maglev.maglev_select_cuda(*fields, table, bips)),
        plain_ms=device_ms(lambda: R.maglev_select(*fields, table, bips)),
        library_ms=None,
        bound_bytes=n * 24 + table.numel() * 4 + bips.numel() * 4,
        bound_ops=n * MAGLEV_OPS)

    # the NF chain at pipes8's FW (20 rules) -> NAT (C 4096), and at the
    # chain path's 2 x 256 FW -> NAT -> LB beside it
    for key, kinds, lead in (("nf_chain", ("fw", "nat"), (8,)),
                             ("nf_chain chain", ("fw", "nat", "lb"), (2,))):
        _, nf_fields, stages = nf_chain_inputs(gen, kinds, lead, b, m, dev)
        depth = nat_depths(nf_fields, stages)
        print(f"time {key}: NAT wave depth a pipe mean "
              f"{statistics.mean(depth):.2f}, max {max(depth)}")
        rows[key] = dict(
            ms=device_ms(lambda: nf_chain.nf_chain_cuda(nf_fields, stages)),
            plain_ms=device_ms(lambda: R.nf_chain(nf_fields, stages)),
            library_ms=None, **nf_chain_bound(nf_fields, stages))
    # Merge's packet transformation at the two benchmark cells' shapes, from
    # a generator of its own
    own = torch.Generator().manual_seed(SEED + 9)
    for key, (_, mp_pipes, mp_b, pmax, mp_w) in zip(
            ("merge_payload", "merge_payload W352"), MERGE_PAYLOAD_CELLS):
        args = merge_payload_args(own, (mp_pipes,), mp_b, pmax, mp_w, dev)
        rows[key] = dict(
            ms=device_ms(lambda: merge_payload.merge_payload_cuda(*args)),
            plain_ms=device_ms(lambda: R.merge_payload(*args), reps=5),
            library_ms=None, shape=f"{mp_pipes} x {mp_b}, pmax {pmax}, "
            f"W {mp_w}", **merge_payload_bound(args))
        del args
    for name, r in rows.items():
        bound(r)
        print(f"time {name}: kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f}"
              f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.6f}"
              f" ms by {r['bound_by']} ({r['bound_bytes']} bytes, "
              f"{r['bound_ops']} operations)")
    return rows


# --------------------------------------------------------------------------
# phases 3 and 4: the dataplane on the card
# --------------------------------------------------------------------------

def quickstart(dev) -> None:
    from repro_torch.core.packet import wire_bytes
    from repro_torch.core.park import (ParkConfig, init_state, merge_fn,
                                       split_fn, stats)
    from repro_torch.nf.chain import Chain
    from repro_torch.nf.firewall import Firewall
    from repro_torch.nf.nat import Nat
    from repro_torch.switchsim.simulate import baseline_roundtrip
    from repro_torch.traffic.generator import enterprise

    wl = enterprise()
    pkts = wl.make_batch(SEED, 256, pmax=2048, device=dev)
    cfg = ParkConfig()
    state = init_state(cfg, dev)
    state, to_server = split_fn(cfg, state, pkts)
    chain = Chain((Firewall(rules=(int(pkts.src_ip[3]),)), Nat()))
    cstate, from_server, dropped, _ = chain.run(chain.init_state(dev),
                                                to_server)
    state, out = merge_fn(cfg, state, from_server)
    ref, _, _ = baseline_roundtrip(chain, pkts, device=dev)
    got, got_len = wire_bytes(out)
    want, want_len = wire_bytes(ref)
    if not (torch.equal(got, want) and torch.equal(got_len, want_len)):
        raise AssertionError("quickstart: merged packets differ on the wire "
                             "from the whole-packet chain run")
    print(f"quickstart: {wl.name} (mean {wl.mean_pkt_bytes:.1f} B), "
          f"wire-identical to the whole-packet chain (paper §6.2.6); "
          f"{stats(state)}")


def same(label: str, a, b) -> None:
    if isinstance(a, np.ndarray) or torch.is_tensor(a):
        ok = np.array_equal(np.asarray(torch.as_tensor(a).cpu()),
                            np.asarray(torch.as_tensor(b).cpu()))
    else:
        ok = a == b
    if not ok:
        raise AssertionError(f"{label}: card run differs from CPU run")


def compare_runs(label, gpu, cpu, per_pipe: bool) -> None:
    from repro_torch.core.packet import from_time_major, wire_bytes
    same(f"{label} counters", gpu.counters, cpu.counters)
    same(f"{label} telemetry", gpu.telemetry, cpu.telemetry)
    same(f"{label} nf_counters", gpu.nf_counters, cpu.nf_counters)
    same(f"{label} occ_series", gpu.occ_series, cpu.occ_series)
    if per_pipe:
        same(f"{label} per-pipe counters", gpu.per_pipe_counters,
             cpu.per_pipe_counters)
        same(f"{label} per-pipe telemetry", gpu.per_pipe_telemetry,
             cpu.per_pipe_telemetry)
        same(f"{label} per-pipe nf", gpu.per_pipe_nf_counters,
             cpu.per_pipe_nf_counters)
    for what, g, c in zip(("bytes", "lengths"),
                          wire_bytes(from_time_major(gpu.merged)),
                          wire_bytes(from_time_major(cpu.merged))):
        same(f"{label} merged wire {what}", g, c)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def device_busy(run, dev) -> dict:
    """Device kernels and device busy time of one traced run.  Only device
    activity is recorded: the measure reads device events alone, and
    recording every host-side operator as well made the traces take over
    half of the script's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(dev)
        sync(dev)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return dict(kernels=sum(v[0] for v in by_name.values()),
                busy_s=sum(v[1] for v in by_name.values()) / 1e6, top=top)


def one_kernel_per_call(dev) -> dict:
    """One traced call of ``payload_store``, ``split_control``,
    ``merge_stage`` and ``nf_chain`` (8 pipes x 256 packets, M 4096, W 160;
    FW -> NAT at capacity 4096; ``split_control`` also at each of
    ``SPLIT_SHAPES``), of ``merge_payload`` (the first benchmark cell's
    256 x 256 x 1450, W 160) and of ``paged_attention`` (engine and
    batched shapes), after a warm call, must each run exactly one device
    kernel: no fill, no scratch zeroing, no copy, no second pass.  Returns
    each kernel's duration by the profiler, in ms."""
    from repro_torch.kernels import (merge_payload, merge_stage, nf_chain,
                                     paged_attention, payload_store,
                                     split_control)

    gen = torch.Generator().manual_seed(SEED + 5)
    t, p, i, e = store_inputs(gen, 8, 256, 4096, 160, dev)
    sargs = split_shapes(gen, dev)
    margs = merge_args(gen, (8,), 256, 4096, 160, dev, corrupt=True)
    _, nf_fields, stages = nf_chain_inputs(gen, ("fw", "nat"), (8,), 256,
                                           4096, dev)
    # the same call with every packet dead: the table copies without the
    # walk, whose share of the kernel's duration the difference gives
    dead = (torch.zeros_like(nf_fields[0]),) + nf_fields[1:]
    _, mp_pipes, mp_b, pmax, mp_w = MERGE_PAYLOAD_CELLS[0]
    mp_args = merge_payload_args(torch.Generator().manual_seed(SEED + 9),
                                 (mp_pipes,), mp_b, pmax, mp_w, dev)
    runs = {"payload_store": lambda d: payload_store.payload_store_cuda(
                t, p, i, e),
            **{f"split_control {label}".strip():
               lambda d, args=args: split_control.split_control_cuda(*args)
               for label, args in sargs.items()},
            "merge_stage": lambda d: merge_stage.merge_stage_cuda(*margs),
            "merge_payload": lambda d: merge_payload.merge_payload_cuda(
                *mp_args),
            "nf_chain": lambda d: nf_chain.nf_chain_cuda(nf_fields, stages),
            "nf_chain, every packet dead": lambda d: nf_chain.nf_chain_cuda(
                dead, stages)}
    for name, args in (("engine", engine_paged(gen, dev)),
                       ("batched", batched_paged(gen, dev))):
        runs[f"paged_attention {name}"] = (
            lambda d, args=args:
            paged_attention.paged_decode_attention_cuda(*args))
    # a short profile taken right after a long one records no device
    # events (seen with torch 2.11), so a first profile is thrown away, and
    # a profile that recorded no device event at all is taken again (at
    # most twice); one with events must show exactly one kernel
    device_busy(runs["payload_store"], dev)
    durations = {}
    for label, run in runs.items():
        run(dev)
        prof = device_busy(run, dev)
        for _ in range(2):
            if prof["kernels"]:
                break
            print(f"profile {label}: no device event recorded, taken again")
            prof = device_busy(run, dev)
        names = [n for n, _ in prof["top"]]
        if prof["kernels"] != 1:
            raise AssertionError(f"{label}: one call ran {prof['kernels']} "
                                 f"device kernels ({names}), not 1")
        durations[label] = prof["busy_s"] * 1e3
        print(f"profile {label}: one call, one device kernel of "
              f"{durations[label]:.6f} ms ({names[0][:70]})")
    walk = durations["nf_chain"] - durations["nf_chain, every packet dead"]
    print(f"profile nf_chain: the NAT walk over 8 x 256 packets takes "
          f"{walk:.6f} ms, {walk / durations['nf_chain']:.3f} of the kernel")
    return durations


def profile_steps(label: str, run, dev, steps: int) -> None:
    """Device kernels per engine step and the top kernels of a traced run
    of ``steps`` steps.  No idle share: the busy time of a traced run over
    the wall of another, untraced run mixes two runs (the benchmark's
    ``device.idle_pct`` takes both from one traced block)."""
    prof = device_busy(run, dev)
    if prof["kernels"] == 0:
        print("profile: torch.profiler saw no device kernels; kernels per "
              "step not measured")
        return
    print(f"profile {label}, {steps} steps: {prof['kernels']} device "
          f"kernels ({prof['kernels'] / steps:.1f} per step), device busy "
          f"{prof['busy_s']:.6f} s")
    for name, (cnt, us) in prof["top"]:
        print(f"  {us / 1e3:12.3f} ms {cnt:8d}x {name[:90]}")


@contextlib.contextmanager
def path_calls():
    """Counts the Split, Merge and ``Chain.run`` calls made while the block
    runs, from the spans of ``repro_torch.trace`` (filled in when the block
    exits): a Split in each ``split`` span and, with the recirculation
    lane, one more a step (``recirc_fn``'s retry Split, in the step's
    first ``recirc`` span); a Merge in each ``merge`` span; a chain run in
    each ``nf_chain`` span and in each ``nf_probe`` span (the runner's
    cycle-cost probe of one NF alone)."""
    from repro_torch import trace

    calls: dict[str, int] = {}
    with trace.recording() as rec:
        yield calls
    n = collections.Counter(s.name for s in rec.spans)
    lane_steps = len({s.parent for s in rec.spans if s.name == "recirc"})
    calls.update(split_fn=n["split"] + lane_steps, merge_fn=n["merge"],
                 run=n["nf_chain"] + n["nf_probe"])


def check_launches(label, counts, calls, kernels) -> None:
    """Every kernel of the path launched; ``split_control`` once per Split
    call, ``merge_stage`` and ``merge_payload`` once per Merge call and
    ``nf_chain`` once per ``Chain.run`` call; the standalone ``crc16`` and ``payload_fetch``
    never (their code runs inside the first two), nor ``acl_match`` and
    ``maglev`` (theirs runs inside ``nf_chain``)."""
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched on the card: "
                             f"{missing}")
    want = {"split_control": calls["split_fn"],
            "merge_stage": calls["merge_fn"],
            "merge_payload": calls["merge_fn"], "nf_chain": calls["run"],
            **dict.fromkeys(INSIDE_CONTROL + INSIDE_CHAIN, 0)}
    wrong = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if wrong:
        raise AssertionError(f"{label}: launches (counted, wanted) {wrong}")


def engine(dev, packets: int = 16384):
    """Phase 4.  Returns the launch counts of each run, the runs to
    trace once every timed run is over, and the ``pipes8`` inputs with its
    card and CPU runs (for the fabric phase)."""
    from repro_torch.core.packet import map_fields, to_time_major
    from repro_torch.core.park import ParkConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nf.chain import Chain
    from repro_torch.nf.firewall import Firewall
    from repro_torch.nf.nat import Nat
    from repro_torch.switchsim.engine import (goodput_gain, run_engine,
                                              run_pipes)
    from repro_torch.traffic.generator import enterprise, steer_pipes

    chunk, window, pipes = 256, 2, 8
    pkts = enterprise().make_batch(SEED + 2, packets, pmax=2048,
                                   device="cpu")
    rules = tuple(int(v) for v in torch.unique(pkts.src_ip)[:20].tolist())
    chain = Chain((Firewall(rules=rules), Nat()))
    shards, st = steer_pipes(pkts, pipes, chunk=chunk)
    traces = map_fields(
        lambda n, a: a.reshape((pipes, a.shape[1] // chunk, chunk)
                               + a.shape[2:]), shards)
    cfg = ParkConfig(capacity=4096, max_exp=2, pmax=2048)
    steps = traces.src_ip.shape[1]
    print(f"engine: {packets} enterprise packets steered to {pipes} pipes, "
          f"{steps} steps of {chunk} per pipe (capacity {st['pipe_capacity']}"
          f", overflow {st['overflow']}), window {window}, 20 rules -> NAT")

    counts, kept = {}, {}
    runs = (
        ("pipes8", lambda d: run_pipes(cfg, chain, traces, window=window,
                                       device=d), True),
        ("recirc1", lambda d: run_engine(
            ParkConfig(capacity=4096, max_exp=2, pmax=2048,
                       recirculation=True), chain,
            to_time_major(map_fields(lambda n, a: a[:RECIRC1_PACKETS], pkts),
                          chunk), window=window, device=d), False),
    )
    for label, run, per_pipe in runs:
        sync(dev)
        reset_launch_counts()
        with path_calls() as calls:
            t0 = time.perf_counter()
            gpu = run(dev)
            sync(dev)
            wall = time.perf_counter() - t0
        counts[label] = launch_counts()
        with recording_nat_depths() as depths:
            t0 = time.perf_counter()
            cpu = run("cpu")
            cpu_wall = time.perf_counter() - t0
        compare_runs(label, gpu, cpu, per_pipe)
        gain = goodput_gain(gpu)["goodput_gain"]
        if not gain > 0:
            raise AssertionError(f"{label}: goodput gain {gain} <= 0")
        check_launches(label, counts[label], calls, DATAPLANE_KERNELS)
        pps = gpu.telemetry.wire_pkts / wall
        print(f"engine {label}: card {wall:.3f} s ({pps:.1f} offered pkt/s),"
              f" CPU {cpu_wall:.3f} s, goodput_gain {gain:.6f}, counters "
              f"{gpu.counters}, launches {counts[label]} for {calls}; "
              "identical to the CPU run")
        print(depth_line(f"engine {label}", depths))
        kept[label] = dict(card=gpu, cpu=cpu, wall=wall)
    head = map_fields(lambda n, a: a[:, :PROFILE_STEPS], traces)
    traced = [("pipes8", lambda d: run_pipes(cfg, chain, head, window=window,
                                             device=d),
               PROFILE_STEPS + window)]
    pipes8 = dict(cfg=cfg, chain=chain, traces=traces, window=window,
                  **kept["pipes8"])
    return counts, traced, pipes8


# --------------------------------------------------------------------------
# phase 5: the §7 FW -> NAT -> LB chain through the scenario runner
# --------------------------------------------------------------------------

def same_point(label: str, gpu, cpu) -> None:
    for what in ("counters", "telemetry", "nf_counters", "per_pipe_counters",
                 "per_pipe_telemetry", "per_pipe_nf_counters",
                 "per_pipe_peak_occupancy", "per_pipe_occ_series", "gain",
                 "steer_stats", "nf_cycles"):
        same(f"{label} {what}", getattr(gpu, what), getattr(cpu, what))


def chain_phase(dev):
    """Phase 5.  Returns the launch counts of the card run, the runs to
    trace once every timed run is over, and the groups with their card
    and CPU results (for the fabric phase)."""
    from repro_torch.core.packet import map_fields
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenarios import family, run_matrix, verify_oracle
    from repro_torch.switchsim.engine import run_pipes

    specs = family("chain")
    groups = [[s for s in specs if s.recirc is on] for on in (False, True)]
    s0 = specs[0]
    print(f"chain: {len(specs)} points (FW {s0.fw_rules} rules -> NAT -> "
          f"Maglev LB), {s0.packets} packets of a {s0.flows}-flow pool, "
          f"chunk {s0.chunk}, window {s0.window}, capacity {s0.capacity}, "
          f"max_exp {s0.max_exp}; groups {[[x.name for x in g] for g in groups]}")

    def run_groups(d):
        out, walls = {}, []
        for members in groups:
            sync(d)
            t0 = time.perf_counter()
            res = run_matrix(members, device=d)
            sync(d)
            walls.append(time.perf_counter() - t0)
            if [r.group_size for r in res] != [len(members)] * len(members):
                raise AssertionError(f"chain: {[m.name for m in members]} "
                                     "did not batch into one run_pipes call")
            out.update((r.spec.name, r) for r in res)
        return out, walls

    sync(dev)
    reset_launch_counts()
    with path_calls() as calls:
        gpu, gpu_walls = run_groups(dev)
    counts = launch_counts()
    with recording_nat_depths() as depths:
        cpu, cpu_walls = run_groups("cpu")
    print(depth_line("chain, both groups", depths))
    for name in gpu:
        same_point(f"chain {name}", gpu[name], cpu[name])
    for r in cpu.values():
        verify_oracle(r, device="cpu")
    gain = {k: r.gain["goodput_gain"] for k, r in gpu.items()}
    if not gain["datacenter_base"] > 0:
        raise AssertionError(f"chain: datacenter gain {gain} is not > 0")
    if not gain["datacenter_recirc"] > gain["datacenter_base"]:
        raise AssertionError(f"chain: recirculation does not raise the "
                             f"datacenter gain: {gain}")
    for name, r in gpu.items():
        print(f"chain {name}: goodput_gain {r.gain['goodput_gain']:.6f}, "
              f"link_byte_saving {r.gain['link_byte_saving']:.6f}, "
              f"counters {r.counters}, nf {r.nf_counters}, peak occupancy "
              f"{r.peak_occupancy}; identical to the CPU run, oracle holds")
    for members, gw, cw in zip(groups, gpu_walls, cpu_walls):
        offered = sum(gpu[m.name].telemetry.wire_pkts for m in members)
        print(f"chain group {[m.name for m in members]}: card {gw:.3f} s "
              f"({offered / gw:.1f} offered pkt/s), CPU {cw:.3f} s")
    print(f"chain launches on the card: {counts} for {calls}")
    check_launches("chain", counts, calls, CHAIN_KERNELS)
    # the first steps of each group's run_pipes call, to be traced
    traced = []
    for members in groups:
        pts = [gpu[m.name].prepared for m in members]
        head = map_fields(lambda n, *xs: torch.cat([x[:, :PROFILE_STEPS]
                                                    for x in xs]),
                          *(p.traces for p in pts))
        s1 = members[0]
        traced.append((f"chain {s1.name} group",
                       lambda d, s1=s1, ch=pts[0].chain, head=head: run_pipes(
                           s1.park_config(), ch, head, window=s1.window,
                           device=d),
                       PROFILE_STEPS + s1.window + int(s1.recirc)))
    return counts, traced, dict(groups=groups, card=gpu, cpu=cpu,
                                walls=gpu_walls)


# --------------------------------------------------------------------------
# the fabric: the pipe axis sharded over logical devices on the one card
# --------------------------------------------------------------------------

FABRIC_DEVICES = (1, 2, 8)


def fabric_phase(dev, pipes8, chain_runs):
    """The fabric phase: ``pipes8`` (phase 4's inputs) through
    ``run_pipes(devices=n)`` for n in FABRIC_DEVICES, the n shards run in
    turn on the one card (8 logical devices,
    ``distributed.force_host_devices``), each identical to phase 4's CPU
    run and to its own ``devices=1`` run; then the chain's recirculation
    group at 2 devices through ``run_matrix``, identical to phase 5's card
    and CPU runs.  Wall, offered pkt/s and launches per device count
    (launches are expected near the shard count times one device's, as
    found, not a target).  Returns (launch counts per device count, rows).
    """
    from repro_torch import distributed as D
    from repro_torch.device import card_line
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenarios import run_matrix
    from repro_torch.switchsim.engine import run_pipes

    card = card_line(dev)
    counts, rows = {}, {}
    saved = D.forced_host_devices()
    D.force_host_devices(max(FABRIC_DEVICES))
    try:
        one = None
        for n in FABRIC_DEVICES:
            sync(dev)
            reset_launch_counts()
            with path_calls() as calls:
                t0 = time.perf_counter()
                res = run_pipes(pipes8["cfg"], pipes8["chain"],
                                pipes8["traces"], window=pipes8["window"],
                                devices=n, device=dev)
                sync(dev)
                wall = time.perf_counter() - t0
            counts[n] = launch_counts()
            compare_runs(f"fabric devices={n}", res, pipes8["cpu"], True)
            if one is None:
                one = res
            else:
                compare_runs(f"fabric devices={n} vs 1", res, one, True)
            check_launches(f"fabric devices={n}", counts[n], calls,
                           DATAPLANE_KERNELS)
            pps = res.telemetry.wire_pkts / wall
            rows[f"pipes8_dev{n}"] = dict(
                wall_s=wall, offered_pkts_per_s=pps,
                launches={k: v for k, v in counts[n].items() if v})
            print(f"fabric pipes8 devices={n} ({n} shard(s) of "
                  f"{8 // n} pipe(s) in turn on {card}): wall {wall:.3f} s "
                  f"({pps:.1f} offered pkt/s; phase 4's one-device run "
                  f"{pipes8['wall']:.3f} s), launches "
                  f"{rows[f'pipes8_dev{n}']['launches']} for {calls}; "
                  "identical to devices=1 and to phase 4's CPU run")

        members = [dataclasses.replace(m, devices=2)
                   for m in chain_runs["groups"][1]]
        sync(dev)
        reset_launch_counts()
        with path_calls() as calls:
            t0 = time.perf_counter()
            res = run_matrix(members, device=dev)
            sync(dev)
            wall = time.perf_counter() - t0
        counts["chain_recirc_dev2"] = launch_counts()
        if [r.group_size for r in res] != [len(members)] * len(members):
            raise AssertionError("fabric: the chain's recirculation group "
                                 "did not batch into one run")
        for r in res:
            name = r.spec.name
            same_point(f"fabric chain {name} devices=2 vs card",
                       r, chain_runs["card"][name])
            same_point(f"fabric chain {name} devices=2 vs CPU",
                       r, chain_runs["cpu"][name])
        check_launches("fabric chain", counts["chain_recirc_dev2"], calls,
                       CHAIN_KERNELS)
        offered = sum(r.telemetry.wire_pkts for r in res)
        rows["chain_recirc_dev2"] = dict(
            wall_s=wall, offered_pkts_per_s=offered / wall,
            one_device_wall_s=chain_runs["walls"][1])
        print(f"fabric chain recirc group {[m.name for m in members]} "
              f"devices=2 on {card}: wall {wall:.3f} s "
              f"({offered / wall:.1f} offered pkt/s; phase 5's one-device "
              f"run {chain_runs['walls'][1]:.3f} s), launches "
              f"{ {k: v for k, v in counts['chain_recirc_dev2'].items() if v} }"
              " ; identical to phase 5's card and CPU runs")
    finally:
        D.force_host_devices(saved)
    rows["card"] = card
    return counts, rows


# --------------------------------------------------------------------------
# the streaming driver at the streaming bench's full geometry
# --------------------------------------------------------------------------

def same_stream(label: str, a, b) -> None:
    for what in ("counters", "telemetry", "nf_counters", "peak_occupancy",
                 "latency", "occ_segments", "steps", "segments"):
        same(f"{label} {what}", getattr(a, what), getattr(b, what))


def stream_setup():
    """The stream's ParkConfig, chain, source and ``run_stream`` keywords at
    ``STREAM``'s geometry."""
    from repro_torch.core.park import ParkConfig
    from repro_torch.nf.chain import Chain
    from repro_torch.nf.nat import Nat
    from repro_torch.traffic.stream import DiurnalLoad, SyntheticSource

    g = STREAM
    cfg = ParkConfig(capacity=g["capacity"], max_exp=2, pmax=g["pmax"],
                     recirculation=True, recirc_frac=0.25)
    source = SyntheticSource(steps=g["steps"], chunk=g["chunk"],
                             pmax=g["pmax"], seed=0, flows=g["flows"],
                             load=DiurnalLoad(period=g["load_period"]))
    kw = dict(window=g["window"], reservoir=g["reservoir"], backend="auto")
    return cfg, Chain((Nat(),)), source, kw


def stream_traced() -> list:
    """The first steps of one stream segment, to be traced."""

    from repro_torch.switchsim.stream import run_stream

    cfg, chain, source, kw = stream_setup()
    head = dataclasses.replace(source, steps=PROFILE_STEPS)
    return [("stream segment", lambda d: run_stream(
        cfg, chain, head, segment_len=PROFILE_STEPS, device=d, **kw),
        PROFILE_STEPS + STREAM["window"] + 1)]


def stream_phase(dev):
    """The stream phase.  Returns the launch counts of the full card run."""

    from repro_torch.core.packet import FIELDS
    from repro_torch.core.park import ParkConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.nf.nat import Nat
    from repro_torch.switchsim.engine import goodput_gain_from_telemetry
    from repro_torch.switchsim.stream import replay_oracle, run_stream

    g = STREAM
    cfg, chain, source, kw = stream_setup()

    def prefix(steps, src=source):
        return dataclasses.replace(src, steps=steps)

    print(f"stream: {g['steps']} steps x chunk {g['chunk']} "
          f"({g['steps'] * g['chunk']} packets), pmax {g['pmax']}, "
          f"{g['flows']}-flow pool, diurnal period {g['load_period']}; "
          f"capacity {g['capacity']}, max_exp 2, recirculation (352 B rows, "
          f"lane 0.25), NAT at capacity {Nat().capacity}, window "
          f"{g['window']}, segment {g['segment_len']}, reservoir "
          f"{g['reservoir']}")
    # 1. the segment replay on the card: the stream equals the engine
    t0 = time.perf_counter()
    rep = replay_oracle(cfg, chain, source, window=g["window"],
                        segment_len=g["segment_len"], segments=4,
                        backend="auto", device=dev)
    print(f"stream replay_oracle on the card: {rep['segments']} segments, "
          f"{rep['steps']} steps, {rep['packets']} packets: streamed = "
          f"materialized exactly ({time.perf_counter() - t0:.1f} s)")
    # 2. the first two 32-step segments, card against CPU
    short = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        short[str(d)] = run_stream(cfg, chain, prefix(64), segment_len=32,
                                   device=d, **kw)
        print(f"stream 2 x 32 steps on {d}: {time.perf_counter() - t0:.3f} s")
    same_stream("stream 2 x 32", short[str(dev)], short["cpu"])
    # 3. constant memory and the whole run, counting the launches
    seg_bytes = sum(
        g["segment_len"] * g["chunk"]
        * (g["pmax"] if n == "payload" else 1 if n in ("alive", "pp_valid")
           else 4) for n in FIELDS)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    run_stream(cfg, chain, prefix(2 * g["segment_len"]),
               segment_len=g["segment_len"], device=dev, **kw)
    sync(dev)
    peak2 = torch.cuda.max_memory_allocated(dev) - base
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    with path_calls() as calls:
        t0 = time.perf_counter()
        res = run_stream(cfg, chain, source, segment_len=g["segment_len"],
                         device=dev, **kw)
        sync(dev)
        wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    if peak - peak2 > seg_bytes:
        raise AssertionError(f"stream: peak device memory grew {peak - peak2}"
                             f" B from 2 segments to {res.segments}, more "
                             f"than one segment's trace ({seg_bytes} B)")
    gain = goodput_gain_from_telemetry(res.telemetry)["goodput_gain"]
    lat = res.latency
    if not gain > 0 or not all(k in lat for k in ("p50_us", "p99_us",
                                                   "p999_us")):
        raise AssertionError(f"stream: gain {gain}, latency {lat}")
    check_launches("stream", counts, calls, DATAPLANE_KERNELS)
    print(f"stream {res.steps} steps on the card: {wall:.3f} s, "
          f"{res.steps / wall:.1f} steps/s, {res.telemetry.wire_pkts / wall:.1f}"
          f" offered pkt/s ({res.telemetry.wire_pkts} offered); goodput_gain "
          f"{gain:.6f}; latency p50 {lat['p50_us']} us, p99 {lat['p99_us']} "
          f"us, p999 {lat['p999_us']} us ({lat['samples']} samples); peak "
          f"occupancy {res.peak_occupancy}; peak device memory {peak} B "
          f"({peak2} B over 2 segments, one segment's trace {seg_bytes} B); "
          f"counters {res.counters}, nf {res.nf_counters}; launches {counts} "
          f"for {calls}")
    # two more streams of 128 steps in segments of 48 (a ragged last one),
    # card against CPU: 352-byte rows with the lane, window 2, and
    # 160-byte rows without it, window 1
    cfg160 = ParkConfig(capacity=g["capacity"], max_exp=2, pmax=g["pmax"])
    for label, c, window in (("352 B rows, lane", cfg, g["window"]),
                             ("160 B rows", cfg160, 1)):
        second = {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            second[str(d)] = run_stream(c, chain, prefix(128), window=window,
                                        segment_len=48,
                                        reservoir=g["reservoir"],
                                        backend="auto", device=d)
            print(f"stream 128 steps, {label}, window {window}, segments of "
                  f"48 on {d}: {time.perf_counter() - t0:.3f} s")
        same_stream(f"stream {label}", second[str(dev)], second["cpu"])
    print("stream: card runs identical to the CPU runs (counters, telemetry, "
          "nf_counters, peak occupancy, latency, occupancy segments)")
    return counts


# --------------------------------------------------------------------------
# the adversarial family with its degradation gates
# --------------------------------------------------------------------------

def adversarial_phase(dev):
    """The adversarial phase.  Returns the launch counts of the card run."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.scenarios import (compile_key, degradation_block,
                                       family, prepare, run_matrix,
                                       verify_oracle)

    specs = family("adversarial")
    groups: dict = {}
    for s in specs:
        p = prepare(s)
        groups.setdefault(compile_key(s, p.chain, p.steps), []).append(s)
    groups = list(groups.values())
    print(f"adversarial: {len(specs)} points in {len(groups)} groups "
          f"{[[x.name for x in m] for m in groups]}")

    def run_groups(d):
        out, walls = {}, []
        for members in groups:
            sync(d)
            t0 = time.perf_counter()
            res = run_matrix(members, device=d)
            sync(d)
            walls.append(time.perf_counter() - t0)
            if [r.group_size for r in res] != [len(members)] * len(members):
                raise AssertionError(f"adversarial: {[m.name for m in members]}"
                                     " did not batch into one run_pipes call")
            out.update((r.spec.name, r) for r in res)
        return out, walls

    sync(dev)
    reset_launch_counts()
    with path_calls() as calls:
        gpu, gpu_walls = run_groups(dev)
    counts = launch_counts()
    with recording_nat_depths() as depths:
        cpu, cpu_walls = run_groups("cpu")
    print(depth_line("adversarial, every group", depths))
    for name in gpu:
        same_point(f"adversarial {name}", gpu[name], cpu[name])
    block = degradation_block([gpu[s.name] for s in specs])
    same("adversarial degradation block", block,
         degradation_block([cpu[s.name] for s in specs]))
    # the host loop, pipe by pipe on the card, against each card point
    t0 = time.perf_counter()
    for s in specs:
        verify_oracle(gpu[s.name], device=dev)
    oracle_s = time.perf_counter() - t0
    failed = sorted((name, g["metric"]) for name, sc in
                    block["scenarios"].items() for g in sc["gates"]
                    if not g["ok"])
    for name, sc in block["scenarios"].items():
        print(f"adversarial {name}: {sc['metrics']}, gates "
              + ", ".join(f"{g['metric']} {g['op']} {g['bound']}: "
                          f"{'ok' if g['ok'] else 'FAILS'}"
                          for g in sc["gates"]))
    # the failover_drain recovery gate compares the victim pipe's
    # occupancy after the fault with one sample before it; at this
    # geometry the reference itself fails it on 4 of seeds 0-5 (ROADMAP
    # C0f), and on the reference's own full-geometry traffic the port gives
    # the reference's value (tests/test_torch_adversarial.py), so it is
    # reported here and every other gate must hold
    if [f for f in failed if f not in KNOWN_FRAGILE_GATES]:
        raise AssertionError(f"adversarial: degradation gates fail: {failed}")
    print(f"adversarial: every point identical card vs CPU, degradation "
          f"blocks identical; the host-loop oracle holding on every card "
          f"point ({oracle_s:.1f} s); block ok {block['ok']}, failing gates "
          f"{failed or 'none'}")
    for members, gw, cw in zip(groups, gpu_walls, cpu_walls):
        offered = sum(gpu[m.name].telemetry.wire_pkts for m in members)
        print(f"adversarial group {[m.name for m in members]}: card "
              f"{gw:.3f} s ({offered / gw:.1f} offered pkt/s), CPU {cw:.3f} s")
    print(f"adversarial launches on the card: {counts} for {calls}")
    check_launches("adversarial", counts, calls, DATAPLANE_KERNELS)
    return counts


# --------------------------------------------------------------------------
# phase 2, serving side: paged attention against its plain version
# --------------------------------------------------------------------------

def paged_inputs(gen, b, kh, g, e, page, mp, dev, npages=None,
                 lengths=None, tables=None, dtype=torch.bfloat16):
    """q (B, K, G, E), pools (P, page, K, E), page table (B, MP) and
    lengths.  Without ``tables`` (and ``lengths``) each request gets a
    random number of distinct live pages and a random length within them,
    as the reference's sweep test draws them."""
    npages = npages or mp * b + 2
    q = torch.randn((b, kh, g, e), generator=gen).to(dtype)
    kp = torch.randn((npages, page, kh, e), generator=gen).to(dtype)
    vp = torch.randn((npages, page, kh, e), generator=gen).to(dtype)
    if tables is None:
        pt = torch.full((b, mp), -1, dtype=torch.int32)
        ln = torch.zeros((b,), dtype=torch.int32)
        for i in range(b):
            n = int(torch.randint(1, mp + 1, (1,), generator=gen))
            pt[i, :n] = torch.randperm(npages, generator=gen)[:n]
            ln[i] = int(torch.randint(1, n * page + 1, (1,), generator=gen))
    else:
        pt = torch.tensor(tables, dtype=torch.int32)
        ln = torch.tensor(lengths, dtype=torch.int32)
    return [x.to(dev) for x in (q, kp, vp, pt, ln)]


def paged_cases(gen, dev) -> dict:
    """Label -> inputs of every paged-attention case of phase 2."""
    cases = {}
    for shape in ((4, 2, 4, 64, 16, 6), (2, 1, 8, 128, 128, 4),
                  (8, 4, 1, 32, 8, 3)):
        cases[f"sweep {shape}"] = paged_inputs(gen, *shape, dev)
    cases["engine (1, 2, 8, 128) page 16 MP 12"] = paged_inputs(
        gen, 1, 2, 8, 128, 16, 12, dev, npages=256,
        tables=[list(range(3, 13)) + [-1, -1]], lengths=[150])
    cases["batched (8, 2, 8, 128) page 16 MP 128"] = batched_paged(gen, dev)
    cases["gemma (2, 16, 1, 256) page 16 MP 8"] = paged_inputs(
        gen, 2, 16, 1, 256, 16, 8, dev)
    cases["f32 (4, 2, 4, 64) page 16 MP 6"] = paged_inputs(
        gen, 4, 2, 4, 64, 16, 6, dev, dtype=torch.float32)
    cases["reduced head_dim 16 (3, 1, 4, 16) page 4 MP 8"] = paged_inputs(
        gen, 3, 1, 4, 16, 4, 8, dev)
    # edge cases, page 16, MP 6: a -1 page inside the length (also as the
    # first page), -1 pages after it, a length on a page boundary, lengths
    # 1 and 0, and a request with no live page at all
    cases["edges (7, 2, 4, 64) page 16 MP 6"] = paged_inputs(
        gen, 7, 2, 4, 64, 16, 6, dev, npages=40,
        tables=[[1, -1, 2, 3, -1, -1], [-1, 4, 5, -1, -1, -1],
                [6, 7, 8, -1, -1, -1], [9, 10, -1, -1, 11, 12],
                [13, -1, -1, -1, -1, -1], [14, 15, -1, -1, -1, -1],
                [-1, -1, -1, -1, -1, -1]],
        lengths=[60, 40, 20, 32, 1, 0, 30])
    # across the split-K boundaries (8 splits of 64 tokens): a split of -1
    # pages only inside the length, a length ending mid-split, splits wholly
    # past the length, lengths 1 and 0
    none = [-1] * 32
    cases["splits (5, 2, 8, 128) page 16 MP 32"] = paged_inputs(
        gen, 5, 2, 8, 128, 16, 32, dev, npages=70,
        tables=[list(range(0, 4)) + [-1] * 4 + list(range(4, 28)),
                list(range(28, 34)) + none[6:], list(range(34, 66)),
                [66] + none[1:], [67, 68] + none[2:]],
        lengths=[250, 90, 40, 1, 0])
    cases["long (1, 2, 8, 128) page 16 MP 128 length 17"] = paged_inputs(
        gen, 1, 2, 8, 128, 16, 128, dev, npages=160,
        tables=[list(range(20, 148))], lengths=[17])
    cases["G=1 E=256 (1, 4, 1, 256) page 16 MP 24"] = paged_inputs(
        gen, 1, 4, 1, 256, 16, 24, dev, npages=30,
        tables=[list(range(2, 26))], lengths=[300])
    cases["G=20 (2, 2, 20, 64) page 8 MP 40"] = paged_inputs(
        gen, 2, 2, 20, 64, 8, 40, dev)
    pt4 = torch.randperm(200, generator=gen)[:192].reshape(2, 96)
    pt4[0, [5, 17, 18, 40]] = -1
    pt4[1, 60:] = -1
    cases["page 4 (2, 2, 8, 64) page 4 MP 96"] = paged_inputs(
        gen, 2, 2, 8, 64, 4, 96, dev, npages=200, tables=pt4.tolist(),
        lengths=[350, 201])
    return cases


def engine_paged(gen, dev):
    """The serving engine's shape: one request, 2 KV heads x 8 query heads,
    E = 128, 16-token pages, MP = 12, 160 tokens over 10 pages."""
    return paged_inputs(gen, 1, 2, 8, 128, 16, 12, dev, npages=256,
                        tables=[list(range(3, 13)) + [-1, -1]],
                        lengths=[160])


def batched_paged(gen, dev):
    """8 requests x 2 KV heads x 8 query heads per KV head, E = 128,
    16-token pages, up to 128 pages (2048 tokens) each, distinct pages."""
    b, mp, page = 8, 128, 16
    lengths = torch.randint(1, mp * page + 1, (b,), generator=gen)
    lengths[0] = mp * page
    perm = torch.randperm(b * mp + 16, generator=gen)[:b * mp]
    pt = perm.reshape(b, mp).to(torch.int32)
    live = (torch.arange(mp)[None, :] * page) < lengths[:, None]
    pt = torch.where(live, pt, -1)
    return paged_inputs(gen, b, 2, 8, 128, page, mp, dev,
                        npages=b * mp + 16, tables=pt.tolist(),
                        lengths=lengths.tolist())


def paged_close(label: str, got, want) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = float((err - PAGED_RTOL * want.abs()).max())
    if not torch.isfinite(got).all() or worst > PAGED_ATOL:
        raise AssertionError(f"paged_attention {label}: kernel differs from "
                             f"plain version beyond atol {PAGED_ATOL} + rtol "
                             f"{PAGED_RTOL}: max abs err {float(err.max())}")
    return float(err.max())


def check_paged(dev) -> float:
    from repro_torch.backend import ref as R
    from repro_torch.kernels import paged_attention

    gen = torch.Generator().manual_seed(SEED + 3)
    err = 0.0
    for label, args in paged_cases(gen, dev).items():
        got = once("paged_attention",
                   paged_attention.paged_decode_attention_cuda, *args)
        want = R.paged_decode_attention(*args)
        e = paged_close(label, got, want)
        _, kp, _, pt, ln = args
        page, mp = kp.shape[1], pt.shape[1]
        pos = torch.arange(mp * page, device=dev)[None, :]
        live = ((pos < ln[:, None].long())
                & (pt >= 0).repeat_interleave(page, 1)).any(1)
        if bool((got[~live] != 0).any()):
            raise AssertionError(f"paged_attention {label}: a request with "
                                 "no live token did not give zeros")
        err = max(err, e)
        print(f"paged_attention {label}: max abs err {e:.6f}")
    torch.cuda.synchronize()
    return err


def paged_bound(q, kp, pt, ln) -> dict:
    b, kh, g, e = q.shape
    live = int(ln.clamp(min=0).sum())
    item = kp.element_size()
    nbytes = (2 * live * kh * e * item + 2 * q.numel() * item
              + pt.numel() * 4 + ln.numel() * 4)
    return dict(bound_bytes=nbytes, bound_ops=4 * live * kh * g * e)


def time_paged(dev) -> dict:
    """Kernel, plain version, SDPA on gathered K/V and bound at the
    engine's shape (the row of the kernels line) and the batched shape."""
    import torch.nn.functional as F
    from repro_torch.backend import ref as R
    from repro_torch.kernels import paged_attention

    gen = torch.Generator().manual_seed(SEED + 4)
    shapes = {"engine": engine_paged(gen, dev),
              "batched": batched_paged(gen, dev)}
    rows = {}
    for name, (q, kp, vp, pt, ln) in shapes.items():
        b, kh, g, e = q.shape
        page, mp = kp.shape[1], pt.shape[1]

        def gather():
            idx = pt.clamp(min=0).long()
            k = kp[idx].reshape(b, mp * page, kh, e).transpose(1, 2)
            v = vp[idx].reshape(b, mp * page, kh, e).transpose(1, 2)
            return k, v

        k, v = gather()
        pos = torch.arange(mp * page, device=dev)[None, :]
        mask = (pos < ln[:, None]) & (pt >= 0).repeat_interleave(page, 1)
        mask = mask[:, None, None, :]
        qs = q.reshape(b, kh * g, 1, e)
        r = dict(
            ms=device_ms(lambda: paged_attention.paged_decode_attention_cuda(
                q, kp, vp, pt, ln)),
            plain_ms=device_ms(lambda: R.paged_decode_attention(
                q, kp, vp, pt, ln)),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=mask, enable_gqa=True)),
            gather_ms=device_ms(gather),
            **paged_bound(q, kp, pt, ln))
        bound(r, BF16_FLOP_PER_S)
        rows[name] = r
        print(f"time paged_attention {name} (B, K, G, E) = {tuple(q.shape)}, "
              f"page {page}, MP {mp}, {int(ln.sum())} live tokens: kernel "
              f"{r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, library "
              f"(SDPA on gathered K/V) {r['library_ms']:.6f} ms, gather "
              f"{r['gather_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms by "
              f"{r['bound_by']} ({r['bound_bytes']} bytes, "
              f"{r['bound_ops']} operations)")
    return rows


# --------------------------------------------------------------------------
# phase 6: parked-KV serving
# --------------------------------------------------------------------------

class Recorder:
    """Wraps an engine's ``_forward_token`` to keep, per token step, the
    request, position, input token and logits (on the engine's device), and
    its MoE routing (``routing``).  With ``pin`` (another run's recorder of
    the same steps), each step takes that run's experts."""

    def __init__(self, eng, pin=None):
        self.steps = []
        self.routes = []
        inner = eng._forward_token

        def forward(slot, token):
            given = None if pin is None else pin.routes[len(self.steps)].calls
            with routing(given) as rec:
                logits, k, v = inner(slot, token)
            self.steps.append((int(eng.rid[slot]), int(eng.pos[slot]),
                               int(token), logits))
            self.routes.append(rec)
            return logits, k, v
        eng._forward_token = forward

    def apart(self) -> tuple[int, float]:
        """Pinned steps whose own router chose other experts somewhere, and
        the least top-k margin there."""
        counts = [r.apart() for r in self.routes]
        hit = [m for n, m in counts if n]
        return len(hit), min(hit, default=math.inf)

    def forcing(self):
        """A ``before_step`` hook that feeds a replay the recorded input
        tokens (teacher forcing)."""
        tokens = {(r, p): t for r, p, t, _ in self.steps}

        def force(eng):
            for slot in np.where(eng.active)[0]:
                eng.last_tok[slot] = tokens[(int(eng.rid[slot]),
                                             int(eng.pos[slot]))]
        return force


def same_engines(label, a, b) -> None:
    same(f"{label} stats", a.stats(), b.stats())
    same(f"{label} pages", a.pages, b.pages)
    same(f"{label} gens", a.gens, b.gens)
    same(f"{label} dropped", a.dropped, b.dropped)
    same(f"{label} header_bytes", a.header_bytes_total, b.header_bytes_total)
    same(f"{label} payload_bytes_avoided", a.payload_bytes_avoided,
         b.payload_bytes_avoided)
    d = a.stats()
    total = (d["merges"] + d["explicit_drops"] + d["evictions"]
             + d["occupancy"])
    if d["splits"] != total or d["occupancy"] != 0:
        raise AssertionError(f"{label}: splits {d['splits']} != merges + "
                             f"explicit drops + evictions + occupancy "
                             f"({total}), or pages left parked: {d}")


def logit_errors(label, run, replay, bound) -> tuple[float, int]:
    """Max |logit difference| over the steps, and the number of steps whose
    replay top-2 margin is too small to decide the token.  Raises if the
    error exceeds ``bound`` or a decided token differs."""
    if [s[:3] for s in run.steps] != [s[:3] for s in replay.steps]:
        raise AssertionError(f"{label}: the replay took other steps")
    a = torch.stack([s[3] for s in run.steps]).float().cpu()
    b = torch.stack([s[3] for s in replay.steps]).float().cpu()
    err = float((a - b).abs().max())
    top = torch.topk(b, 2, dim=-1).values
    decided = (top[:, 0] - top[:, 1]) > 2 * err
    differ = decided & (a.argmax(-1) != b.argmax(-1))
    if not err <= bound or bool(differ.any()):
        raise AssertionError(f"{label}: max |dlogit| {err} (bound {bound}), "
                             f"{int(differ.sum())} decided tokens differ")
    return err, int((~decided).sum())


def to_device(tree: dict, dev) -> dict:
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def lifecycle(eng, before_step=None) -> None:
    """The reference engine test's lifecycle (tests/test_serving.py): admit
    two requests, three decode steps, finish one, cancel the other."""
    if not (eng.admit(1, [1, 2, 3, 4, 5]) and eng.admit(2, [9, 8])):
        raise AssertionError("lifecycle: admission failed")
    for _ in range(3):
        if before_step is not None:
            before_step(eng)
        eng.step()
    out = eng.finish(1)
    if len(out) != 5 + 1 + 3:
        raise AssertionError(f"lifecycle: request 1 gave {out}")
    eng.finish(2, cancel=True)
    d = eng.stats()
    if not (d["explicit_drops"] > 0 and d["occupancy"] == 0
            and d["goodput_gain"] > 10):
        raise AssertionError(f"lifecycle: stats {d}")


def shadowed(plain, pa_module, shadow: list):
    """The engine's plain ``paged_attention`` with the kernel run beside it
    on the same inputs: per call, the largest |kernel - plain| and the
    largest excess over atol + rtol |plain| (kept on the card until read).
    The comparison's launches are taken back off the kernel's count."""
    from repro_torch import trace

    def attend(q, k_pages, v_pages, pt, lengths):
        out = plain(q, k_pages, v_pages, pt, lengths)
        before = trace.COUNTERS[pa_module.COUNT]
        got = pa_module.paged_decode_attention_cuda(q, k_pages, v_pages, pt,
                                                    lengths)
        trace.COUNTERS[pa_module.COUNT] = before
        d = (got.float() - out.float()).abs()
        shadow.append((d.max(), (d - PAGED_ATOL
                                 - PAGED_RTOL * out.float().abs()).max()))
        return out
    return attend


def shadow_error(shadow: list) -> tuple[float, int]:
    """The largest |kernel - plain| over the shadowed calls; raises where a
    call breaks the paged-attention tolerance."""
    err = float(torch.stack([d for d, _ in shadow]).max())
    excess = float(torch.stack([x for _, x in shadow]).max())
    if excess > 0:
        raise AssertionError(f"paged_attention on the serving inputs: "
                             f"max |d| {err} past atol {PAGED_ATOL} + rtol "
                             f"{PAGED_RTOL}")
    return err, len(shadow)


def serve_pair(label, cfg, params, ecfg, prompts, gen_len, cancel, dev):
    """``launch.serve`` with the ``paged_attention`` kernel (backend
    ``auto``), then replayed teacher-forced with the plain version on the
    card, the kernel shadowing every plain call on the same inputs
    (``shadowed``); an MoE replay also takes the kernel run's experts (a
    near tie that the two runs round apart would otherwise change the
    request's history from there on).  The two runs must keep identical
    pool and header accounting, logits within ``SERVE_LOGIT_ERR``, and the
    kernel launched layers x token steps times.  Returns the kernel run's
    launch counts and its report."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import ServeEngine

    from repro_torch.kernels import paged_attention as PA

    lm = LM(cfg)
    runs = {}
    shadow = []
    for backend in ("auto", "ref"):
        eng = ServeEngine(lm, params, ecfg, backend=backend)
        if backend == "ref":
            eng.attend = shadowed(eng.attend, PA, shadow)
        rec = Recorder(eng, pin=runs["auto"][1] if runs else None)
        hook = None if backend == "auto" else runs["auto"][1].forcing()
        sync(dev)
        reset_launch_counts()
        rep = serve(eng, prompts, gen_len, cancel=cancel, before_step=hook)
        counts = launch_counts()
        runs[backend] = (eng, rec, rep, counts)
        steps = len(rec.steps)
        what = ("kernel" if backend == "auto"
                else "plain version, teacher-forced")
        print(f"{label} {backend} ({what}): "
              f"{rep.done} done, {rep.cancelled} cancelled, {steps} token "
              f"steps and {rep.tokens} decode tokens in {rep.seconds:.3f} s "
              f"({steps / rep.seconds:.1f} token steps/s, "
              f"{rep.tokens / rep.seconds:.1f} decode tok/s); "
              f"paged_attention launches {counts['paged_attention']}")
    (eng_k, rec_k, rep_k, counts_k), (eng_p, rec_p, rep_p, counts_p) = \
        runs["auto"], runs["ref"]
    same_engines(label, eng_k, eng_p)
    same(f"{label} report", (rep_k.done, rep_k.cancelled, rep_k.tokens),
         (rep_p.done, rep_p.cancelled, rep_p.tokens))
    want = cfg.num_layers * len(rec_k.steps)
    if counts_k["paged_attention"] != want or counts_p["paged_attention"]:
        raise AssertionError(f"{label}: paged_attention launched "
                             f"{counts_k['paged_attention']} times, want "
                             f"layers x token steps = {want} (plain replay "
                             f"{counts_p['paged_attention']}, want 0)")
    serr, calls = shadow_error(shadow)
    print(f"{label}: the kernel on every one of the replay's {calls} "
          f"attention inputs: max |d| {serr:.6f} from the plain version "
          f"(atol {PAGED_ATOL}, rtol {PAGED_RTOL}); these launches are not "
          "counted")
    apart, least = rec_p.apart()
    if apart:
        print(f"{label}: the replay takes the kernel run's experts at every "
              f"MoE layer; at {apart} of {len(rec_p.steps)} token steps its "
              f"own router would have chosen others somewhere (near ties, "
              f"least top-k margin {least:.3g})")
    err, undecided = logit_errors(label, rec_k, rec_p, SERVE_LOGIT_ERR)
    print(f"{label}: kernel run vs plain replay: stats, pages, gens, drops "
          f"and header bytes identical ({eng_k.stats()}); max |dlogit| "
          f"{err:.6f} over {len(rec_k.steps)} steps; tokens identical where "
          f"the top-2 margin > 2 x that, {undecided} steps too close to "
          f"call; launches = {cfg.num_layers} x {len(rec_k.steps)}")
    return counts_k, rep_k


def serve_phase(dev):
    """Phase 6.  Returns the launch counts of the kernel run and the run to
    trace once every timed run is over."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch.serve import (engine_config, init_params,
                                          make_prompts)
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from repro_torch.serving.pool import PoolConfig

    cfg = configs.get("qwen2.5-3b")
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, dev)
    sync(dev)
    print(f"serve: {cfg.name} full config ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_padded()}), "
          f"~{cfg.param_count() / 1e9:.2f} B parameters drawn "
          f"on {dev} in {time.perf_counter() - t0:.1f} s")
    ecfg = engine_config(128, 32, max_batch=4, pages=256, page_tokens=16)
    prompts = make_prompts(4, 128, cfg.vocab_size)
    counts_k, _ = serve_pair("serve", cfg, params, ecfg, prompts, 32,
                             {2: 16}, dev)

    # reduced Gemma-7B, the reference test's lifecycle, card against CPU
    rcfg = reduced(configs.get("gemma-7b"))
    cpu_params = init_params(rcfg, "cpu")
    recs = {}
    for d, prm in (("cpu", cpu_params), ("card", to_device(cpu_params, dev))):
        eng = ServeEngine(LM(rcfg), prm, EngineConfig(
            max_batch=4, max_pages_per_req=8,
            pool=PoolConfig(num_pages=64, page_tokens=4)))
        rec = Recorder(eng)
        lifecycle(eng, None if d == "cpu" else recs["cpu"][1].forcing())
        recs[d] = (eng, rec)
    same_engines("reduced gemma", recs["card"][0], recs["cpu"][0])
    rerr, rund = logit_errors("reduced gemma", recs["cpu"][1],
                              recs["card"][1], REDUCED_LOGIT_ERR)
    print(f"serve reduced {rcfg.name}: card (kernel) vs CPU (plain): stats "
          f"identical ({recs['card'][0].stats()}), max |dlogit| {rerr:.6f} "
          f"over {len(recs['card'][1].steps)} steps, {rund} too close to "
          "call")

    def traced_run(d):
        e = ServeEngine(lm, params, ecfg)
        e.admit(0, prompts[0][:PROFILE_TOKENS])
    return counts_k, [("serve qwen2.5-3b prefill", traced_run,
                       PROFILE_TOKENS)]



# --------------------------------------------------------------------------
# LM phase: Mixtral served through paged_attention, the model stack
# --------------------------------------------------------------------------

def held(label, got, want, want32, bound) -> str:
    """bf16 ``got`` against ``want`` within ``bound``; past it, against the
    f32 run ``want32`` within twice ``want``'s own error there (the bf16
    rounding of the run it is held to).  Raises otherwise."""
    err = float((got.float() - want.float()).abs().max())
    if err <= bound:
        return f"{err:.6f} <= {bound}"
    own = float((want.float() - want32.float()).abs().max())
    err32 = float((got.float() - want32.float()).abs().max())
    if err32 > 2 * own:
        raise AssertionError(f"{label}: max |d| {err} > {bound}, and "
                             f"{err32} from the f32 run > twice the "
                             f"reference run's own {own}")
    return (f"{err:.6f} > {bound}, but {err32:.6f} from the f32 run, "
            f"within twice the reference run's own {own:.6f}")


def nodrop(cfg):
    """MoE capacity raised to 8.0 so that no token is dropped, as in
    tests/test_decode_consistency.py."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def lm_batch(cfg, b, s, dev, gen, nv=LM_VISION_TOKENS, frames=LM_ENC_FRAMES):
    """Tokens, and the stubs' inputs: ``nv`` vision embeddings on M-RoPE
    grid positions for a VLM, ``frames`` speech frames for an encoder."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=dev, dtype=torch.int32)}
    if cfg.family == "vlm":
        pos = torch.arange(s, device=dev)[None, None].repeat(3, b, 1)
        side = int(nv ** 0.5)
        pos[0, :, :nv] = 0
        pos[1, :, :nv] = torch.arange(nv, device=dev) // side
        pos[2, :, :nv] = torch.arange(nv, device=dev) % side
        batch["positions"] = pos.to(torch.int32)
        batch["vision_embeds"] = 0.02 * torch.randn(
            (b, nv, cfg.d_model), generator=gen, device=dev,
            dtype=torch.float32).to(torch.bfloat16)
    if cfg.enc_layers:
        batch["enc_frames"] = 0.1 * torch.randn(
            (b, frames, cfg.d_model), generator=gen, device=dev,
            dtype=torch.float32).to(torch.bfloat16)
    return batch


class Routing:
    """One run's MoE routing, a call per MoE layer in order: each token's
    experts (the router's top-k order) and top-k margin (the k-th router
    probability less the (k+1)-th: a small margin is a near tie that
    rounding can flip); in a pinned run, also which tokens' own router
    chose other experts than the ones given."""

    def __init__(self):
        self.calls, self.flips = [], []

    def at(self, pos) -> list:
        """The experts at sequence positions ``pos`` of every call."""
        return [idx[:, pos] for idx, _ in self.calls]

    def apart(self) -> tuple[int, float]:
        """Tokens whose own router chose otherwise in some layer, and the
        least top-k margin among those choices."""
        hit, least = None, math.inf
        for flip, margin in self.flips:
            flip, margin = flip.cpu(), margin.cpu()
            hit = flip if hit is None else hit | flip
            if bool(flip.any()):
                least = min(least, float(margin[flip].min()))
        return (0 if hit is None else int(hit.sum())), least


@contextlib.contextmanager
def routing(pin=None):
    """Record the routing of every ``moe_apply`` call (``Routing``).  With
    ``pin`` (experts per call, in order, as ``Routing.calls`` or
    ``Routing.at`` give them), each call takes the experts given in place
    of its router's top-k (``moe_apply(top_i=...)``)."""
    from repro_torch.models import moe
    inner = moe.moe_apply
    rec = Routing()

    def call(p, x, cfg, act):
        with torch.no_grad():  # a record, not part of any loss
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1)
            own = top.indices[..., :-1]
            margin = top.values[..., -2] - top.values[..., -1]
        if pin is None:
            rec.calls.append((own, margin))
            return inner(p, x, cfg, act)
        given = pin[len(rec.calls)]
        given = (given[0] if isinstance(given, tuple) else given).to(x.device)
        rec.calls.append((given, margin))
        rec.flips.append(((own.sort(dim=-1).values
                           != given.sort(dim=-1).values).any(dim=-1),
                          margin))
        return inner(p, x, cfg, act, top_i=given)
    moe.moe_apply = call
    try:
        yield rec
    finally:
        moe.moe_apply = inner


def prefix(batch, n):
    return {k: (v[..., :n] if k in ("tokens", "positions") else v)
            for k, v in batch.items()}


def stack_run(cfg, params, batch, dev, cache_len, keep_logits=False,
              pin=None, carry=False):
    """``forward_train`` on the whole batch, then ``prefill`` on all but
    the last token and one ``decode_step``; each timed (host clock ending
    in a synchronize).  Prefill and decode take the forward's MoE routing
    (``routing``), so that a near tie rounded apart cannot break the
    invariant; with ``pin`` (another run's forward routing) the forward
    takes that too.  With ``carry`` (on the card), a second decode from
    the same cache carries it in place at the uniform position
    (``carried_decode``), and each decode's peak device memory is taken.
    Returns the logits (all of the forward's with ``keep_logits``), the
    relative error of the decoded logits against the forward's last, the
    routings and the walls."""
    from repro_torch.models.lm import LM
    lm = LM(cfg)
    b, s = batch["tokens"].shape
    out = {}
    with torch.no_grad():
        sync(dev)
        t0 = time.perf_counter()
        with routing(pin) as out["fwd"]:
            logits, _ = lm.forward_train(params, batch)
        sync(dev)
        out["forward_s"] = time.perf_counter() - t0
        out["logits"] = logits.float().cpu() if keep_logits else None
        out["want"] = logits[:, -1].float()
        del logits
        t0 = time.perf_counter()
        with routing(out["fwd"].at(slice(0, s - 1))) as out["pre"]:
            out["last"], cache = lm.prefill(params, prefix(batch, s - 1),
                                            cache_len=cache_len)
        sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        if carry:
            out["peak_before_decode"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with routing(out["fwd"].at(slice(s - 1, s))) as out["dec"]:
            out["got"], _ = lm.decode_step(
                params, cache, batch["tokens"][:, -1],
                torch.full((b,), s - 1, dtype=torch.int32, device=dev))
        sync(dev)
        out["decode_s"] = time.perf_counter() - t0
        if carry:
            out["decode_peak"] = torch.cuda.max_memory_allocated(dev)
            out["carry"] = carried_decode(cfg, params, cache, batch, dev,
                                          out)
    got, want = out["got"].float(), out["want"]
    out["rel"] = float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-6)
    return out


def same_bits(a, b) -> bool:
    """``a`` and ``b`` of one dtype and shape with the same bytes (NaNs
    included)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def carried_decode(cfg, params, cache, batch, dev, out) -> dict:
    """The decode of ``stack_run`` again from the same cache with
    ``decode_carry_cache`` and ``assume_uniform_decode`` (every request at
    the same position), under the same routing: its logits must be the
    functional decode's bit for bit (the same arithmetic) and the cache it
    returns the tensors passed in, written in place.  Its wall and its
    peak device memory (the statistics reset before it)."""
    from repro_torch.models.lm import LM
    from repro_torch.training.tree import leaves
    b, s = batch["tokens"].shape
    lm = LM(cfg, decode_carry_cache=True, assume_uniform_decode=True)
    before = leaves(cache)
    ptrs = [t.data_ptr() for t in before]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with routing(out["fwd"].at(slice(s - 1, s))):
        got, back = lm.decode_step(
            params, cache, batch["tokens"][:, -1],
            torch.full((b,), s - 1, dtype=torch.int32, device=dev))
    sync(dev)
    wall = time.perf_counter() - t0
    back = leaves(back)
    row = dict(decode_s=wall, peak_bytes=torch.cuda.max_memory_allocated(dev),
               bit_identical=same_bits(got, out["got"]),
               same_storage=(len(back) == len(before) and all(
                   t is u and t.data_ptr() == p
                   for t, u, p in zip(back, before, ptrs))),
               cache_bytes=sum(t.numel() * t.element_size() for t in back))
    if not (row["bit_identical"] and row["same_storage"]):
        raise AssertionError(f"lm {cfg.name}: carried decode {row}")
    return row


def apart_line(r) -> str:
    """The tokens whose own router chose other experts than the pinned
    ones, per phase."""
    parts = []
    for phase in ("fwd", "pre", "dec"):
        n, least = r[phase].apart()
        if n:
            parts.append(f"{phase} {n} (least top-k margin {least:.3g})")
    return ("; tokens whose own router chose other experts than the "
            "forward's: " + ", ".join(parts)) if parts else ""


class F32Layers:
    """A stacked (L, ...) leaf that gives layer ``li`` cast to f32 when the
    layer loop indexes it, so an f32 run holds one layer in f32 beside the
    bf16 weights (Mixtral's 16 layers are 94 GB in f32)."""

    def __init__(self, stacked):
        self.stacked = stacked

    def __getitem__(self, li):
        return self.stacked[li].float()

    def unbind(self, dim):
        """The layer loop's view of the stack: itself, each layer cast when
        it is taken."""
        assert dim == 0
        return self


def as_f32(params: dict) -> dict:
    """The same model in f32: the embeddings and norms cast, every stacked
    layer leaf cast layer by layer as it runs (``F32Layers``)."""
    def lazy(tree):
        return {k: lazy(v) if isinstance(v, dict) else F32Layers(v)
                for k, v in tree.items()}
    return {k: ({kk: vv.float() for kk, vv in v.items()} if k == "embed"
                else lazy(v) if isinstance(v, dict) else v.float())
            for k, v in params.items()}


def lm_stack(name, layers, params, dev, gen) -> dict:
    """Prefill + decode against the forward on one full-width config, with
    the reference's relative bound (MoE routing pinned to the forward's,
    ``stack_run``); past it, the same run with the weights cast to f32
    decides between a fault (f32 breaks the bound too) and bf16 rounding
    (then the bf16 logits are held to the f32 run's within
    SERVE_LOGIT_ERR, under the bf16 forward's routing)."""
    from repro_torch import configs
    from repro_torch.device import card_line
    from repro_torch.launch.serve import init_params
    full = configs.get(name)
    cfg = nodrop(full if layers is None
                 else dataclasses.replace(full, num_layers=layers))
    depth = (f"{cfg.num_layers} of {full.num_layers} layers"
             if layers is not None else f"all {cfg.num_layers} layers")
    if cfg.enc_layers:
        depth += f" + {cfg.enc_layers} encoder layers"
    torch.cuda.reset_peak_memory_stats(dev)
    if params is None:
        t0 = time.perf_counter()
        params = init_params(cfg, dev)
        sync(dev)
        print(f"lm {name}: {depth}, weights drawn in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated(dev)} B allocated")
    batch = lm_batch(cfg, LM_BATCH, LM_PREFILL + 1, dev, gen)
    r = stack_run(cfg, params, batch, dev, LM_CACHE_LEN, keep_logits=True,
                  carry=True)
    car = r["carry"]
    peak = max(r["peak_before_decode"], r["decode_peak"], car["peak_bytes"])
    b, s = LM_BATCH, LM_PREFILL
    row = dict(name=name, depth=depth, rel=r["rel"], bound=SELF_REL,
               forward_s=r["forward_s"], prefill_s=r["prefill_s"],
               decode_s=r["decode_s"],
               prefill_tok_s=b * s / r["prefill_s"],
               decode_tok_s=b / r["decode_s"], peak_bytes=peak,
               decode_peak_bytes=r["decode_peak"], carried=car,
               card=card_line(dev),
               routed_apart=[r[k].apart()[0] for k in ("pre", "dec")])
    print(f"lm {name} ({depth}, batch {b}, prefill {s} + 1 decode): "
          f"forward {r['forward_s']:.3f} s, prefill {r['prefill_s']:.3f} s "
          f"({row['prefill_tok_s']:.1f} tok/s), decode {r['decode_s']:.3f} s "
          f"({row['decode_tok_s']:.1f} tok/s), peak device memory {peak} B; "
          f"prefill + decode vs forward: relative error {r['rel']:.6f} "
          f"(bound {SELF_REL}){apart_line(r)}")
    print(f"lm {name}: decode again from the same cache with "
          f"decode_carry_cache and assume_uniform_decode, on "
          f"{row['card']}: logits bit for bit the functional decode's: "
          f"{car['bit_identical']}; the caller's {car['cache_bytes']} B of "
          f"cache written in place and returned (same tensors and "
          f"storage): {car['same_storage']}; decode wall {car['decode_s']:.4f}"
          f" s (functional {r['decode_s']:.4f} s), peak device memory "
          f"{car['peak_bytes']} B (functional {r['decode_peak']} B, "
          f"{r['decode_peak'] - car['peak_bytes']} B more)")
    finite = all(bool(torch.isfinite(v).all())
                 for v in (r["got"], r["want"], r["last"]))
    if not finite and layers is None and name in OVERFLOWS_IN_REFERENCE:
        row.update(rel=None, overflow=True)
        print(f"lm {name}: the logits of all {cfg.num_layers} layers are "
              f"not finite: the residual stream overflows, as in the "
              f"reference's own model (ROADMAP C0g); reported, not required")
        return row
    if not finite:
        raise AssertionError(f"lm {name}: non-finite logits")
    if r["rel"] >= SELF_REL:
        r32 = stack_run(cfg, as_f32(params), batch, dev, LM_CACHE_LEN,
                        keep_logits=True, pin=r["fwd"].calls)
        row["rel_f32"] = r32["rel"]
        print(f"lm {name}: past the bound in bf16; with f32 weights (cast "
              f"layer by layer as it runs, the bf16 forward's routing) the "
              f"relative error is {r32['rel']:.6f}")
        if r32["rel"] >= SELF_REL:
            raise AssertionError(f"lm {name}: prefill + decode vs forward "
                                 f"{r32['rel']} in f32 too: a fault")
        for what in ("logits", "got"):
            err = float((r[what].float().cpu()
                         - r32[what].float().cpu()).abs().max())
            row[f"{what}_vs_f32"] = err
            if not err <= SERVE_LOGIT_ERR:
                raise AssertionError(f"lm {name}: bf16 {what} {err} from "
                                     "the f32 run's")
        print(f"lm {name}: bf16 rounding over depth: the bf16 forward and "
              f"decode logits lie within {row['logits_vs_f32']:.6f} / "
              f"{row['got_vs_f32']:.6f} of the f32 run's (bound "
              f"{SERVE_LOGIT_ERR})")
    return row


def reduced_card_vs_cpu(name, dev) -> dict:
    """A reduced config's forward, prefill and decode on the card against
    the CPU from the same weights, the card taking the CPU run's MoE
    routing: logits within REDUCED_LOGIT_ERR, or past it within twice the
    CPU run's own bf16 error against its f32 run (``held``)."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch.serve import init_params
    cfg = nodrop(reduced(configs.get(name)))
    cpu = init_params(cfg, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    batch = lm_batch(cfg, 2, 33, "cpu", gen, nv=8, frames=32)
    ref = stack_run(cfg, cpu, batch, "cpu", 40, keep_logits=True)
    pin = ref["fwd"].calls
    card = stack_run(cfg, to_device(cpu, dev), to_device(batch, dev), dev, 40,
                     keep_logits=True, pin=pin)
    ref32 = stack_run(cfg, as_f32(cpu), batch, "cpu", 40, keep_logits=True,
                      pin=pin)
    notes = [f"{what} " + held(f"reduced {name} {what}", card[key].cpu(),
                               ref[key], ref32[key], REDUCED_LOGIT_ERR)
             for what, key in (("forward", "logits"), ("prefill", "last"),
                               ("decode", "got"))]
    print(f"lm reduced {cfg.name}: card vs CPU logits: {'; '.join(notes)}"
          f"{apart_line(card)}")
    return {"name": name, "checks": notes,
            "routed_apart": [card[k].apart()[0] for k in ("fwd", "pre",
                                                           "dec")]}


def lm_phase(dev):
    """The LM phase.  Mixtral-8x7B at full width (16 of 32 layers) served
    through ``launch.serve`` with the ``paged_attention`` kernel and
    replayed with the plain version, then the six full-width prefill +
    decode against forward runs (``LM_STACK``), then the ten reduced
    configs card against CPU.  Returns the serving run's launch counts and
    the rows it printed."""
    from repro_torch import configs
    from repro_torch.launch.serve import (engine_config, init_params,
                                          make_prompts)

    cfg = dataclasses.replace(configs.get("mixtral-8x7b"),
                              num_layers=LM_STACK[0][1])
    torch.cuda.init()  # the memory statistics need the runtime up
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, dev)
    sync(dev)
    draw_peak = torch.cuda.max_memory_allocated(dev)
    held_bytes = torch.cuda.memory_allocated(dev)
    print(f"lm serve: {cfg.name} at full width ({cfg.num_layers} of 32 "
          f"layers, d_model {cfg.d_model}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k} with d_ff {cfg.moe.d_ff_expert}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
          f"{cfg.head_dim}, vocab {cfg.vocab_padded()}): weights drawn in "
          f"{time.perf_counter() - t0:.1f} s, {held_bytes} B held, peak "
          f"device memory of the draw {draw_peak} B")
    ecfg = engine_config(64, 16, max_batch=4, pages=256, page_tokens=16)
    prompts = make_prompts(4, 64, cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats(dev)
    counts, rep = serve_pair("lm serve mixtral", cfg, params, ecfg, prompts,
                             16, {2: 8}, dev)
    print(f"lm serve mixtral: peak device memory of the two runs "
          f"{torch.cuda.max_memory_allocated(dev)} B")
    rows = {"serve": dict(draw_peak_bytes=draw_peak, held_bytes=held_bytes,
                          seconds=rep.seconds, tokens=rep.tokens)}

    gen = torch.Generator(device=dev).manual_seed(SEED)
    stack = []
    for name, layers in LM_STACK:
        stack.append(lm_stack(name, layers, params, dev, gen))
        params = None
        gc.collect()
        torch.cuda.empty_cache()
        if stack[-1].get("overflow"):
            stack.append(lm_stack(name, OVERFLOWS_IN_REFERENCE[name], None,
                                  dev, gen))
            gc.collect()
            torch.cuda.empty_cache()
    rows["stack"] = stack
    rows["reduced"] = [reduced_card_vs_cpu(n, dev) for n in configs.names()]
    return counts, rows

# --------------------------------------------------------------------------
# train phase: the training slice on the card
# --------------------------------------------------------------------------

def update_gap(start, want, got, dev) -> float:
    """||(got - p0) - (want - p0)|| / ||want - p0|| over every parameter,
    summed on ``dev`` leaf by leaf: the gap of two runs' updates from
    their common start p0, relative to ``want``'s."""
    from repro_torch.training.tree import items
    want, got = dict(items(want)), dict(items(got))
    gap = norm = 0.0
    for k, p0 in items(start):
        p0 = p0.to(dev).float()
        step_want = want[k].to(dev).float() - p0
        step_got = got[k].to(dev).float() - p0
        gap += float((step_got - step_want).square().sum())
        norm += float(step_want.square().sum())
    return math.sqrt(gap / norm)


def train_gaps(name, want, got) -> tuple[float, float, float]:
    """Two ``launch.train`` runs of the reduced config ``name`` with its
    defaults (``want`` the reference run): the largest loss gap, the last
    step's grad norm gap relative to ``want``'s, and the gap of the
    parameters' updates over the run relative to ``want``'s update,
    ||(p_got - p0) - (p_want - p0)|| / ||p_want - p0||, p0 the runs'
    common start."""
    from repro_torch import configs
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch.train import RunConfig
    from repro_torch.models.lm import LM
    err = max(abs(a - b) for a, b in zip(want["losses"], got["losses"]))
    g0, g1 = want["grad_norms"][-1], got["grad_norms"][-1]
    start = LM(reduced(configs.get(name))).init_params(
        torch.Generator().manual_seed(RunConfig(arch=name).seed))
    return err, abs(g1 - g0) / g0, update_gap(
        start, want["state"]["params"], got["state"]["params"], "cpu")


def train_card_vs_cpu(name, dev) -> dict:
    """``launch.train`` on a reduced config for TRAIN_STEPS steps on the
    CPU and on the card, from the same parameters (one CPU draw) and the
    same batches (the stream draws on the CPU); the card run takes the CPU
    run's MoE routing call by call (forward and rematerialized forward),
    and the steps at which its own router would have chosen otherwise
    (near ties) are reported.  Loss curves within TRAIN_LOSS_ERR, the
    last step's grad norm within TRAIN_GNORM_REL and the parameters'
    update over the run within TRAIN_UPDATE_REL, relative."""
    from repro_torch.launch.train import RunConfig, train
    run = dict(arch=name, steps=TRAIN_STEPS, log_every=0)
    out = {}
    with routing() as rec_cpu:
        t0 = time.perf_counter()
        out["cpu"] = train(RunConfig(device="cpu", **run))
        cpu_s = time.perf_counter() - t0
    with routing(pin=rec_cpu.calls if rec_cpu.calls else None) as rec:
        t0 = time.perf_counter()
        out["card"] = train(RunConfig(device=str(dev), **run))
        sync(dev)
        card_s = time.perf_counter() - t0
    cpu_l, card_l = out["cpu"]["losses"], out["card"]["losses"]
    cpu_g = out["cpu"]["grad_norms"][-1]
    card_g = out["card"]["grad_norms"][-1]
    err, gnorm_rel, update_rel = train_gaps(name, out["cpu"], out["card"])
    apart, most = [], 0.0
    if rec.flips:
        per_step = len(rec.flips) // TRAIN_STEPS
        apart = sorted({i // per_step for i, (flip, _) in
                        enumerate(rec.flips) if bool(flip.any())})
        most = max((float(m[f].max()) for f, m in rec.flips
                    if bool(f.any())), default=0.0)
    tokens, least = rec.apart()
    print(f"train reduced {name}: {TRAIN_STEPS} steps, card {card_s:.3f} s, "
          f"CPU {cpu_s:.3f} s; losses card "
          f"{[round(x, 6) for x in card_l]}, CPU "
          f"{[round(x, 6) for x in cpu_l]}; max |dloss| {err:.6f} "
          f"(bound {TRAIN_LOSS_ERR}); last grad_norm card {card_g:.6f}, "
          f"CPU {cpu_g:.6f}, relative {gnorm_rel:.6f} (bound "
          f"{TRAIN_GNORM_REL}); parameter update relative gap "
          f"{update_rel:.6f} (bound {TRAIN_UPDATE_REL})"
          + (f"; MoE: the card takes the CPU run's experts, its own router "
             f"chose otherwise at steps {apart} ({tokens} token choices, "
             f"top-k margins {least:.3g} to {most:.3g})" if apart else
             "; MoE routed alike" if rec.flips else ""))
    if (not all(math.isfinite(x) for x in card_l) or err > TRAIN_LOSS_ERR
            or not gnorm_rel <= TRAIN_GNORM_REL
            or not update_rel <= TRAIN_UPDATE_REL):
        raise AssertionError(f"train reduced {name}: card losses {card_l} "
                             f"vs CPU {cpu_l}: max |d| {err}; last grad "
                             f"norm relative {gnorm_rel}; update relative "
                             f"{update_rel}")
    return {"name": name, "card_losses": card_l, "cpu_losses": cpu_l,
            "max_abs_err": err, "grad_norm_rel": gnorm_rel,
            "update_rel": update_rel, "routed_apart_steps": apart,
            "apart_tokens": tokens, "apart_margin_max": most,
            "card_seconds": card_s, "cpu_seconds": cpu_s}


def train_resume(dev) -> dict:
    """Kill and resume on the card: 20 steps of reduced Qwen2.5-3B saving
    at step 10, against 10 steps with ``stop_after=10`` then a resumed
    run; losses and every state leaf equal bit for bit.  Run under
    ``torch.use_deterministic_algorithms`` (the embedding's backward is an
    indexed accumulate, non-deterministic on CUDA by default)."""
    import tempfile

    from repro_torch.launch.train import RunConfig, train
    from repro_torch.training.tree import items
    run = dict(arch="qwen2.5-3b", steps=20, ckpt_every=10, log_every=0,
               device=str(dev))
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            full = train(RunConfig(ckpt_dir=f"{d}/a", **run))
            train(RunConfig(ckpt_dir=f"{d}/b", stop_after=10, **run))
            resumed = train(RunConfig(ckpt_dir=f"{d}/b", **run))
    finally:
        torch.use_deterministic_algorithms(False)
    got, want = dict(items(resumed["state"])), dict(items(full["state"]))
    differ = [k for k, v in want.items() if not torch.equal(got[k], v)]
    if (resumed["losses"] != full["losses"][10:] or differ
            or sorted(got) != sorted(want)):
        raise AssertionError(f"train resume: losses {resumed['losses']} vs "
                             f"{full['losses'][10:]}; leaves differ: "
                             f"{differ}")
    print(f"train resume: reduced qwen2.5-3b 20 steps on the card, killed "
          f"after 10 and resumed: losses of steps 10-19 and all "
          f"{len(want)} state leaves identical bit for bit (deterministic "
          f"algorithms on)")
    return {"leaves": len(want), "losses": full["losses"]}


def full_train_step(cfg, policy, batch, dev) -> dict:
    """Two AdamW steps of the full config under ``policy`` on ``batch``,
    from the serving phase's seeded weights drawn anew on the card: per
    step the wall (host clock ending in a synchronize), its split at the
    gradient hook (forward + backward, then ``apply_updates``), loss and
    grad norm; the peak device memory of the two steps."""
    from repro_torch.launch.serve import init_params
    from repro_torch.models.lm import LM
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import TrainConfig, train_step

    params = init_params(cfg, dev)
    state = {"params": params, "opt": init_opt_state(params)}
    probe = {"embed.table[:64]": params["embed"]["table"][:64].clone(),
             "blocks.sub0.ffn.wi[0, :64]":
                 params["blocks"]["sub0"]["ffn"]["wi"][0, :64].clone(),
             "final_norm": params["final_norm"].clone()}
    sync(dev)
    held_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    lm = LM(cfg, remat_policy=policy)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=1,
                                         total_steps=100))
    steps = []
    for _ in range(2):
        marks = {}

        def mark(grads):
            sync(dev)
            marks["grads"] = time.perf_counter()
            return grads

        sync(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(lm, tcfg, state, batch,
                                    grad_transform=mark)
        sync(dev)
        t1 = time.perf_counter()
        steps.append(dict(wall_s=t1 - t0, backward_s=marks["grads"] - t0,
                          update_s=t1 - marks["grads"],
                          loss=metrics["loss"].item(),
                          grad_norm=metrics["grad_norm"].item()))
    peak = torch.cuda.max_memory_allocated(dev)
    now = {"embed.table[:64]": state["params"]["embed"]["table"][:64],
           "blocks.sub0.ffn.wi[0, :64]":
               state["params"]["blocks"]["sub0"]["ffn"]["wi"][0, :64],
           "final_norm": state["params"]["final_norm"]}
    moved = {k: not torch.equal(now[k], v) for k, v in probe.items()}
    del state, params, probe, now
    gc.collect()
    torch.cuda.empty_cache()
    return dict(policy=policy, steps=steps, peak_bytes=peak,
                held_bytes=held_bytes, moved=moved)


def train_phase(dev):
    """The train phase: reduced configs card vs CPU, kill and resume on the
    card, then Qwen2.5-3B at its published widths (all 36 layers), two
    AdamW steps under each remat policy.  No kernel of the port lies on
    this path: every launch count of the phase must stay 0.  Returns the
    rows it printed."""
    from repro_torch import configs
    from repro_torch.device import card_line
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.training.data import DataConfig, SyntheticStream

    reset_launch_counts()
    rows = {"reduced": [train_card_vs_cpu(n, dev) for n in TRAIN_REDUCED]}
    gc.collect()
    torch.cuda.empty_cache()
    rows["resume"] = train_resume(dev)

    cfg = configs.get("qwen2.5-3b")
    b, s = FULL_TRAIN_SHAPE
    batch = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                       global_batch=b, seed=SEED),
                            device=dev).batch_at(0)
    card = card_line(dev)
    full = []
    for policy in ("minimal", "dots", "off"):
        r = full_train_step(cfg, policy, batch, dev)
        full.append(r)
        st = r["steps"]
        print(f"train full {cfg.name} ({cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
              f"d_ff {cfg.d_ff}, vocab {cfg.vocab_padded()}, "
              f"{cfg.param_count()} parameters) remat {policy}, {b} x {s} "
              f"tokens, on {card}: "
              + "; ".join(f"step {i + 1}: wall {x['wall_s']:.4f} s "
                          f"(forward + backward {x['backward_s']:.4f} s, "
                          f"apply_updates {x['update_s']:.4f} s), loss "
                          f"{x['loss']:.6f}, grad_norm {x['grad_norm']:.6f}"
                          for i, x in enumerate(st))
              + f"; peak device memory {r['peak_bytes']} B "
              f"({r['held_bytes']} B held before the steps); params moved "
              f"{r['moved']}")
        if not all(math.isfinite(x["loss"]) for x in st):
            raise AssertionError(f"train full {policy}: loss not finite")
        if not st[1]["loss"] < st[0]["loss"]:
            raise AssertionError(f"train full {policy}: second loss "
                                 f"{st[1]['loss']} not below the first "
                                 f"{st[0]['loss']}")
        if not all(r["moved"].values()):
            raise AssertionError(f"train full {policy}: params did not "
                                 f"move: {r['moved']}")
    first = full[0]["steps"][0]
    for r in full[1:]:
        x = r["steps"][0]
        for key in ("loss", "grad_norm"):
            if abs(x[key] - first[key]) > REMAT_REL * abs(first[key]):
                raise AssertionError(
                    f"train full: remat {r['policy']} step 1 {key} "
                    f"{x[key]} vs minimal {first[key]}")
    rows["full"] = full
    counts = launch_counts()
    print(f"train: kernel launches during the phase {counts} (no kernel "
          f"of the port lies on the training path)")
    if any(counts.values()):
        raise AssertionError(f"train: kernels launched: {counts}")
    rows["launches"] = counts
    return rows


# --------------------------------------------------------------------------
# the model-parallel layer at world size 1 over NCCL
# --------------------------------------------------------------------------

MP_TRAIN_STEPS = 4


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def mesh_full_step(cfg, start, batch, dev, mesh, vocab_parallel=False,
                   microbatch=0, compress=False, keep=False) -> dict:
    """One AdamW step of the full config from the weights ``start`` (the
    train phase's seeded weights, held on the host): on the (1, 1) mesh,
    state and batch laid out by ``Rules`` and ``train_step`` with
    ``rules.act_shard()``, or with ``mesh`` None on plain tensors;
    optionally over microbatches and with int8 error-feedback compression
    (its error state laid out as the parameters).  The wall includes
    DTensor's first-call sharding propagation.  With ``keep``, the updated
    parameters come back on the host."""
    from repro_torch.distributed.sharding import Rules, distribute
    from repro_torch.models.lm import LM, _identity
    from repro_torch.training import compression
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_step import TrainConfig, train_step
    from repro_torch.training.tree import tree_map

    params = tree_map(lambda t: t.to(dev, copy=True), start)
    state = {"params": params, "opt": init_opt_state(params)}
    shard = _identity
    if mesh is not None:
        rules = Rules(cfg, mesh)
        state = distribute(state, rules.state_spec(state), mesh)
        batch = distribute(batch, rules.batch_spec(batch), mesh)
        shard = rules.act_shard()
    del params
    transform = None
    if compress:
        err = compression.init_error_state(state["params"])

        def transform(grads):
            return compression.compress_decompress(grads, err)[0]
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-4, warmup_steps=1,
                                         total_steps=100),
                       microbatch=microbatch)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, metrics = train_step(LM(cfg, vocab_parallel=vocab_parallel),
                                tcfg, state, batch, shard=shard,
                                grad_transform=transform)
    loss = _full(metrics["loss"]).item()
    sync(dev)
    wall = time.perf_counter() - t0
    out = dict(vocab_parallel=vocab_parallel, microbatch=microbatch,
               compress=compress, wall_s=wall, loss=loss,
               grad_norm=_full(metrics["grad_norm"]).item(),
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    if keep:
        out["params"] = tree_map(lambda t: _full(t).cpu(), state["params"])
    del state, batch, metrics, transform
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_options(cfg, start, batch_at, dev, mesh, card) -> list:
    """The full-width step over microbatches of one row, and the step with
    int8 compression, each on the (1, 1) mesh against the same step
    without a mesh: bit for bit (loss, grad norm and every updated
    parameter), the exact differences printed beside the train phase's
    bounds."""
    rows = []
    b, s = FULL_TRAIN_SHAPE
    for label, kw in (("microbatch 1", dict(microbatch=1)),
                      ("int8 compression", dict(compress=True))):
        plain = mesh_full_step(cfg, start, batch_at(), dev, None, keep=True,
                               **kw)
        meshed = mesh_full_step(cfg, start, batch_at(), dev, mesh, keep=True,
                                **kw)
        dl = meshed["loss"] - plain["loss"]
        dg = meshed["grad_norm"] - plain["grad_norm"]
        upd = update_gap(start, plain.pop("params"), meshed.pop("params"),
                         dev)
        r = dict(option=label, mesh=meshed, plain=plain, loss_diff=dl,
                 grad_norm_diff=dg, update_rel=upd,
                 bit_identical=dl == 0.0 and dg == 0.0 and upd == 0.0)
        rows.append(r)
        print(f"model-parallel full {cfg.name} (36 layers), {label}, "
              f"{b} x {s} tokens, on {card}: on the (1, 1) NCCL mesh step "
              f"wall {meshed['wall_s']:.4f} s (first call), loss "
              f"{meshed['loss']:.6f}, grad_norm {meshed['grad_norm']:.6f}, "
              f"peak device memory {meshed['peak_bytes']} B; without a mesh "
              f"{plain['wall_s']:.4f} s, loss {plain['loss']:.6f}, "
              f"grad_norm {plain['grad_norm']:.6f}, peak "
              f"{plain['peak_bytes']} B; loss difference {dl!r} (bound "
              f"{TRAIN_LOSS_ERR}), grad_norm difference {dg!r} (bound "
              f"{TRAIN_GNORM_REL} relative), update relative {upd!r} "
              f"(bound {TRAIN_UPDATE_REL}); all 0: {r['bit_identical']}")
        if not r["bit_identical"]:
            raise AssertionError(f"model-parallel step, {label}: {r}")
    return rows


def mesh_launch_train(dev, mesh, compress=False) -> dict:
    """``launch.train(run, mesh)`` on reduced Qwen2.5-3B against
    ``launch.train(run)`` on the card, bit for bit: every loss, grad norm
    and final parameter (the gaps printed beside the train phase's
    bounds); with ``compress``, both under ``compress_grads``."""
    from repro_torch.launch.train import RunConfig, train
    from repro_torch.training.tree import items, tree_map

    run = RunConfig(arch="qwen2.5-3b", steps=MP_TRAIN_STEPS, log_every=0,
                    device=str(dev), compress_grads=compress)
    plain = train(run)
    t0 = time.perf_counter()
    meshed = train(run, mesh=mesh)
    sync(dev)
    wall = time.perf_counter() - t0
    meshed["state"] = {"params": tree_map(_full, meshed["state"]["params"])}
    err, gnorm_rel, update_rel = train_gaps("qwen2.5-3b", plain, meshed)
    same = (meshed["losses"] == plain["losses"]
            and meshed["grad_norms"] == plain["grad_norms"]
            and all(torch.equal(a, b) for (_, a), (_, b) in zip(
                items(meshed["state"]["params"]),
                items(plain["state"]["params"]))))
    print(f"model-parallel launch.train reduced qwen2.5-3b"
          f"{', compress_grads' if compress else ''}, "
          f"{MP_TRAIN_STEPS} steps on the (1, 1) mesh: {wall:.3f} s; "
          f"losses {[round(x, 6) for x in meshed['losses']]} vs without a "
          f"mesh {[round(x, 6) for x in plain['losses']]}: max |dloss| "
          f"{err:.9f} (bound {TRAIN_LOSS_ERR}), last grad norm relative "
          f"{gnorm_rel:.9f} (bound {TRAIN_GNORM_REL}), update relative "
          f"{update_rel:.9f} (bound {TRAIN_UPDATE_REL}); losses, grad "
          f"norms and parameters bit-identical: {same}")
    if not same:
        raise AssertionError(f"model-parallel launch.train: {err}, "
                             f"{gnorm_rel}, {update_rel}")
    return dict(compress=compress, wall_s=wall, bit_identical=same,
                max_abs_err=err, grad_norm_rel=gnorm_rel,
                update_rel=update_rel, losses=meshed["losses"],
                plain_losses=plain["losses"])


def mesh_psum(dev) -> dict:
    """``quantized_psum`` over the one-rank NCCL group (its int32
    all-reduce on the card) against the same arithmetic without a
    collective, bit for bit, and within max|x| / 127 + 1e-5 of x."""
    from repro_torch.training.compression import _quant, quantized_psum

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(4096, generator=gen, device=dev)
    got = quantized_psum(x)
    _, scale = _quant(x)
    want = torch.clamp(torch.round(x / scale), -127, 127).to(
        torch.int32).float() * scale
    err = float((got - x).abs().max())
    bound = float(x.abs().max()) / 127 + 1e-5
    print(f"model-parallel quantized_psum over NCCL (1 rank, 4096 f32): "
          f"identical to the plain requantization: "
          f"{bool(torch.equal(got, want))}; max |sum - x| {err:.6g} "
          f"(bound {bound:.6g})")
    if not torch.equal(got, want) or not err <= bound:
        raise AssertionError(f"model-parallel quantized_psum: {err}")
    return dict(max_abs_err=err, bound=bound)


def model_parallel_phase(dev, train_rows) -> dict:
    """The model-parallel phase, at world size 1 (one card; NCCL takes no
    two ranks on one card): an NCCL process group and a (1, 1)
    ("data", "model") mesh; one AdamW step of Qwen2.5-3B at its published
    widths on the train phase's weights and 2 x 1024 batch, state and
    batch laid out by ``Rules``, once with ``vocab_parallel`` off and
    once on, each step's loss and grad norm held to the train phase's
    first ``minimal`` step: bit for bit with ``vocab_parallel`` off (a
    one-rank mesh computes what one device computes), within
    TRAIN_LOSS_ERR and TRAIN_GNORM_REL with it on (its one-hot embedding
    product rounds the table's gradient apart by design); then the
    full-width step over microbatches of one row and the step with int8
    compression, each on the mesh against the same step without one, bit
    for bit (``mesh_options``); ``launch.train`` on the mesh without and
    with ``compress_grads``, bit for bit, and ``quantized_psum``.  The
    weights are drawn on the card once and held on the host for every
    step.  No kernel of the port lies on the path: every launch count must
    stay 0."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.device import card_line
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import init_params
    from repro_torch.training.data import DataConfig, SyntheticStream
    from repro_torch.training.tree import tree_map

    card = card_line(dev)
    want = train_rows["full"][0]["steps"][0]
    cfg = configs.get("qwen2.5-3b")
    b, s = FULL_TRAIN_SHAPE
    rows = {"card": card}
    start = tree_map(lambda t: t.cpu(), init_params(cfg, dev))
    torch.cuda.empty_cache()

    def batch_at():
        return SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=s, global_batch=b,
                                          seed=SEED), device=dev).batch_at(0)
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_host_mesh(model=1, data=1, device_type="cuda")
            steps = []
            for vp in (False, True):
                r = mesh_full_step(cfg, start, batch_at(), dev, mesh, vp)
                dl = r["loss"] - want["loss"]
                dg = r["grad_norm"] - want["grad_norm"]
                r.update(loss_diff=dl, grad_norm_diff=dg,
                         bit_identical=dl == 0.0 and dg == 0.0)
                steps.append(r)
                print(f"model-parallel full {cfg.name} (36 layers) on the "
                      f"(1, 1) NCCL mesh, vocab_parallel {vp}, {b} x {s} "
                      f"tokens, on {card}: step wall {r['wall_s']:.4f} s "
                      f"(first call, sharding propagation included), loss "
                      f"{r['loss']:.6f} (train phase {want['loss']:.6f}, "
                      f"difference {dl!r}), grad_norm "
                      f"{r['grad_norm']:.6f} (train phase "
                      f"{want['grad_norm']:.6f}, difference {dg!r}); "
                      f"bit-identical: {r['bit_identical']}; peak device "
                      f"memory {r['peak_bytes']} B")
                if (not (r["bit_identical"] or vp)
                        or not abs(dl) <= TRAIN_LOSS_ERR
                        or not abs(dg) <= TRAIN_GNORM_REL
                        * abs(want["grad_norm"])):
                    raise AssertionError(f"model-parallel step "
                                         f"vocab_parallel={vp}: {r}")
            rows["full"] = steps
            rows["options"] = mesh_options(cfg, start, batch_at, dev, mesh,
                                           card)
            rows["launch_train"] = mesh_launch_train(dev, mesh)
            rows["launch_train_compress"] = mesh_launch_train(
                dev, mesh, compress=True)
            rows["quantized_psum"] = mesh_psum(dev)
        finally:
            dist.destroy_process_group()
    counts = launch_counts()
    print(f"model-parallel: kernel launches during the phase {counts}")
    if any(counts.values()):
        raise AssertionError(f"model-parallel: kernels launched: {counts}")
    return rows


# --------------------------------------------------------------------------
# phase 11b: the dry run, in a child process
# --------------------------------------------------------------------------

DRYRUN_LAYERS = 4           # Qwen2.5-3B's published widths, 4 of 36 layers
DRYRUN_MEM_REL = 0.10       # predicted peak against the card's
DRYRUN_BUDGET_S = 120.0     # the phase's wall, child process included
# production cells traced at full width and depth on the fake world
DRYRUN_CELLS = (("qwen2.5-3b", "decode_32k", "single"),
                ("mixtral-8x7b", "decode_32k", "multipod"))
EXAMPLES = ("torch_quickstart.py", "torch_parked_decode.py")


def dryrun_real_step(cfg, batch, dev, store: str) -> dict:
    """One ``train_step`` of ``cfg`` on the card over an NCCL group of one
    rank and a (1, 1) mesh (the dry run's layout code on real tensors):
    FLOPs by ``FlopCounterMode``, the peak of device memory over what the
    process held before the state was drawn."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.sharding import Rules, distribute
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import init_params
    from repro_torch.models.lm import LM
    from repro_torch.training.optimizer import init_opt_state
    from repro_torch.training.train_step import TrainConfig, train_step

    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh(model=1, data=1, device_type="cuda")
        rules = Rules(cfg, mesh, sp_activations=True)
        sync(dev)
        before = torch.cuda.memory_allocated(dev)
        params = init_params(cfg, dev)
        state = {"params": params, "opt": init_opt_state(params)}
        state = distribute(state, rules.state_spec(state), mesh)
        batch = distribute(batch, rules.batch_spec(batch), mesh)
        del params
        sync(dev)
        held = torch.cuda.memory_allocated(dev) - before
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as counter:
            _, metrics = train_step(LM(cfg), TrainConfig(), state, batch,
                                    shard=rules.act_shard())
        loss = _full(metrics["loss"]).item()
        sync(dev)
        out = dict(wall_s=time.perf_counter() - t0, loss=loss,
                   flops=counter.get_total_flops(), held_bytes=held,
                   peak_bytes=torch.cuda.max_memory_allocated(dev) - before)
        del state, batch, metrics
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dryrun_child(out_path: str) -> int:
    """Phase 11b's body, run in a process of its own (the parent holds an
    NCCL group, and a process has one default group): Qwen2.5-3B at its
    published widths, DRYRUN_LAYERS layers, one real ``train_step`` on 2 x
    1024 tokens against the dry run's prediction of it on a (1, 1) fake
    mesh of the card's device type (FLOPs equal, peak memory within
    DRYRUN_MEM_REL); then ``run_cell`` on DRYRUN_CELLS at full width and
    depth.  No kernel launches, and the fake traces take no device
    memory."""
    import dataclasses as dc
    import tempfile

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.device import card_line
    from repro_torch.distributed.sharding import Rules
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM
    from repro_torch.training.data import DataConfig, SyntheticStream

    dev = torch.device("cuda", 0)
    card = card_line(dev)
    capacity = torch.cuda.get_device_properties(dev).total_memory
    cfg = dc.replace(configs.get("qwen2.5-3b"), num_layers=DRYRUN_LAYERS)
    b, s = FULL_TRAIN_SHAPE
    batch = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                       global_batch=b, seed=SEED),
                            device=dev).batch_at(0)
    rows = {"card": card, "capacity_bytes": capacity}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        real = dryrun_real_step(cfg, batch, dev, f"{d}/store")
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with dryrun.fake_world(1):
            mesh = make_host_mesh(model=1, data=1, device_type="cuda")
            cost, mem = dryrun.trace_once(
                LM(cfg), ShapeConfig("train_2x1024", s, b, "train"), mesh,
                Rules(cfg, mesh, sp_activations=True), "cuda")
        trace_s = time.perf_counter() - t0
        mem_rel = ((mem["peak_bytes"] - real["peak_bytes"])
                   / real["peak_bytes"])
        rows["step"] = dict(real=real, predicted=dict(
            flops=cost["flops"], peak_bytes=mem["peak_bytes"],
            argument_bytes=mem["argument_bytes"], trace_s=trace_s),
            peak_rel=mem_rel)
        print(f"dry run: {cfg.name} ({cfg.num_layers} of 36 layers, d_model "
              f"{cfg.d_model}), one train_step on {b} x {s} tokens under "
              f"minimal on {card}: real {real['flops']} FLOPs, peak "
              f"{real['peak_bytes']} B ({real['held_bytes']} B of state and "
              f"batch), wall {real['wall_s']:.3f} s, loss {real['loss']:.6f}; "
              f"the dry run on a (1, 1) fake mesh (cuda): {cost['flops']:.0f} "
              f"FLOPs, peak {mem['peak_bytes']} B (argument "
              f"{mem['argument_bytes']} B), relative {mem_rel:+.6f} (bound "
              f"{DRYRUN_MEM_REL}), traced in {trace_s:.2f} s")
        if cost["flops"] != real["flops"]:
            raise AssertionError(f"dry run: predicted FLOPs {cost['flops']} "
                                 f"!= measured {real['flops']}")
        if not abs(mem_rel) <= DRYRUN_MEM_REL:
            raise AssertionError(f"dry run: predicted peak {mem['peak_bytes']}"
                                 f" vs measured {real['peak_bytes']}")
        cells = []
        for arch, shape_name, mesh_kind in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape_name, mesh_kind, out_dir=d,
                                  device="cuda")
            if rec["status"] != "ok":
                raise AssertionError(f"dry run {rec['cell']}: {rec}")
            m, c = rec["memory"], rec["cost"]
            fits = m["peak_bytes"] <= capacity
            cells.append(dict(cell=rec["cell"], devices=rec["devices"],
                              trace_s=rec["compile_s"],
                              probe_s=rec["probe_s"], fits=fits,
                              memory=m, flops=c["flops"],
                              bytes_accessed=c["bytes_accessed"],
                              coll_total_bytes=c["coll_total_bytes"]))
            print(f"dry run {rec['cell']} ({rec['devices']} devices, fake "
                  f"world, device type cuda): traced {rec['compile_s']} s + "
                  f"probes {rec['probe_s']} s; per device {c['flops']:.6g} "
                  f"FLOPs, {c['bytes_accessed']:.6g} B accessed, "
                  f"{c['coll_total_bytes']:.6g} B of collectives; peak "
                  f"{m['peak_bytes']} B against the card's {capacity} B: "
                  f"fits {fits}")
        rows["cells"] = cells
        moved = torch.cuda.memory_allocated(dev) - held
    counts = launch_counts()
    rows.update(launches=counts, device_bytes_moved=moved)
    print(f"dry run: device memory allocated across the fake traces moved "
          f"by {moved} B; kernel launches {counts}")
    if moved:
        raise AssertionError(f"dry run: fake traces took {moved} B")
    if any(counts.values()):
        raise AssertionError(f"dry run: kernels launched: {counts}")
    Path(out_path).write_text(json.dumps(rows))
    return 0


def dryrun_phase() -> dict:
    """Phase 11b: ``dryrun_child`` in a child process, within
    DRYRUN_BUDGET_S; then the two example twins on the card, each a
    process of its own that must exit 0."""
    import subprocess
    import tempfile

    here = Path(__file__).resolve()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dr_") as d:
        out = Path(d) / "dryrun.json"
        subprocess.run([sys.executable, str(here), "--dryrun-child",
                        str(out)], check=True)
        rows = json.loads(out.read_text())
    wall = time.perf_counter() - t0
    rows["wall_s"] = wall
    print(f"dry run phase: {wall:.1f} s (budget {DRYRUN_BUDGET_S} s)")
    if wall > DRYRUN_BUDGET_S:
        raise AssertionError(f"dry run phase took {wall:.1f} s")
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"))
    for name in EXAMPLES:
        t1 = time.perf_counter()
        r = subprocess.run([sys.executable, str(here.parent / "examples"
                                                / name)],
                           capture_output=True, text=True, env=env)
        print(f"example {name} on the card: exit {r.returncode} in "
              f"{time.perf_counter() - t1:.1f} s; last line "
              f"{r.stdout.strip().splitlines()[-1:]}")
        if r.returncode:
            raise AssertionError(f"example {name}: {r.stdout}{r.stderr}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-child":
        sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
        return dryrun_child(sys.argv[2])
    # cuBLAS reads this when it makes its handle: the train phase's
    # kill-and-resume check runs under deterministic algorithms, which
    # need it set before the first product on the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.device import card_line
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()

    def stamp(done: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] {done} done")

    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.build().name})")
    print((build.BUILD_DIR / "build.log").read_text()
          if (build.BUILD_DIR / "build.log").exists() else "build: cached")

    err, big = check_kernels(dev)
    err["paged_attention"] = check_paged(dev)
    times = time_kernels(dev)
    paged = time_paged(dev)
    times["paged_attention"] = paged["engine"]
    stamp("phase 2 (kernels)")
    quickstart(dev)
    counts, traced, pipes8 = engine(dev)
    stamp("phases 3-4 (quickstart, engine)")
    counts["chain"], chain_traced, chain_runs = chain_phase(dev)
    stamp("phase 5 (chain)")
    counts["fabric"], fabric_rows = fabric_phase(dev, pipes8, chain_runs)
    del pipes8, chain_runs
    stamp("fabric phase")
    counts["serve"], serve_traced = serve_phase(dev)
    stamp("phase 6 (serving)")
    # phase 7, after the timed runs of phases 2-6 (a torch.profiler session
    # slows the launches that follow it in the same process) and before
    # the stream and adversarial phases (after them, the profiles here
    # have recorded no device event)
    durations = one_kernel_per_call(dev)
    for label, run, steps in (traced + chain_traced + serve_traced
                              + stream_traced()):
        profile_steps(label, run, dev, steps)
    del traced, chain_traced, serve_traced  # their runs hold weights
    stamp("phase 7 (traces)")
    counts["stream"] = stream_phase(dev)
    stamp("stream phase")
    counts["adversarial"] = adversarial_phase(dev)
    stamp("adversarial phase")
    gc.collect()
    torch.cuda.empty_cache()
    counts["mixtral"], lm_rows = lm_phase(dev)
    stamp("LM phase")
    gc.collect()
    torch.cuda.empty_cache()
    train_rows = train_phase(dev)
    stamp("train phase")
    gc.collect()
    torch.cuda.empty_cache()
    mp_rows = model_parallel_phase(dev, train_rows)
    stamp("model-parallel phase")
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_rows = dryrun_phase()
    stamp("dry-run phase and examples")

    # ``launches`` is the count on the kernel's own main path: pipes8 for
    # the Split -> FW -> NAT -> Merge kernels (0 for crc16 and
    # payload_fetch, whose code runs inside split_control and merge_stage
    # there, and for acl_match, whose code runs inside nf_chain), the chain
    # for maglev (0 too: its code runs inside nf_chain), the full-width
    # serving run for paged_attention (whose times are those of the
    # engine's shape; ``batched`` holds the batched shape's, and nf_chain's
    # ``chain`` the chain path's FW -> NAT -> LB at 2 x 256)
    main_path = dict.fromkeys(DATAPLANE_KERNELS + INSIDE_CONTROL
                              + ("acl_match",), "pipes8")
    main_path.update(maglev="chain", paged_attention="serve")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name in REPLACES:
        r = times[name]
        row = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=counts[main_path[name]][name],
            launches_pipes8=counts["pipes8"][name],
            launches_recirc=counts["recirc1"][name],
            launches_chain=counts["chain"][name],
            launches_serve=counts["serve"][name],
            launches_stream=counts["stream"][name],
            launches_adversarial=counts["adversarial"][name],
            launches_fabric={n: c[name]
                             for n, c in counts["fabric"].items()},
            max_abs_err=err[name], **{k: r[k] for k in keys},
            profiler_ms=durations.get(name))
        if name in big:  # past the one-block limits (phase 2)
            row["past_limit"] = {k: big[name][k] for k in
                                 keys[:-1] + ("shape", "launches")}
        if name == "paged_attention":
            row["batched"] = {k: paged["batched"][k]
                              for k in keys + ("gather_ms",)}
            # the LM phase's Mixtral-8x7B serving run (16 layers)
            row["launches_mixtral"] = counts["mixtral"][name]
        if name == "nf_chain":
            row["chain"] = {k: times["nf_chain chain"][k] for k in keys}
        if name == "merge_payload":  # both benchmark cells' shapes
            row["shape"] = times[name]["shape"]
            row["cell2"] = {k: times["merge_payload W352"][k]
                            for k in keys + ("shape",)}
        if name == "split_control":  # the stream's and the chain's shapes
            row["shapes"] = {
                label: dict(profiler_ms=durations[f"{name} {label}"],
                            **{k: times[f"{name} {label}"][k] for k in keys})
                for label, *_ in SPLIT_SHAPES if label}
        kernels.append(row)
    print(json.dumps({"lm": lm_rows}))
    print(json.dumps({"train": train_rows}))
    print(json.dumps({"fabric": fabric_rows, "model_parallel": mp_rows}))
    print(json.dumps({"dryrun": dryrun_rows}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
