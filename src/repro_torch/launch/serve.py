"""Batched serving driver: admit a stream of requests, decode with parked KV
pages, report throughput and pool health (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --full --requests 4 --prompt-len 128 --gen-len 32 --page-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch gemma-7b --requests 4 --prompt-len 8 --gen-len 8

Runs on the card unless ``--device cpu`` is given.  Weights are random,
drawn from a seeded ``torch.Generator`` on the device; prompts from a
seeded CPU generator.  The report names the device it ran on (the card's
name and power limit).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.reduced import reduced
from repro_torch.device import card_line, resolve_device
from repro_torch.models.lm import LM
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.pool import PoolConfig

WEIGHT_SEED = 0
PROMPT_SEED = 1


def engine_config(prompt_len: int, gen_len: int, max_batch: int, pages: int,
                  page_tokens: int) -> EngineConfig:
    """The reference driver's engine geometry."""
    return EngineConfig(
        max_batch=max_batch,
        max_pages_per_req=(prompt_len + gen_len) // page_tokens + 2,
        pool=PoolConfig(num_pages=pages, page_tokens=page_tokens))


def init_params(cfg: ModelConfig, device, seed: int = WEIGHT_SEED) -> dict:
    """Random weights drawn on ``device`` from a generator seeded ``seed``."""
    dev = resolve_device(device)
    return LM(cfg).init_params(torch.Generator(device=dev).manual_seed(seed))


def make_prompts(requests: int, prompt_len: int, vocab_size: int,
                 seed: int = PROMPT_SEED) -> list[list[int]]:
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, vocab_size, (prompt_len,), generator=gen).tolist()
            for _ in range(requests)]


@dataclasses.dataclass
class ServeReport:
    done: int          # requests that completed (Merge)
    cancelled: int     # requests cancelled by the client (Explicit Drop)
    tokens: int        # decode tokens produced by active requests
    seconds: float     # host clock, ending in a device synchronize
    stats: dict


def serve(eng: ServeEngine, prompts: list[list[int]], gen_len: int,
          cancel: Optional[dict[int, int]] = None,
          before_step: Optional[Callable[[ServeEngine], None]] = None
          ) -> ServeReport:
    """The reference driver's loop: admit while a slot is free, one decode
    step for every active request, finish each request after ``gen_len``
    steps.  ``cancel`` maps a request id to the number of its steps after
    which the client cancels it; ``before_step`` is called before each
    decode step."""
    cancel = cancel or {}
    pending = list(range(len(prompts)))
    steps_left: dict[int, int] = {}
    done = cancelled = toks_out = 0
    t0 = time.perf_counter()
    while pending or steps_left:
        while pending and (~eng.active).any():
            rid = pending.pop(0)
            if eng.admit(rid, prompts[rid]):
                steps_left[rid] = gen_len
        if before_step is not None:
            before_step(eng)
        eng.step()
        toks_out += int(eng.active.sum())
        for rid in list(steps_left):
            steps_left[rid] -= 1
            if rid in cancel and gen_len - steps_left[rid] >= cancel[rid]:
                eng.finish(rid, cancel=True)
                del steps_left[rid]
                cancelled += 1
            elif steps_left[rid] <= 0:
                eng.finish(rid)
                del steps_left[rid]
                done += 1
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return ServeReport(done, cancelled, toks_out, time.perf_counter() - t0,
                       eng.stats())


def main(argv: Optional[list[str]] = None) -> ServeReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b",
                    choices=[n for n in configs.names()])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--pages", type=int, default=256)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full config (else the reduced CPU-smoke variant)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    eng = ServeEngine(LM(cfg), init_params(cfg, dev), engine_config(
        args.prompt_len, args.gen_len, args.max_batch, args.pages,
        args.page_tokens))
    prompts = make_prompts(args.requests, args.prompt_len, cfg.vocab_size)
    rep = serve(eng, prompts, args.gen_len)
    print(f"served {rep.done} requests, {rep.tokens} tokens in "
          f"{rep.seconds:.3f}s ({rep.tokens / rep.seconds:.1f} tok/s) on "
          f"{card_line(dev)}; {cfg.name}")
    print("pool stats:", rep.stats)
    return rep


if __name__ == "__main__":
    main()
