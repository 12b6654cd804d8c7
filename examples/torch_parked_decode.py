"""Serving with parked KV pages on the PyTorch port: the paper's
Split/Merge/Evict machinery running as a paged-KV allocator, with
header-only routing accounting (the port's twin of
``examples/parked_decode.py``).

    PYTHONPATH=src python examples/torch_parked_decode.py             # card
    PYTHONPATH=src python examples/torch_parked_decode.py --device cpu
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.configs.reduced import reduced
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.pool import PoolConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced(configs.get("gemma-7b"))
    lm = LM(cfg, remat_policy="off")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(lm, params, EngineConfig(
        max_batch=4, max_pages_per_req=16,
        pool=PoolConfig(num_pages=128, page_tokens=8, max_exp=2)))

    print(f"admitting 3 requests (prefill -> parked pages) on {dev}...")
    eng.admit(1, [5, 3, 8, 1])
    eng.admit(2, [9, 9, 2])
    eng.admit(3, [4, 4, 4, 4, 4, 4])
    for _ in range(6):
        eng.step()

    print("request 2 cancelled mid-flight (Explicit Drop frees its pages)")
    eng.finish(2, cancel=True)
    out1 = eng.finish(1)
    out3 = eng.finish(3)
    print(f"request 1 -> {out1}")
    print(f"request 3 -> {out3}")

    s = eng.stats()
    print("\npool counters (the paper's Split/Merge/Evict set):")
    for k in ("splits", "merges", "explicit_drops", "evictions",
              "premature_evictions", "occupancy"):
        print(f"  {k:22s} {s[k]}")
    print(f"\nheader bytes routed:      {s['header_bytes']}")
    print(f"payload bytes kept parked: {s['payload_bytes_avoided']}")
    print(f"serving goodput gain:      {s['goodput_gain']:.0f}x "
          f"(the paper's Fig. 8 effect, at KV-page scale)")


if __name__ == "__main__":
    main()
