"""Degradation gates of the adversarial family's failover points over
several seeds, in the JAX reference or in the PyTorch port (on the CPU).

    PYTHONPATH=src python tools/degradation_seeds.py reference 0 6
    PYTHONPATH=src python tools/degradation_seeds.py port 0 8

Prints, per seed, whether every gate of ``failover_drain`` and
``failover_drop`` holds at full geometry, with each point's
``recovery_steps`` and drop rate.  The two packages draw different
traffic from one seed (``jax.random`` against ``torch.Generator``); on
the same traffic they agree exactly (tests/test_torch_adversarial.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package", choices=("reference", "port"))
    ap.add_argument("first", type=int, help="first seed")
    ap.add_argument("stop", type=int, help="one past the last seed")
    args = ap.parse_args()
    if args.package == "port":
        import repro_torch.scenarios as S
        kw = dict(device="cpu")
    else:
        import repro.scenarios as S
        kw = {}
    points = [s for s in S.family("adversarial")
              if s.name.startswith("failover")]
    for seed in range(args.first, args.stop):
        t0 = time.perf_counter()
        res = S.run_matrix([dataclasses.replace(s, seed=seed)
                            for s in points], **kw)
        block = S.degradation_block(res)
        cells = ", ".join(
            f"{name} recovery_steps {sc['metrics']['recovery_steps']} "
            f"drop_rate {sc['metrics']['drop_rate']}"
            for name, sc in block["scenarios"].items())
        print(f"{args.package} seed {seed}: gates ok {block['ok']}; {cells} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
