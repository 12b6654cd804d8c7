"""Quickstart on the PyTorch port: park payloads on the 'switch', run a
shallow NF chain on headers only, merge, and verify wire-level functional
equivalence (the port's twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.core.packet import wire_bytes
from repro_torch.core.park import (ParkConfig, init_state, merge_fn,
                                   split_fn, stats)
from repro_torch.device import resolve_device
from repro_torch.nf.chain import Chain
from repro_torch.nf.firewall import Firewall
from repro_torch.nf.nat import Nat
from repro_torch.switchsim.simulate import baseline_roundtrip
from repro_torch.traffic.generator import enterprise


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    wl = enterprise()
    pkts = wl.make_batch(0, 256, pmax=2048, device=dev)
    print(f"workload: {wl.name}, mean packet {wl.mean_pkt_bytes:.0f}B, "
          f"on {dev}")

    cfg = ParkConfig(capacity=512, max_exp=2)
    state = init_state(cfg, dev)

    # Split: park payloads, forward headers (+ un-parked tails)
    state, to_server = split_fn(cfg, state, pkts)
    in_bytes = int(torch.sum(pkts.pkt_len()))
    srv_bytes = int(torch.sum(to_server.pkt_len()))
    print(f"switch->server bytes: {srv_bytes} vs {in_bytes} "
          f"({100 * (1 - srv_bytes / in_bytes):.1f}% parked)")

    # Shallow NFs see only headers
    chain = Chain((Firewall(rules=(int(pkts.src_ip[3]),)), Nat()))
    cstate = chain.init_state(dev)
    cstate, from_server, dropped, cycles = chain.run(cstate, to_server)
    print(f"chain dropped {int(dropped.sum())} packets, "
          f"{cycles:.0f} cycles/pkt")

    # Merge: re-attach parked payloads
    state, out = merge_fn(cfg, state, from_server)
    print("switch counters:", stats(state))

    # Functional equivalence vs running the chain on whole packets
    ref, _, _ = baseline_roundtrip(chain, pkts, device=dev)
    got, got_len = wire_bytes(out)
    want, want_len = wire_bytes(ref)
    assert torch.equal(got, want) and torch.equal(got_len, want_len), \
        "wire mismatch!"
    print("wire-level functional equivalence: OK (paper §6.2.6)")


if __name__ == "__main__":
    main()
