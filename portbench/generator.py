"""The benchmark's one traffic generator: draws a cell's scenario traces on
the device from ``--seed``, as a traffic mix file and a configuration file
describe them.

A trace is one scenario: P pipes (one NF server's link each) of ``steps``
engine steps of ``chunk`` packets, every slot a live packet (the link is
never idle within a scenario).  Each pipe of each trace carries the mix's
sizes in exact counts (largest remainder of ``probs`` times the packets a
pipe sends), in an order drawn from the seed, so every seed offers the
same bytes and only their order changes.  Sources come from the pipe's
pool of ``flows_per_pipe`` flows, whose first ``fw_rules`` addresses are the
firewall's blocked sources, so FW drops happen on every pipe; destinations,
MACs and payload bytes are uniform draws.

The generator is a plain copy of the port's mixes and packet layout
(``traffic/generator.py``: sizes, probabilities, ``make_udp_batch``'s field
ranges, ``flow_pool``), drawn on the device in a few large calls.
"""
from __future__ import annotations

import torch

HDR_BYTES = 42
INT31 = (1 << 31) - 1


def exact_counts(probs, n: int) -> list[int]:
    """``probs`` times ``n`` rounded to whole packets that sum to ``n``
    (largest remainder)."""
    raw = [p * n for p in probs]
    counts = [int(r) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: counts[i] - raw[i])
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return counts


def draw(config: dict, mix: dict, seed: int, device) -> tuple[list, list]:
    """(traces, rules): ``mix["scenarios"]`` dicts of (P, T, chunk, ...)
    tensors named as the packet fields, and the firewall's blocked
    sources."""
    pipes, steps, chunk = config["pipes"], mix["steps"], mix["chunk"]
    pmax, flows, nrules = mix["pmax"], config["flows_per_pipe"], \
        config["fw_rules"]
    if max(mix["sizes"]) - HDR_BYTES > pmax:
        raise ValueError(f"a {max(mix['sizes'])} B frame does not fit pmax "
                         f"{pmax}")
    if not 0 < nrules < flows:
        raise ValueError(f"need 0 < fw_rules < flows_per_pipe, got "
                         f"{nrules}, {flows}")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    rules = ints(1, INT31, (nrules,))
    pool_ip = ints(1, INT31, (pipes, flows))
    pool_ip[:, :nrules] = rules
    pool_port = ints(1024, 65536, (pipes, flows))
    n = steps * chunk
    counts = exact_counts(mix["probs"], n)
    base = torch.repeat_interleave(
        torch.tensor(mix["sizes"], dtype=torch.int32, device=dev),
        torch.tensor(counts, device=dev))
    col = torch.arange(pmax, device=dev)
    shape = (pipes, steps, chunk)
    traces = []
    for _ in range(mix["scenarios"]):
        order = torch.argsort(torch.rand((pipes, n), generator=g,
                                         device=dev), dim=-1)
        plen = (base[order] - HDR_BYTES).reshape(shape)
        payload = torch.randint(0, 256, shape + (pmax,), generator=g,
                                device=dev, dtype=torch.uint8)
        for t in range(steps):
            payload[:, t].masked_fill_(col >= plen[:, t, :, None], 0)
        flow = ints(0, flows, (pipes, n)).to(torch.int64)
        zero = torch.zeros(shape, dtype=torch.int32, device=dev)
        traces.append(dict(
            dst_mac=ints(0, INT31, shape), src_mac=ints(0, INT31, shape),
            src_ip=torch.gather(pool_ip, 1, flow).reshape(shape),
            dst_ip=ints(0, INT31, shape),
            proto=torch.full(shape, 17, dtype=torch.int32, device=dev),
            src_port=torch.gather(pool_port, 1, flow).reshape(shape),
            dst_port=ints(1024, 65536, shape),
            payload_len=plen, payload=payload,
            alive=torch.ones(shape, dtype=torch.bool, device=dev),
            pp_valid=torch.zeros(shape, dtype=torch.bool, device=dev),
            pp_enb=zero, pp_op=zero.clone(), pp_ti=zero.clone(),
            pp_clk=zero.clone(), pp_crc=zero.clone()))
    return traces, rules.tolist()
