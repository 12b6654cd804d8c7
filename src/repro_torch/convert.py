"""Carry state and parameters across from the reference package through
numpy.

The reference's packets, switch state, NF-chain states, serving pool and
LM parameters are pytrees of arrays; ``np.asarray`` turns each leaf into
numpy.  These helpers build the port's counterparts from such objects
(anything with the same attribute or key names whose leaves
``np.asarray`` accepts), so the same numbers feed both packages.  NFs,
chains and scenario points are rebuilt from their class names and
fields.  Nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.packet import FIELDS, PacketBatch
from repro_torch.core.park import ParkState
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.nf.chain import Chain
from repro_torch.nf.firewall import Firewall
from repro_torch.nf.macswap import MacSwap
from repro_torch.nf.maglev import MaglevLB
from repro_torch.nf.nat import Nat
from repro_torch.scenarios.runner import Prepared
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.serving.pool import PoolState
from repro_torch.switchsim.faults import FaultArrays, FaultSpec

_NFS = {cls.__name__: cls for cls in (Firewall, Nat, MaglevLB, MacSwap)}


def tensor(a, device=DEFAULT_DEVICE) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` accepts) as a tensor of
    the same dtype on ``device``.  bfloat16 (``ml_dtypes.bfloat16`` in
    numpy, which ``torch.from_numpy`` refuses) goes across bit for bit as
    uint16."""
    a = np.array(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def lm_params(src, device=DEFAULT_DEVICE):
    """The port's parameter dict from the reference's parameter pytree
    (nested dicts of arrays), leaf for leaf: same keys, shapes and
    dtypes."""
    if isinstance(src, dict):
        return {k: lm_params(v, device) for k, v in src.items()}
    return tensor(src, device)


def pool_state(src, device=DEFAULT_DEVICE) -> PoolState:
    """A serving PoolState from an object with the PoolState fields."""
    return PoolState(**{f.name: tensor(_get(src, f.name), device)
                        for f in dataclasses.fields(PoolState)})


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def packet_batch(src, device=DEFAULT_DEVICE) -> PacketBatch:
    """A PacketBatch from an object or dict with the PacketBatch fields."""
    return PacketBatch(**{n: tensor(_get(src, n), device) for n in FIELDS})


def park_state(src, device=DEFAULT_DEVICE) -> ParkState:
    """A ParkState from an object or dict with the ParkState fields."""
    return ParkState(**{f.name: tensor(_get(src, f.name), device)
                        for f in dataclasses.fields(ParkState)})


def _shared(a, device) -> torch.Tensor:
    """A configuration array the port keeps once for every pipe: the first
    pipe's row of a per-pipe (P, ...) reference state."""
    a = np.asarray(a)
    return tensor(a.reshape(-1, a.shape[-1])[0] if a.ndim > 1 else a, device)


def chain_states(nfs: tuple, src_states, device=DEFAULT_DEVICE) -> tuple:
    """Chain states for ``nfs`` (the port's NF objects) from the
    reference's per-NF states, in chain order."""
    out = []
    for nf, st in zip(nfs, src_states):
        if isinstance(nf, Firewall):
            out.append(_shared(st, device))
        elif isinstance(nf, Nat):
            out.append({k: tensor(v, device) for k, v in st.items()})
        elif isinstance(nf, MaglevLB):
            out.append({k: _shared(v, device) for k, v in st.items()})
        elif isinstance(nf, MacSwap):
            out.append(())
        else:
            raise TypeError(f"no conversion for NF {type(nf).__name__}")
    return tuple(out)


def _nf(src):
    """The port's NF of the same class name as ``src``, with its fields."""
    name = type(src).__name__
    if name not in _NFS:
        raise TypeError(f"no port of NF {name} (have {sorted(_NFS)})")
    cls = _NFS[name]
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        kw[f.name] = tuple(int(x) for x in v) if isinstance(v, tuple) else v
    return cls(**kw)


def chain(src_chain) -> Chain:
    """The port's Chain from a reference chain (anything with ``nfs``)."""
    return Chain(tuple(_nf(x) for x in src_chain.nfs))


def scenario_spec(src) -> ScenarioSpec:
    """The port's ScenarioSpec with the fields of ``src``, on the port's
    ``auto`` backend (the reference's backend names are others)."""
    kw = {f.name: getattr(src, f.name)
          for f in dataclasses.fields(ScenarioSpec)}
    kw["fault"] = FaultSpec(**{f.name: getattr(src.fault, f.name)
                               for f in dataclasses.fields(FaultSpec)})
    kw["backend"] = "auto"
    return ScenarioSpec(**kw)


def prepared(src) -> Prepared:
    """A prepared scenario point (traffic, chain, traces, steering stats,
    fault masks) from the reference runner's, on the CPU, so the port's
    runner executes exactly the reference's inputs."""
    fa = src.faults
    return Prepared(
        spec=scenario_spec(src.spec),
        pkts=packet_batch(src.pkts, "cpu"), chain=chain(src.chain),
        traces=packet_batch(src.traces, "cpu"),
        steer_stats=dict(src.steer_stats), n_pipes=int(src.n_pipes),
        faults=FaultArrays(server_up=np.array(fa.server_up, bool),
                           lb_up=np.array(fa.lb_up, bool),
                           drain=np.array(fa.drain, bool)))


def numpy_packets(rng: np.random.Generator, batch: int, pmax: int,
                  sizes=(64, 128, 190, 300, 512, 1024, 1492),
                  n_ips: int = 1 << 30, n_ports: int = 1 << 15,
                  alive_frac: float = 1.0) -> dict[str, np.ndarray]:
    """Fresh UDP packets as numpy arrays keyed by PacketBatch field name,
    drawn from ``rng``: the common input both packages are fed.  Source
    addresses and ports come from ``n_ips``/``n_ports`` values so flows
    repeat when those are small."""
    size = rng.choice(np.asarray(sizes), batch)
    plen = np.clip(size - 42, 0, pmax).astype(np.int32)
    payload = rng.integers(0, 256, (batch, pmax)).astype(np.uint8)
    payload[np.arange(pmax)[None, :] >= plen[:, None]] = 0
    z = np.zeros(batch, np.int32)

    def ints(lo, hi):
        return rng.integers(lo, hi, batch).astype(np.int32)

    return dict(
        dst_mac=ints(0, (1 << 31) - 1), src_mac=ints(0, (1 << 31) - 1),
        src_ip=ints(1, 1 + n_ips), dst_ip=ints(0, (1 << 31) - 1),
        proto=np.full(batch, 17, np.int32),
        src_port=ints(1024, 1024 + n_ports), dst_port=ints(1024, 65536),
        payload_len=plen, payload=payload,
        alive=rng.random(batch) < alive_frac,
        pp_valid=np.zeros(batch, bool), pp_enb=z, pp_op=z.copy(),
        pp_ti=z.copy(), pp_clk=z.copy(), pp_crc=z.copy())


def as_numpy(obj) -> dict[str, np.ndarray]:
    """Field name -> numpy array for a PacketBatch or ParkState (either
    package's), for comparisons."""
    return {f.name: np.asarray(
        getattr(obj, f.name).cpu() if torch.is_tensor(getattr(obj, f.name))
        else getattr(obj, f.name))
        for f in dataclasses.fields(obj)}
