"""Per-layer (x per-chunk) accounting probes for the dry run (port of
``repro.launch.accounting``; the same arithmetic over the port's configs).

The reference needs these because XLA's cost analysis counts a
while-loop body once, so a scan over layers under-reports FLOPs, bytes
and collective bytes by about the layer count.  The port's layer loop is
Python and every layer is dispatched, so its full-depth trace counts
every layer already; the dry run keeps the probes all the same, runs
them under the same mesh and rules as the full trace, and records both:
each holds the other (``tests/test_torch_dryrun.py`` requires them equal
on each branch below).

Attention-family archs: probes at 1 and 2 layers per scalable segment
group, at the full sequence (attention costs are quadratic in S):

    metric(full) = metric(base) + sum_g (metric(bump_g) - metric(base))
                                   * (count_g - 1)

SSM family (mamba2), train and prefill: every cost is linear in the
sequence length, and the probes run at S = Q and S = 2Q tokens with a
bilinear model over (layers L, chunks C):

    m(L, C) = m11 + (m21-m11)(L-1) + (m12-m11)(C-1)
                  + (m22-m21-m12+m11)(L-1)(C-1)

Both are exact for homogeneous segments: every layer (and every chunk)
runs the same operations.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig


@dataclasses.dataclass(frozen=True)
class Probe:
    name: str
    cfg: ModelConfig
    shape: ShapeConfig   # possibly seq-reduced (ssm probes)


def _combine_linear(extra: dict[str, int]) -> Callable:
    def combine(costs: dict[str, dict]) -> dict:
        base = costs["base"]
        out = dict(base)
        for key, v in base.items():
            if not isinstance(v, (int, float)) or v is None:
                continue
            total = float(v)
            for g, n in extra.items():
                bv = costs[g].get(key)
                if bv is not None:
                    total += (float(bv) - float(v)) * n
            out[key] = total
        return out
    return combine


def _combine_bilinear(l_full: int, c_full: int) -> Callable:
    def combine(costs: dict[str, dict]) -> dict:
        m11, m21 = costs["l1c1"], costs["l2c1"]
        m12, m22 = costs["l1c2"], costs["l2c2"]
        out = dict(m11)
        for key, v in m11.items():
            if not isinstance(v, (int, float)) or v is None:
                continue
            a = float(v)
            b = float(m21[key]) - a
            c = float(m12[key]) - a
            d = float(m22[key]) - float(m21[key]) - float(m12[key]) + a
            out[key] = (a + b * (l_full - 1) + c * (c_full - 1)
                        + d * (l_full - 1) * (c_full - 1))
        return out
    return combine


def probe_plan(cfg: ModelConfig, shape: ShapeConfig
               ) -> tuple[list[Probe], Callable]:
    """The cell's probes and the function that combines their costs into
    the full configuration's."""
    rep = dataclasses.replace
    if cfg.family == "ssm" and shape.kind in ("train", "prefill"):
        q = cfg.ssm.chunk
        s1 = rep(shape, seq_len=q)
        s2 = rep(shape, seq_len=2 * q)
        l1 = rep(cfg, num_layers=1)
        l2 = rep(cfg, num_layers=2)
        probes = [
            Probe("l1c1", l1, s1), Probe("l2c1", l2, s1),
            Probe("l1c2", l1, s2), Probe("l2c2", l2, s2),
        ]
        return probes, _combine_bilinear(cfg.num_layers, shape.seq_len // q)

    if cfg.family == "audio":
        base = rep(cfg, num_layers=1, enc_layers=1)
        probes = [
            Probe("base", base, shape),
            Probe("enc", rep(cfg, num_layers=1, enc_layers=2), shape),
            Probe("dec", rep(cfg, num_layers=2, enc_layers=1), shape),
        ]
        return probes, _combine_linear(
            {"enc": cfg.enc_layers - 1, "dec": cfg.num_layers - 1})
    if cfg.family == "hybrid":
        pat = len(cfg.hybrid.pattern)
        full, remlayers = divmod(cfg.num_layers, pat)
        base_layers = pat + remlayers          # 1 superblock + tail
        probes = [
            Probe("base", rep(cfg, num_layers=base_layers), shape),
            Probe("sb", rep(cfg, num_layers=base_layers + pat), shape),
        ]
        return probes, _combine_linear({"sb": full - 1})
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        fd = cfg.moe.first_dense_layers
        probes = [
            Probe("base", rep(cfg, num_layers=fd + 1), shape),
            Probe("blocks", rep(cfg, num_layers=fd + 2), shape),
        ]
        return probes, _combine_linear({"blocks": cfg.num_layers - fd - 1})
    probes = [
        Probe("base", rep(cfg, num_layers=1), shape),
        Probe("blocks", rep(cfg, num_layers=2), shape),
    ]
    return probes, _combine_linear({"blocks": cfg.num_layers - 1})


def accounting_blocks(seq_len: int) -> tuple[int, int]:
    """Large attention blocks: the same FLOPs (the port's blockwise
    attention masks rather than skips blocks), far fewer iterations of
    its Python block loop."""
    blk = min(seq_len, 4096)
    return blk, blk
