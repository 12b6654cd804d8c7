"""Deterministic synthetic token stream with per-host slices (port of
``repro.training.data``).

``batch_at(step)`` is a pure function of (seed, step, host), so a restart
resumes mid-epoch with no duplicated or skipped batch (the checkpoint
stores only the step) and each host draws exactly its own slice of the
global batch.  Text is Zipf-distributed unigrams with a deterministic
bigram rule on odd positions, so losses fall during training (uniform
tokens would pin the cross entropy at log V).

The reference draws with ``jax.random``; this stream draws the same
distribution from a CPU ``torch.Generator`` seeded by ``(seed, step,
host_index)`` and moves the batch to the device afterwards, so a run on
the card and a run on the CPU see identical batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_probs(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    p = ranks ** -cfg.zipf_a
    return (p / p.sum()).astype(np.float32)


def _generator(seed: int, step: int, host_index: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step, host_index]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


@dataclasses.dataclass
class SyntheticStream:
    cfg: DataConfig
    device: str | torch.device = DEFAULT_DEVICE

    def __post_init__(self):
        self._probs = torch.from_numpy(_zipf_probs(self.cfg))
        self._device = resolve_device(self.device)

    def batch_at(self, step: int, host_index: int = 0, host_count: int = 1):
        """Global batch for ``step``, sliced for this host: int32 ``tokens``
        and ``labels`` (the tokens shifted by one), (B / hosts, seq_len)."""
        cfg = self.cfg
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        per_host = cfg.global_batch // host_count
        gen = _generator(cfg.seed, step, host_index)
        shape = (per_host, cfg.seq_len + 1)
        base = torch.multinomial(self._probs, per_host * (cfg.seq_len + 1),
                                 replacement=True,
                                 generator=gen).reshape(shape)
        # learnable bigram structure: every odd position repeats a
        # deterministic function of its predecessor with probability 1/2
        follow = (base * 31 + 7) % cfg.vocab_size
        gate = torch.bernoulli(torch.full(shape, 0.5), generator=gen).bool()
        seq = torch.where(gate & (torch.arange(cfg.seq_len + 1) % 2 == 1),
                          torch.roll(follow, 1, dims=1), base)
        seq = seq.to(torch.int32).to(self._device)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
