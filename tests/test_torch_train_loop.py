"""The port's synthetic token stream (``repro_torch.training.data``) and
training driver (``repro_torch.launch.train``), on the CPU: the stream's
properties (the reference draws with ``jax.random``, so no bit match is
possible, ROADMAP C0a), the reference tests' training-loop properties
(``tests/test_training.py::TestTrainLoop``, ``TestCompression``) on
reduced Qwen2.5-3B, the command line, and the example twin
``examples/torch_train_tiny_lm.py``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.train import RunConfig, main, train  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticStream  # noqa: E402,E501
from repro_torch.training.tree import items  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _stream(**kw):
    return SyntheticStream(DataConfig(**kw), device="cpu")


def test_stream_deterministic_and_host_sharded():
    s = _stream(vocab_size=100, seq_len=16, global_batch=8)
    a, b, c = s.batch_at(3), s.batch_at(3), s.batch_at(4)
    assert a["tokens"].dtype == a["labels"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    h0 = s.batch_at(3, host_index=0, host_count=2)
    h1 = s.batch_at(3, host_index=1, host_count=2)
    assert h0["tokens"].shape == h1["tokens"].shape == (4, 16)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError):
        s.batch_at(3, host_count=3)


def test_stream_labels_are_shifted_tokens():
    b = _stream(vocab_size=100, seq_len=16, global_batch=2).batch_at(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_stream_bigram_rule_on_odd_positions():
    """Odd positions repeat ``(31 * prev + 7) % V`` of their predecessor
    where the gate (probability 1/2) is on: at least ~half of them do,
    even positions only by chance (Zipf unigrams)."""
    v = 1000
    b = _stream(vocab_size=v, seq_len=64, global_batch=32).batch_at(5)
    seq = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).long()
    follows = seq[:, 1:] == (seq[:, :-1] * 31 + 7) % v
    pos = torch.arange(1, seq.shape[1])
    odd = follows[:, pos % 2 == 1].float().mean().item()
    even = follows[:, pos % 2 == 0].float().mean().item()
    assert odd >= 0.45, odd
    assert even < 0.05, even
    # the unigrams are Zipf: token 0 is the most frequent
    counts = torch.bincount(seq[:, ::2].flatten(), minlength=v)
    assert int(counts.argmax()) == 0


def test_loss_decreases():
    out = train(RunConfig(arch="qwen2.5-3b", steps=30, seq_len=64,
                          global_batch=4, lr=3e-3, log_every=0,
                          device="cpu"))
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.2, (first, last)


def test_checkpoint_restart_bitexact(tmp_path):
    """Kill-and-resume lands on the same state as an uninterrupted run."""
    run = dict(arch="qwen2.5-3b", steps=20, seq_len=32, global_batch=2,
               ckpt_every=10, log_every=0, device="cpu")
    full = train(RunConfig(ckpt_dir=str(tmp_path / "a"), **run))
    train(RunConfig(ckpt_dir=str(tmp_path / "b"), stop_after=10, **run))
    resumed = train(RunConfig(ckpt_dir=str(tmp_path / "b"), **run))
    assert len(resumed["losses"]) == 10
    assert resumed["losses"] == full["losses"][10:]
    assert resumed["grad_norms"] == full["grad_norms"][10:]
    got, want = dict(items(resumed["state"])), dict(items(full["state"]))
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert torch.equal(got[k], a), k


def test_training_with_compression_converges():
    out = train(RunConfig(arch="qwen2.5-3b", steps=25, seq_len=64,
                          global_batch=4, lr=3e-3, compress_grads=True,
                          log_every=0, device="cpu"))
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 0.15


def test_main_runs_on_the_cpu(capsys, tmp_path):
    main(["--device", "cpu", "--arch", "qwen2.5-3b", "--steps", "4",
          "--seq-len", "16", "--global-batch", "2",
          "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "device: cpu" in out
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]


def test_train_tiny_lm_example_runs():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable,
                        str(REPO / "examples" / "torch_train_tiny_lm.py"),
                        "--device", "cpu", "--steps", "8"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "training + restart: OK" in r.stdout
    assert "resumed from step 4" in r.stdout
