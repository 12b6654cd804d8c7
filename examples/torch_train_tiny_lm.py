"""End-to-end training demo on the PyTorch port: trains a reduced-config
model with checkpointing, "crashes" halfway, and resumes from the
checkpoint, then asserts that it learned (the port's twin of
``examples/train_tiny_lm.py``).

    PYTHONPATH=src python examples/torch_train_tiny_lm.py            # card
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --device cpu \\
        --steps 40
"""
import argparse
import shutil
import tempfile

from repro_torch.launch.train import RunConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        half = args.steps // 2
        run = dict(arch=args.arch, seq_len=128, global_batch=8, lr=3e-3,
                   ckpt_dir=ckpt, ckpt_every=max(half // 2, 1),
                   log_every=20, device=args.device)
        print(f"=== phase 1: train to step {half}, then 'crash' ===")
        out1 = train(RunConfig(steps=args.steps, stop_after=half, **run))
        print("=== phase 2: restart; auto-resumes from the checkpoint ===")
        out2 = train(RunConfig(steps=args.steps, **run))
        print(f"loss: start={out1['losses'][0]:.3f} "
              f"mid={out1['losses'][-1]:.3f} final={out2['losses'][-1]:.3f}")
        assert out2["losses"][-1] < out1["losses"][0], "no learning?"
        print("training + restart: OK")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
