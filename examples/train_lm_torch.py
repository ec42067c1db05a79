"""End-to-end example on the PyTorch port: train a ~100M-parameter LM for
a few hundred steps through the fault-tolerant loop (checkpoint/restart,
stragglers logged).  The port's counterpart of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The config is a family-faithful reduction of TinyLlama (GQA, swiglu,
rope) at ~100M params; data is the deterministic synthetic pipeline, so
the loss curve is reproducible run-to-run and across restarts.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import param_count
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.runtime import TrainLoopConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("tinyllama-1.1b").scaled_down(
        n_layers=8, d_model=768, d_ff=2048, vocab=8192,
        n_heads=12, n_kv_heads=4, head_dim=64)
    print(f"model: {cfg.name}, {param_count(cfg)/1e6:.1f}M params")

    shape = ShapeConfig("train", seq_len=args.seq,
                        global_batch=args.batch, kind="train")
    opt = adamw(warmup_cosine(3e-4, 50, args.steps))
    metrics = []
    train(cfg, shape, opt,
          loop=TrainLoopConfig(total_steps=args.steps, ckpt_every=100,
                               ckpt_dir=args.ckpt_dir, log_every=20),
          dtype=torch.float32, metrics_out=metrics, device=args.device)
    if not metrics:
        print(f"no step run: {args.ckpt_dir} held a checkpoint at or past "
              f"step {args.steps}")
        return
    n = min(10, len(metrics))
    first = sum(m["loss"] for m in metrics[:n]) / n
    last = sum(m["loss"] for m in metrics[-n:]) / n
    print(f"loss: {first:.3f} -> {last:.3f} over {args.steps} steps")


if __name__ == "__main__":
    main()
