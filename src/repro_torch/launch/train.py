"""End-to-end training CLI (port of the reference's ``launch/train.py``,
with the same flags and summary line, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 200 --d-model 512 --layers 8 --seq 256 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 20 --d-model 64 --layers 2 --seq 32 --batch 4

Runs a reduced config of the selected architecture through the
fault-tolerant loop with checkpointing; ``--full-config`` trains the
published config (TinyLlama-1.1B unscaled fits one H100 in f32 with
AdamW).  ``--device`` (default ``cuda``): the model, the optimizer
state and the batches live on the card unless told otherwise, and the
CLI raises without one.  Attention takes the plain path
(``attn_impl="xla"``), as the reference's CLI leaves it: the flash
kernel has no backward.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=0,
                    help="0 = family-preserving default")
    ap.add_argument("--full-config", action="store_true",
                    help="use the published config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"),
        help="resumed from when it holds a checkpoint (default: "
             "repro_torch_train under the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card; "
                         "'cpu' runs on the CPU)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from ..configs import get_config
    from ..configs.base import ShapeConfig
    from ..models import param_count
    from ..optim import adamw, warmup_cosine
    from ..runtime import TrainLoopConfig, train

    cfg = get_config(args.arch)
    if not args.full_config:
        kw = dict(d_model=args.d_model,
                  d_ff=args.d_model * (0 if cfg.family == "ssm" else 3),
                  vocab=min(cfg.vocab, 8192),
                  n_heads=min(cfg.n_heads, 8) or 0,
                  n_kv_heads=min(cfg.n_kv_heads, 4) or 0,
                  head_dim=64 if cfg.head_dim else 0)
        if args.layers:
            kw["n_layers"] = args.layers
        cfg = cfg.scaled_down(**kw)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    opt = adamw(warmup_cosine(args.lr, 20, args.steps))
    metrics = []
    st = train(cfg, shape, opt,
               loop=TrainLoopConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir),
               seed=args.seed, dtype=torch.float32, metrics_out=metrics,
               device=args.device)
    if not metrics:
        print(f"finished at step {st.step}; params="
              f"{param_count(cfg)/1e6:.1f}M; no step run: {args.ckpt_dir} "
              f"held a checkpoint at step {st.step} >= --steps {args.steps}")
        return 0
    print(f"finished at step {st.step}; params={param_count(cfg)/1e6:.1f}M; "
          f"final loss {metrics[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
