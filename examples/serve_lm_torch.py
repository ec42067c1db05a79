"""Serve a small model with batched requests (continuous batching) on the
PyTorch port, with half the requests carrying images that flow through
the plan-cache serving subsystem (PlanServer behind the continuous
scheduler: bucketed scenarios -> cached PBQP plan -> cached executable
-> vision tokens).  The port's counterpart of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/serve_lm_torch.py                # the card
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.core.costs import AnalyticCostModel
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import Request, ServeLoop
from repro_torch.serving import BucketPolicy, PlanServer, conv_tower


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = get_config("tinyllama-1.1b").scaled_down(
        n_layers=4, d_model=256, d_ff=512, vocab=2048)
    params = init_params(cfg, 0, torch.float32, device)

    # One PlanServer amortizes PBQP solves + executable builds across all
    # image-carrying requests: arbitrary image sizes collapse into
    # power-of-two buckets, each solved and compiled at most once.
    plan_server = PlanServer(
        lambda s: conv_tower(s, depth=2, width=8),
        AnalyticCostModel(),
        policy=BucketPolicy(min_hw=8, max_hw=128), lru_capacity=4,
        device=device)
    loop = ServeLoop(cfg, params, max_batch=4, max_seq=96,
                     plan_server=plan_server, image_tokens=4,
                     device=device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(10):
        pixels = None
        if i % 2 == 0:  # every other request is multimodal
            hw = int(rng.integers(12, 48))
            pixels = rng.normal(size=(3, hw, hw)).astype(np.float32)
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab,
                                size=int(rng.integers(4, 32)))
            .astype(np.int32),
            max_new_tokens=16, pixels=pixels))
    t0 = time.perf_counter()
    loop.run(reqs)
    dt = time.perf_counter() - t0
    tok = sum(len(r.tokens) for r in reqs)
    print(f"served {len(reqs)} requests ({tok} tokens) in {dt:.2f}s "
          f"with 4-slot continuous batching on {device}")
    for r in reqs[:4]:
        print(f"  req {r.rid}: {len(r.prompt)}-token prompt -> "
              f"{len(r.tokens)} new tokens, {r.latency_s*1e3:.0f} ms")
    s = plan_server.stats()
    print(f"plan cache: {s['requests']} images -> {s['buckets']} buckets, "
          f"{s['solves']} PBQP solves ({s['warm_solves']} warm-started), "
          f"{s['compiles']} compiles, exec hit rate "
          f"{s['exec_hit_rate']:.0%}")
    loop.close()
    plan_server.close()


if __name__ == "__main__":
    main()
