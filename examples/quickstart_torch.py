"""Quickstart on the PyTorch port: the paper's pipeline end to end on
AlexNet, on the card.

  python examples/quickstart_torch.py [--profile] [--scale 1.0]
      [--device cuda|cpu]

1. build the AlexNet layer graph,
2. cost every applicable primitive per conv scenario — analytic under
   the H100 spec with the kernel primitives priced, or profiled on the
   device with ``--profile``,
3. solve the PBQP for the globally-optimal primitive+layout assignment,
4. legalize (insert layout-conversion chains on illegal edges),
5. compile and execute both the SUM2D baseline and the PBQP plan,
   verify they agree numerically, and report both times.

Runs on the card; with no GPU it stops unless ``--device cpu`` is given.
"""
import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.convnets import alexnet
from repro_torch.core.costs import (H100_SPEC, AnalyticCostModel,
                                    ProfiledCostModel)
from repro_torch.core.plan import compile_plan, measure
from repro_torch.core.selection import select_pbqp, select_sum2d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile real execution times on the device")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    net = alexnet(scale=args.scale)
    cost = ProfiledCostModel(device=args.device) if args.profile else \
        AnalyticCostModel(H100_SPEC, include_kernels=True)
    print(f"== {net.name}: {len(net.conv_nodes())} conv layers ==")

    sel = select_pbqp(net, cost)
    print(f"PBQP optimum found (optimal={sel.optimal}), predicted "
          f"{sel.predicted_cost*1e3:.4f} ms; "
          f"{len(sel.conversions)} layout conversions inserted")
    for node in net.conv_nodes():
        ch = sel.choices[node.id]
        print(f"  {node.id:8s} {node.scn.key():34s} -> "
              f"{ch.primitive.name} [{ch.l_in}->{ch.l_out}]")

    params = net.init_params(seed=0)
    x = np.random.default_rng(0).normal(
        size=net.nodes["data"].out_shape).astype(np.float32)

    base = compile_plan(select_sum2d(net, cost), params, device=args.device)
    opt = compile_plan(sel, params, device=args.device)
    out_b, out_o = base(x), opt(x)
    for k in out_b:
        np.testing.assert_allclose(out_b[k].cpu().numpy(),
                                   out_o[k].cpu().numpy(), rtol=2e-3,
                                   atol=2e-3)
    print("numerics: PBQP plan == SUM2D baseline (allclose)")

    tb = measure(base, x, reps=3)
    to = measure(opt, x, reps=3)
    print(f"device: {opt.device}")
    print(f"SUM2D baseline: {tb['mean_s']*1e3:10.4f} ms")
    print(f"PBQP optimum:   {to['mean_s']*1e3:10.4f} ms "
          f"(PBQP/SUM2D {to['mean_s']/tb['mean_s']:.4f})")


if __name__ == "__main__":
    main()
