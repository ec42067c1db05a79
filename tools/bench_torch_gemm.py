#!/usr/bin/env python3
"""Per-shape times of the port's GEMM (K1, K2) and direct conv (K4) on
the card, and a sweep of the GEMM's launch plans.

    python3 tools/bench_torch_gemm.py [--src DIR] [--sweep] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (the
default is this checkout's), so that two trees can be compared in one
call on one card: unpack the other tree with ``git archive`` into a
git-ignored directory and run the script on each, in turns.  The shapes
are ``chip_smoke.py``'s: K2 AlexNet's five im2col GEMMs at batch 1, K1
four GoogLeNet 1x1 GEMMs, K4 AlexNet's conv1 and conv2 (HWC in and out,
batch 1).  Times are ``chip_smoke.cuda_ms`` (device ms per call, CUDA
events over 20 queued calls, median of 5, warm L2); the library is
``torch.matmul`` or ``F.conv2d`` with TF32 off; the bound is
max(flops / 67e12, bytes / 3.35e12).  ``--sweep`` also times every tile
and split count the GEMM's C entry takes, at K2's and K1's shapes (trees
with the launch planner only).  One JSON object per line on stdout; needs
one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def shapes():
    from repro_torch.convnets import alexnet, googlenet
    alex = {n.id: n.scn for n in alexnet(1.0).conv_nodes()}
    pw = {}
    for node in googlenet(1.0).conv_nodes():
        s = node.scn
        if s.k == 1:
            pw.setdefault((s.m, s.c, s.out_h * s.out_w), node.id)
    k1 = [(nid, m, c, n) for (m, c, n), nid in
          sorted(pw.items(), key=lambda t: t[1])[:4]]
    k2 = [(nid, s.m, s.c * s.k * s.k, s.out_h * s.out_w)
          for nid, s in alex.items()]
    return alex, k1, k2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_torch_gemm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from chip_smoke import HBM_BW, PEAK_F32, cuda_ms, gpu_line
    from repro_torch.kernels.common import true_f32
    from repro_torch.kernels.conv_direct import conv_direct_cuda
    from repro_torch.kernels.matmul import kernel as mmk
    from repro_torch.kernels.matmul import matmul_cuda
    planned = hasattr(mmk, "matmul_plan")
    if planned:
        from repro_torch.kernels.matmul.plan import TILES

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    card = gpu_line()

    def rand(*shape, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def emit(**row):
        print(json.dumps(dict(tag=args.tag, card=card, **row)), flush=True)

    def bound(flops, nbytes):
        return max(flops / PEAK_F32, nbytes / HBM_BW) * 1e3

    alex, k1, k2 = shapes()
    with true_f32():
        for kern, rows in (("K2", k2), ("K1", k1)):
            for nid, m, k, n in rows:
                w, p = rand(m, k, scale=0.05), rand(1, k, n)
                row = dict(kernel=kern, shape=f"{nid} {m}x{k} @ {k}x{n}",
                           ms=cuda_ms(torch, lambda: matmul_cuda(w, p)),
                           library_ms=cuda_ms(torch,
                                              lambda: torch.matmul(w, p)),
                           bound_ms=bound(2.0 * m * n * k,
                                          4.0 * (m * k + k * n + m * n)))
                if planned:
                    plan = mmk.matmul_plan(w, p)
                    row.update(tile=f"{plan.bm}x{plan.bn}",
                               splits=plan.splits, blocks=plan.blocks)
                emit(**row)
                if not (args.sweep and planned):
                    continue
                for nb in (1, 8):
                    pb = p if nb == 1 else rand(nb, k, n)
                    c = torch.empty((nb, m, n), device=dev)
                    w3 = w.unsqueeze(0).expand(nb, m, k)
                    pick = mmk.matmul_plan(w, pb)
                    for tile in (0, 1):
                        bk = TILES[tile][2]
                        for s in range(1, 9):
                            kslice = -(-k // s // bk) * bk
                            if -(-k // kslice) != s:
                                continue  # an empty split
                            pl = mmk.GemmPlan(tile, s, kslice, 1, 1,
                                              (0, 0, 0))
                            bm, bn = pl.bm, pl.bn
                            emit(kernel=kern, shape=f"{nid} sweep",
                                 batch=nb, tile=f"{bm}x{bn}", splits=s,
                                 blocks=-(-m // bm) * -(-n // bn) * s * nb,
                                 picked=(tile, s) == (pick.tile,
                                                      pick.splits),
                                 ms=cuda_ms(torch, lambda: mmk.launch(
                                     pl, w3, pb, None, c, False)))
        for nid in ("conv1", "conv2"):
            s = alex[nid]
            w, b = rand(s.k, s.k, s.c, s.m, scale=0.05), rand(s.m)
            x = rand(1, s.c, s.h, s.w)
            x_hwc = x.permute(0, 2, 3, 1).contiguous()
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            kw = dict(stride=s.stride, pad=s.pad)
            ohow = s.out_h * s.out_w
            row = dict(kernel="K4", shape=f"{nid} HWC->HWC",
                       ms=cuda_ms(torch,
                                  lambda: conv_direct_cuda(x_hwc, w, b, **kw)),
                       library_ms=cuda_ms(torch, lambda: F.conv2d(
                           x, w_oihw, b, s.stride, s.pad)),
                       bound_ms=bound(
                           2.0 * ohow * s.m * s.k * s.k * s.c + ohow * s.m,
                           4.0 * (s.c * s.h * s.w + s.k * s.k * s.c * s.m
                                  + s.m + ohow * s.m)))
            if planned:
                from repro_torch.kernels.conv_direct import conv_plan
                from repro_torch.kernels.matmul.plan import vector_width
                plan = conv_plan(1, s.c, s.m, s.k, s.out_h, s.out_w, False,
                                 vector_width(w.view(-1, s.m), 1))
                row.update(tile=f"{plan.bm}x{plan.bn}", splits=plan.splits,
                           blocks=plan.blocks)
            emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
