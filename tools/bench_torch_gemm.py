#!/usr/bin/env python3
"""Per-shape times of the port's GEMM (K1, K2), Winograd batched GEMM
(K3), direct conv (K4), layout transforms (K5) and flash attention (K6)
on the card, and sweeps of the GEMM's and K6's launch plans and of K5's
routes.

    python3 tools/bench_torch_gemm.py [--src DIR] [--sweep] [--tag NAME]
                                      [--only K1 K2 ...]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (the
default is this checkout's), so that two trees can be compared in one
call on one card: unpack the other tree with ``git archive`` into a
git-ignored directory and run the script on each, in turns.  The shapes
are ``chip_smoke.py``'s: K2 AlexNet's five im2col GEMMs at batch 1, K1
four GoogLeNet 1x1 GEMMs, K3 AlexNet's conv3-conv5 at F(2,3) and F(4,3),
batch 1 and 8 (each tree in its own operand layout: the images folded
into N where the tree's binding takes the reference's 3-D form, one
image per grid slice before), K4 AlexNet's conv1 and conv2 (HWC in and
out, batch 1), K5's four entries at the calibration sweep's shapes and
at VGG-16's largest buckets and GoogLeNet's (1024, 16, 16), K6 at the
sweep's two shapes (1, 4, 1024, 64) and (1, 4, 256, 64) and at
D = 128 and 256 with L = 1024, f32, non-causal (and in bf16 and f16 at
the sweep's shapes, for trees whose K6 takes them).
Times are ``chip_smoke.cuda_ms`` (device ms per call, CUDA events over
20 queued calls, median of 5, warm L2); K5's are a lone call's, as its
callers (calibration, the tuner) synchronise after each (``ms``, median
of ``chip_smoke.LONE_REPS``, with ``queued_ms``, 20 queued calls,
beside), and at VGG-16's shapes cold (``chip_smoke.cold_ms``); the
library is
``torch.matmul``, ``F.conv2d`` (TF32 off), ``t().contiguous()`` or
``F.scaled_dot_product_attention`` (whose device kernels the profiler
names in ``library_kernels``); the bound is max(flops / 67e12,
bytes / 3.35e12).  ``--sweep`` also times
every tile and split count the GEMM's C entries take, at K2's, K1's and
K3's shapes, batch 1 and 8, and at K4's (trees with the launch planner
only), each of K5's routes at C = 1 .. 32 channels of 256 x 256
(trees with routes only), both tiles of K5's tile route at its shapes
(trees with the tile planner only), and every query tile and KV split of
K6 at its four shapes (trees with K6's planner only).  ``--only K6`` (or any of
K1 .. K6) times those kernels alone.  One JSON object per line on
stdout; needs one CUDA card.
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
    ap.add_argument("--only", nargs="+", default=None,
                    help="time these kernels only (K1 .. K6)")
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
        if args.only and row["kernel"][:2] not in args.only:
            return
        print(json.dumps(dict(tag=args.tag, card=card, **row)), flush=True)

    def wanted(*kernels):
        return not args.only or any(k in args.only for k in kernels)

    def bound(flops, nbytes):
        return max(flops / PEAK_F32, nbytes / HBM_BW) * 1e3

    alex, k1, k2 = shapes()
    with true_f32():
        for kern, rows in (("K2", k2), ("K1", k1)):
            for nid, m, k, n in rows if wanted(kern) else ():
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
                    for tile in range(len(TILES)):
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
        for nid in ("conv1", "conv2") if wanted("K4") else ():
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
            if not (args.sweep and planned):
                continue
            from repro_torch.kernels.conv_direct import kernel as cdk
            from repro_torch.kernels.matmul.plan import GemmPlan
            r = s.k * s.k * s.c
            for tile in getattr(cdk, "CONV_TILES", range(len(TILES))):
                bm, bn, bk = TILES[tile]
                for sp in range(1, 9):
                    kslice = -(-r // sp // bk) * bk
                    if -(-r // kslice) != sp:
                        continue  # an empty split
                    pl = GemmPlan(tile, sp, kslice, plan.vec_a, plan.vec_b,
                                  (0, 0, 0))
                    emit(kernel="K4", shape=f"{nid} sweep", batch=1,
                         tile=f"{bm}x{bn}", splits=sp,
                         blocks=-(-ohow // bm) * -(-s.m // bn) * sp,
                         picked=(tile, sp) == (plan.tile, plan.splits),
                         ms=cuda_ms(torch, lambda: conv_direct_cuda(
                             x_hwc, w, b, plan=pl, **kw)))
        if wanted("K3"):
            bench_k3(args, alex, rand, emit, bound)
        if wanted("K6"):
            bench_k6(args, rand, emit, bound)
    if wanted("K5"):
        bench_k5(args, rng, emit)
    return 0


def k3_shapes(alex):
    """(conv, m_, P, M, C, T) of AlexNet's conv3-conv5 at F(2,3), F(4,3)."""
    for nid in ("conv3", "conv4", "conv5"):
        s = alex[nid]
        for m_ in (2, 4):
            t = -(-s.out_h // m_) * -(-s.out_w // m_)
            yield nid, m_, (m_ + 2) ** 2, s.m, s.c, t


def bench_k3(args, alex, rand, emit, bound):
    """K3 at batch 1 and 8: the binding on the tree's own operand layout
    (U from its ``prepare_kernel``; V folded to (P, C, images * T) where
    the binding takes the reference's 3-D form, (images, P, C, T)
    before), against ``torch.matmul`` of the same U and the folded V."""
    import numpy as np
    import torch
    from chip_smoke import cuda_ms
    from repro_torch.kernels.winograd_gemm import kernel as wk
    from repro_torch.kernels.winograd_gemm import prepare_kernel
    folded = hasattr(wk, "bgemm_plan")
    if folded:
        from repro_torch.kernels.matmul.plan import GemmPlan, TILES
    for nid, m_, p, m, c, t in k3_shapes(alex):
        w = np.random.default_rng(p + m + c).normal(
            size=(m, c, 3, 3)).astype(np.float32) * np.float32(0.05)
        u = prepare_kernel(w, m_).to("cuda")
        uc = u.contiguous()
        for nb in (1, 8):
            v3 = rand(p, c, nb * t)
            v = v3 if folded else v3.reshape(p, c, nb, t).permute(
                2, 0, 1, 3).contiguous()
            n = nb * t
            row = dict(kernel="K3", shape=f"{nid} F({m_},3) P={p} "
                       f"{m}x{c} @ {c}x{n}", batch=nb,
                       ms=cuda_ms(torch, lambda: wk.winograd_bgemm_cuda(u, v)),
                       library_ms=cuda_ms(torch,
                                          lambda: torch.matmul(u, v3)),
                       bound_ms=bound(2.0 * p * m * c * n,
                                      4.0 * p * (m * c + c * n + m * n)))
            if folded:
                plan = wk.bgemm_plan(u, v)
                row.update(tile=f"{plan.bm}x{plan.bn}", splits=plan.splits,
                           blocks=plan.blocks, vec=f"{plan.vec_a}/"
                           f"{plan.vec_b}")
            emit(**row)
            if not (args.sweep and folded):
                continue
            pick = wk.bgemm_plan(u, v)
            # the copy-width levers, on the planner's tile and splits: U
            # with C contiguous (4-byte copies), V's N padded to a
            # multiple of 4 (16-byte copies)
            levers = [("U (P, M, C) contiguous", uc, v)]
            if n % 4:
                vp = torch.zeros(p, c, -(-n // 4) * 4, device="cuda")
                vp[:, :, :n] = v
                levers.append((f"V padded to N = {vp.shape[2]}", u, vp))
            for what, uu, vv in levers:
                pl = wk.bgemm_plan(uu, vv)
                pl = GemmPlan(pick.tile, pick.splits, pick.kslice, pl.vec_a,
                              pl.vec_b, (0, 0, 0))
                emit(kernel="K3", shape=f"{nid} F({m_},3) sweep", batch=nb,
                     lever=what, vec=f"{pl.vec_a}/{pl.vec_b}",
                     tile=f"{pick.bm}x{pick.bn}", splits=pick.splits,
                     ms=cuda_ms(torch, lambda: wk.winograd_bgemm_cuda(
                         uu, vv, pl)))
            for tile, (bm, bn, bk) in enumerate(TILES):
                for s in range(1, 9):
                    kslice = -(-c // s // bk) * bk
                    if -(-c // kslice) != s:
                        continue  # an empty split
                    pl = GemmPlan(tile, s, kslice, pick.vec_a, pick.vec_b,
                                  (0, 0, 0))
                    emit(kernel="K3", shape=f"{nid} F({m_},3) sweep",
                         batch=nb, tile=f"{bm}x{bn}", splits=s,
                         blocks=-(-m // bm) * -(-n // bn) * s * p,
                         picked=(tile, s) == (pick.tile, pick.splits),
                         ms=cuda_ms(torch, lambda: wk.winograd_bgemm_cuda(
                             u, v, pl)))


#: K6's timed shapes: (B, H, L, D), self-attention over L positions
K6_SHAPES = ((1, 4, 1024, 64), (1, 4, 256, 64), (1, 4, 1024, 128),
             (1, 4, 1024, 256))


def library_kernels(torch, fn):
    """The device kernels one call of ``fn`` runs, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def bench_k6(args, rand, emit, bound):
    """K6 against ``F.scaled_dot_product_attention`` on the same q, k, v
    (f32, non-causal, scale D^-1/2); with ``--sweep``, every (BQ, S) the
    C entry takes at each shape."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import cuda_ms
    from repro_torch.kernels.flash_attention import kernel as fk
    planned = hasattr(fk, "attention_plan")
    if planned:
        from repro_torch.kernels.flash_attention import plan as fp
    for b, h, l, d in K6_SHAPES:
        q, k, v = (rand(b, h, l, d) for _ in range(3))
        scale = d ** -0.5
        row = dict(kernel="K6", shape=str((b, h, l, d)),
                   ms=cuda_ms(torch, lambda: fk.flash_attention_cuda(
                       q, k, v, scale=scale)),
                   library_ms=cuda_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          q, k, v)),
                   bound_ms=bound(4.0 * b * h * l * l * d,
                                  4.0 * (2 * q.numel() + k.numel()
                                         + v.numel())),
                   library_kernels=library_kernels(
                       torch, lambda: F.scaled_dot_product_attention(
                           q, k, v)))
        if planned:
            plan = fk.attention_plan(q, k, v)
            row.update(dp=plan.dp, bq=plan.bq, splits=plan.splits,
                       blocks=plan.blocks)
        emit(**row)
        if planned and d == 64:  # the 2-byte types, at the sweep shapes
            for dt in (torch.bfloat16, torch.float16):
                qh, kh, vh = (t.to(dt) for t in (q, k, v))
                emit(kernel="K6", shape=str((b, h, l, d)), dtype=str(dt),
                     ms=cuda_ms(torch, lambda: fk.flash_attention_cuda(
                         qh, kh, vh, scale=scale)),
                     library_ms=cuda_ms(torch, lambda:
                                        F.scaled_dot_product_attention(
                                            qh, kh, vh)))
        if not (args.sweep and planned):
            continue
        dp = fp.padded_dim(d)
        for bq in fp.QUERY_TILES:
            for s in range(1, fp.MAX_SPLITS + 1):
                pl = fp.make_plan(b, h, l, d, dp, bq, s)
                emit(kernel="K6", shape=f"{(b, h, l, d)} sweep", dp=dp,
                     bq=bq, splits=s, blocks=pl.blocks,
                     picked=(bq, s) == (plan.bq, plan.splits),
                     ms=cuda_ms(torch, lambda: fk.flash_attention_cuda(
                         q, k, v, scale=scale, plan=pl)))


#: K5's timed shapes, (C, H, W): the calibration sweep's AlexNet buckets,
#: timed warm (L2 holds them), and VGG-16's largest buckets and
#: GoogLeNet's (1024, 16, 16), timed cold (``chip_smoke.cold_ms``)
K5_SHAPES = ((4, 256, 256), (128, 32, 32), (256, 16, 16), (512, 16, 16))
K5_COLD_SHAPES = ((64, 256, 256), (128, 128, 128), (256, 64, 64),
                  (512, 32, 32), (1024, 16, 16))


def bench_k5(args, rng, emit):
    """As ``chip_smoke.py`` times them: K5a (CHW -> HWC) and K5b
    (HWC -> CHW) at conv1's bucket, K5c (CHW -> HWC8) and K5d
    (HWC8 -> CHW) at the others, against ``permute().contiguous()``, f32,
    a lone call at a time (and 20 queued, ``queued_ms``), beside a lone
    one-element fill, the floor of a lone call; the cold shapes
    with their operands rotated over more than the L2.  With ``--sweep``,
    each route at C = 1 .. 32 channels of 256 x 256, and (trees with the
    tile planner) both tiles of the tile route at every shape, on one
    block per tile and on 1, 2 and 4 blocks per SM, lone calls."""
    import torch
    from chip_smoke import HBM_BW, LONE_REPS, cold_copies, cold_ms, cuda_ms
    lone = dict(reps=LONE_REPS, inner=1)
    from repro_torch.kernels.layout_transform import kernel as lk
    routed = hasattr(lk, "route")
    planned = hasattr(lk, "plan")

    def data(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype("float32")).to(
            "cuda")

    # what a lone call costs before any work: a one-element fill
    one = torch.zeros(1, device="cuda")
    emit(kernel="K5", shape="lone call floor: zero_() of one element",
         ms=cuda_ms(torch, one.zero_, **lone),
         queued_ms=cuda_ms(torch, one.zero_))

    for (c, h, w), cold in ([(s, False) for s in K5_SHAPES]
                            + [(s, True) for s in K5_COLD_SHAPES]):
        x = data(c, h, w)
        hwc = x.permute(1, 2, 0).contiguous()
        if c % 8:
            cases = [("K5a", x, lk.chw_to_hwc_cuda, (c, h * w)),
                     ("K5b", hwc, lk.hwc_to_chw_cuda, (h * w, c))]
        else:
            cases = [("K5c", x, lk.chw_to_hwc8_cuda, (c, h * w)),
                     ("K5d", hwc.reshape(h, w, c // 8, 8),
                      lk.hwc8_to_chw_cuda, (h * w, c))]
        for kern, xin, fn, (r, s_) in cases:
            ins = cold_copies(xin) if cold else [xin]

            def timed(f, ins=ins, **kw):
                return cold_ms(torch, f, ins, **kw) if cold else \
                    cuda_ms(torch, lambda: f(ins[0]), **kw)
            # the library transposes the same (R, S) bytes
            row = dict(kernel=kern, shape=str(tuple(xin.shape)), cold=cold,
                       ms=timed(fn, **lone), queued_ms=timed(fn),
                       library_ms=timed(
                           lambda a: a.reshape(r, s_).t().contiguous(),
                           **lone),
                       bound_ms=2.0 * 4 * x.numel() / HBM_BW * 1e3)
            if routed:
                row.update(route=lk.route(r, s_, 4))
            if planned:
                p = lk.plan(r, s_, 4)
                row.update(tile=p.tile, grid=p.grid, units=p.units)
            emit(**row)
            if not (args.sweep and planned and row["route"] == lk.TILE):
                continue
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            for tile in (0, 1):
                pw = lk.plan(r, s_, 4, tile_=tile)
                grids = {pw.grid, pw.units} | {
                    min(k * sms, pw.units) for k in (1, 2, 4)}
                for g in sorted(grids):
                    pl = lk.LayoutPlan(pw.route, tile, g, pw.units)
                    emit(kernel=kern, shape=f"{tuple(xin.shape)} sweep",
                         cold=cold, tile=tile,
                         tile_elems=lk.tile_elems(tile, 4), grid=pl.grid,
                         units=pl.units, picked=pl == p,
                         ms=timed(lambda a, pl=pl: lk.transpose_cuda(
                             a, r, s_, plan_=pl), **lone))
            del ins
    if not (args.sweep and routed):
        return
    for c in (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32):
        x = data(c, 256, 256)
        hwc = x.permute(1, 2, 0).contiguous()
        for kern, xin, r, s_, short in (("K5a", x, c, 65536, lk.SHORT_ROWS),
                                        ("K5b", hwc, 65536, c,
                                         lk.SHORT_COLS)):
            for rt in (lk.TILE, short):
                if rt != lk.TILE and c > lk.SHORT_MAX:
                    continue
                emit(kernel=kern, shape=f"({c}, 256, 256) sweep", route=rt,
                     picked=rt == lk.route(r, s_, 4),
                     ms=cuda_ms(torch, lambda: lk.transpose_cuda(
                         xin, r, s_, rt), **lone))


if __name__ == "__main__":
    sys.exit(main())
