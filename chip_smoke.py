#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for Hopper, sm_90a) and
``nvcc``; exits non-zero, printing no result, without them or outside a
checkout of the repository.  Phases, each of which raises on failure:

1. environment: card, power limit, versions; build every CUDA kernel
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernels: each hand-written kernel's binding against its plain PyTorch
   version on the card at AlexNet's (and GoogLeNet's 1x1) shapes, at
   batch 1 and 8, with its time, the plain version's, one library
   call's and the card's lower bound; then every kernel primitive's
   whole convolution (padding, gathers, transforms, crops and each
   fused layout) at batch 8 against an f64 ``F.conv2d``;
3. main path: AlexNet at 227x227 through ``select_pbqp`` under the H100
   cost model with the kernels priced, ``compile_plan`` on the card at
   batch 1 and 8, against the SUM2D plan and the port's CPU path;
4. pinned: each kernel primitive pinned by ``select_fixed`` onto every
   conv that supports it (AlexNet; GoogLeNet for the 1x1 GEMM), against
   SUM2D at batch 2 and 1;
5. fused: ``select_pbqp(fuse=True)`` on GoogLeNet against SUM2D;
6. profiled selection: ``ProfiledCostModel`` on AlexNet, timed.

Plans are compared at every conv's output, the pre-softmax logits and
the probabilities, each within 1e-3 of the reference's largest
magnitude (the probabilities also at the quickstart's 2e-3).

Every plan run in phases 3-6 is a path: the launch counts are set to 0
just before its one forward and read just after, and must equal one
launch per conv that its selection gave to each kernel (the batch runs
on the kernels' grids).  The last lines are a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: NVIDIA H100 SXM data sheet: f32 on the CUDA cores, HBM3 bandwidth
PEAK_F32 = 67e12
HBM_BW = 3.35e12
#: f32 kernels against their plain versions: summation order differs
#: (K up to 3456 at conv4's im2col GEMM) and TF32 is off, so 1e-3 of the
#: largest plain magnitude; bf16 GEMM: one bf16 rounding of the output
TOL_F32 = 1e-3
TOL_BF16 = 2e-2
#: plans against SUM2D: every compared output within 1e-3 of the
#: reference's largest magnitude (errors grow over the layers but stay
#: f32 rounding); the probabilities also at the quickstart's 2e-3
NET_REL = 1e-3
NET_TOL = 2e-3
#: the wrapper behind each kernel primitive's launch counter
COUNTER_OF = {"pallas_direct_hwc": "conv_direct",
              "pallas_im2col_chw": "conv_im2col",
              "pallas_wino_f2x3_chw": "winograd_gemm",
              "pallas_wino_f4x3_chw": "winograd_gemm",
              "pallas_pw_gemm_chw": "matmul"}
#: ~2 ms at the H100's 1.98 GHz boost clock: longer than the host takes
#: to queue 20 single-kernel calls
SLEEP_CYCLES = 4_000_000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 5, inner: int = 20) -> float:
    """Median device time of one call (ms), from CUDA events around
    ``inner`` back-to-back calls.  A sleep kernel queued first keeps
    the card busy while the host queues the calls, so the events see
    device time, not launch overhead (where the host cannot queue the
    calls within the sleep, as for the many-launch plain versions, the
    time includes the host's)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(np.median(times))


def device_profile(torch, fn, calls: int = 3):
    """(wall ms, device-busy ms, top device activities) per call of
    ``fn`` over ``calls`` calls under ``torch.profiler``; device-busy is
    None where the profiler recorded no device time.  Busy time sums
    the device-side events only (kernels and copies, one stream), not
    the host operators that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    rows = [(e.self_device_time_total / 1e3 / calls, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _ in rows)
    top = sorted((r for r in rows if r[0] > 0), reverse=True)[:8]
    return wall, (busy if busy > 0 else None), top


class KernelReport:
    """Accumulates one kernel's shapes: error, times and bound."""

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.err = 0.0
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.ops_s = self.bytes_s = self.bound_s = 0.0

    def compare(self, got, want, tol, what):
        got, want = got.float(), want.float()
        check(got.shape == want.shape,
              f"{self.name} {what}: shape {tuple(got.shape)} vs "
              f"{tuple(want.shape)}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= tol * max(scale, 1e-30),
              f"{self.name} {what}: max error {err:.3e} > {tol} x "
              f"{scale:.3e}")
        self.err = max(self.err, err)

    def time(self, torch, what, kernel, plain, library, flops, nbytes):
        ms, pms, lms = (cuda_ms(torch, kernel), cuda_ms(torch, plain),
                        cuda_ms(torch, library))
        o, b = flops / PEAK_F32, nbytes / HBM_BW
        self.ms += ms
        self.plain_ms += pms
        self.library_ms += lms
        self.ops_s += o
        self.bytes_s += b
        self.bound_s += max(o, b)
        print(f"  {self.name:14s} {what:34s} kernel {ms:.4f} ms  plain "
              f"{pms:.4f} ms  library {lms:.4f} ms  bound "
              f"{max(o, b) * 1e3:.4f} ms ({'ops' if o >= b else 'bytes'})")

    def entry(self, paths):
        """``paths``: each path's launch counts, in the order run.  The
        kernel's ``launches`` are those of the first path that ran it
        (the PBQP main path where it picks the kernel, else the pinned
        plan at batch 1 that puts it there); every path's own count is
        listed beside."""
        by_path = {p: c[self.name] for p, c in paths.items()
                   if c.get(self.name)}
        first = next((p for p in by_path if p.endswith("_b1")), None)
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces,
                "launches": by_path[first] if first else 0,
                "launches_path": first, "launches_by_path": by_path,
                "max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_s * 1e3,
                "bound_by": ("operations" if self.ops_s >= self.bytes_s
                             else "bytes"),
                "library_ms": self.library_ms}


def kernel_phase(torch, F):
    from repro_torch.convnets import alexnet, googlenet
    from repro_torch.kernels.conv_direct import conv_direct_cuda, \
        conv_direct_ref
    from repro_torch.kernels.matmul import matmul_cuda, matmul_ref
    from repro_torch.kernels.winograd_gemm import bgemm_ref, \
        winograd_bgemm_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    convs = {n.id: n.scn for n in alexnet(1.0).conv_nodes()}
    k1 = KernelReport("matmul", "src/repro_torch/csrc/matmul.cu",
                      "src/repro/kernels/matmul/kernel.py:65")
    k2 = KernelReport("conv_im2col", "src/repro_torch/csrc/matmul.cu",
                      "src/repro/kernels/conv_im2col/kernel.py:13")
    k3 = KernelReport("winograd_gemm",
                      "src/repro_torch/csrc/winograd_gemm.cu",
                      "src/repro/kernels/winograd_gemm/kernel.py:38")
    k4 = KernelReport("conv_direct", "src/repro_torch/csrc/conv_direct.cu",
                      "src/repro/kernels/conv_direct/kernel.py:70")

    # K2: the im2col GEMMs of conv1..conv5, both output layouts
    for nid, s in convs.items():
        m, kk, n = s.m, s.c * s.k * s.k, s.out_h * s.out_w
        w, p = rand(m, kk, scale=0.05), rand(1, kk, n)
        p8 = rand(8, kk, n)
        for out in ("mn", "nm"):
            for pp, nb in ((p, 1), (p8, 8)):
                k2.compare(matmul_cuda(w, pp, out_layout=out),
                           matmul_ref(w, pp, out_layout=out), TOL_F32,
                           f"{nid} {out} batch {nb}")
        k2.time(torch, f"{nid} ({m}x{kk} @ {kk}x{n})",
                lambda: matmul_cuda(w, p), lambda: matmul_ref(w, p),
                lambda: torch.matmul(w, p), 2.0 * m * n * kk,
                4.0 * (m * kk + kk * n + m * n))

    # K1: GoogLeNet 1x1 GEMMs, both layouts, with/without bias + ReLU
    pw = {}
    for node in googlenet(1.0).conv_nodes():
        s = node.scn
        if s.k == 1:
            pw.setdefault((s.m, s.c, s.out_h * s.out_w), node.id)
    for (m, c, n), nid in sorted(pw.items(), key=lambda t: t[1])[:4]:
        w, x, b = rand(m, c, scale=0.05), rand(c, n), rand(n)
        for lhs in ("mk", "km"):
            a = w.T.contiguous() if lhs == "km" else w
            for out in ("mn", "nm"):
                for bias, relu in ((None, False), (b, True)):
                    k1.compare(
                        matmul_cuda(a, x, bias, fuse_relu=relu,
                                    lhs_layout=lhs, out_layout=out),
                        matmul_ref(a, x, bias, fuse_relu=relu,
                                   lhs_layout=lhs, out_layout=out),
                        TOL_F32, f"{nid} {lhs}/{out} bias={relu}")
        # batch 8 as the 1x1 primitive runs it: a CHW batch (N, C, OHOW)
        # and an HWC batch (N, OHOW, C) against the strided w.T
        x8, xt8 = rand(8, c, n), rand(8, n, c)
        for out in ("mn", "nm"):
            k1.compare(matmul_cuda(w, x8, out_layout=out),
                       matmul_ref(w, x8, out_layout=out), TOL_F32,
                       f"{nid} CHW batch 8 {out}")
            k1.compare(matmul_cuda(xt8, w.T, out_layout=out),
                       matmul_ref(xt8, w.T, out_layout=out), TOL_F32,
                       f"{nid} HWC batch 8 {out}")
        xb, wb, bb = (t.to(torch.bfloat16) for t in (x, w, b))
        k1.compare(matmul_cuda(wb, xb, bb, fuse_relu=True),
                   matmul_ref(wb, xb, bb, fuse_relu=True), TOL_BF16,
                   f"{nid} bf16")
        k1.time(torch, f"{nid} ({m}x{c} @ {c}x{n})",
                lambda: matmul_cuda(w, x), lambda: matmul_ref(w, x),
                lambda: torch.matmul(w, x), 2.0 * m * n * c,
                4.0 * (m * c + c * n + m * n))

    # K3: conv3..conv5 at F(2,3) and F(4,3)
    for nid in ("conv3", "conv4", "conv5"):
        s = convs[nid]
        for m_ in (2, 4):
            a = m_ + 2
            t = (-(-s.out_h // m_)) * (-(-s.out_w // m_))
            u, v = rand(a * a, s.m, s.c, scale=0.05), rand(1, a * a, s.c, t)
            v8 = rand(8, a * a, s.c, t)
            for vv, nb in ((v, 1), (v8, 8)):
                k3.compare(winograd_bgemm_cuda(u, vv), bgemm_ref(u, vv),
                           TOL_F32, f"{nid} F({m_},3) batch {nb}")
            k3.time(torch, f"{nid} F({m_},3) P={a * a} T={t}",
                    lambda: winograd_bgemm_cuda(u, v),
                    lambda: bgemm_ref(u, v), lambda: torch.matmul(u, v),
                    2.0 * a * a * s.m * s.c * t,
                    4.0 * a * a * (s.m * s.c + s.c * t + s.m * t))

    # K4: conv1 and conv2, CHW and HWC in and out
    for nid in ("conv1", "conv2"):
        s = convs[nid]
        w, b = rand(s.k, s.k, s.c, s.m, scale=0.05), rand(s.m)
        x_chw = rand(1, s.c, s.h, s.w)
        x_hwc = x_chw.permute(0, 2, 3, 1).contiguous()
        x8_chw = rand(8, s.c, s.h, s.w)
        x8_hwc = x8_chw.permute(0, 2, 3, 1).contiguous()
        for li, x, x8 in (("CHW", x_chw, x8_chw), ("HWC", x_hwc, x8_hwc)):
            for lo in ("CHW", "HWC"):
                kw = dict(stride=s.stride, pad=s.pad, in_layout=li,
                          out_layout=lo)
                for xx, nb in ((x, 1), (x8, 8)):
                    k4.compare(conv_direct_cuda(xx, w, b, **kw),
                               conv_direct_ref(xx, w, b, **kw), TOL_F32,
                               f"{nid} {li}->{lo} batch {nb}")
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(stride=s.stride, pad=s.pad)
        ohow = s.out_h * s.out_w
        k4.time(torch, f"{nid} HWC->HWC",
                lambda: conv_direct_cuda(x_hwc, w, b, **kw),
                lambda: conv_direct_ref(x_hwc, w, b, **kw),
                lambda: F.conv2d(x_chw, w_oihw, b, s.stride, s.pad),
                2.0 * ohow * s.m * s.k * s.k * s.c + ohow * s.m,
                4.0 * (s.c * s.h * s.w + s.k * s.k * s.c * s.m + s.m
                       + ohow * s.m))
    torch.cuda.synchronize()
    return [k1, k2, k3, k4]


def conv_phase(torch, F):
    """Every kernel primitive's whole convolution at batch 8, in its
    native and each fused layout, against an f64 ``F.conv2d``: the code
    around the kernels (padding, patch gathers, Winograd transforms,
    crops, strided reshapes), which the bindings' comparisons do not
    see.  Shapes: AlexNet's convs (GoogLeNet's 1x1s for the 1x1 GEMM)."""
    from repro_torch.convnets import alexnet, googlenet
    from repro_torch.core.primitives import convert_layout, registry

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    alex = [n.scn for n in alexnet(1.0).conv_nodes()]
    pw = list({s.key(): s for s in (n.scn for n in googlenet(1.0)
                                     .conv_nodes()) if s.k == 1}.values())[:4]
    for prim in (p for p in registry() if "kernel" in p.tags):
        scns = [s for s in (pw if prim.name == "pallas_pw_gemm_chw"
                            else alex) if prim.supports(s)]
        check(bool(scns), f"{prim.name} supports none of its shapes")
        combos = [(li, lo) for li in (prim.l_in,) + prim.fusable_in
                  for lo in (prim.l_out,) + prim.fusable_out]
        worst = 0.0
        for s in scns:
            w = rng.normal(0, np.sqrt(2.0 / (s.c * s.k * s.k)),
                           size=s.weight_shape).astype(np.float32)
            b = rng.normal(0, 0.01, size=(s.m,)).astype(np.float32)
            x = torch.from_numpy(rng.normal(size=(8, s.c, s.h, s.w))
                                 .astype(np.float32)).to(dev)
            want = F.conv2d(x.double(), torch.from_numpy(w).to(dev).double(),
                            torch.from_numpy(b).to(dev).double(), s.stride,
                            s.pad)
            scale = float(want.abs().max())
            packed = {k: v.to(dev) for k, v in prim.prepare(s, w, b).items()}
            for li, lo in combos:
                f = prim.make_fused(s, l_in=li, l_out=lo)
                got = convert_layout(f(convert_layout(x, "CHW", li), packed),
                                     lo, "CHW")
                check(tuple(got.shape) == tuple(want.shape),
                      f"{prim.name} {s.key()} {li}->{lo}: shape "
                      f"{tuple(got.shape)} vs {tuple(want.shape)}")
                err = float((got.double() - want).abs().max())
                check(err <= TOL_F32 * scale,
                      f"{prim.name} {s.key()} {li}->{lo} batch 8: max "
                      f"error {err:.3e} > {TOL_F32} x {scale:.3e}")
                worst = max(worst, err / scale)
        print(f"  {prim.name:22s} {len(scns)} convs x {len(combos)} layouts "
              f"{combos}, batch 8: largest error {worst:.3e} of max|ref|")
    torch.cuda.synchronize()


def to_np(t):
    return t.detach().float().cpu().numpy()


def agree(got, want, what):
    """Every output within ``NET_REL`` of the reference's largest
    magnitude, finite and of the same shape; the probabilities also at
    the quickstart's ``NET_TOL``."""
    check(got.keys() == want.keys(), f"{what}: output sets differ")
    for k in want:
        a, b = to_np(got[k]), to_np(want[k])
        check(a.shape == b.shape, f"{what} {k}: {a.shape} vs {b.shape}")
        check(bool(np.isfinite(a).all()), f"{what} {k}: non-finite output")
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        check(err <= NET_REL * max(scale, 1e-30),
              f"{what} {k}: max |diff| {err:.3e} > {NET_REL} x {scale:.3e}")
    if "prob" in want:
        a, b = to_np(got["prob"]), to_np(want["prob"])
        check(np.allclose(a, b, rtol=NET_TOL, atol=NET_TOL),
              f"{what} prob: max |diff| {np.abs(a - b).max():.3e}")


def taps(net):
    """The outputs plans are compared at: every conv, the logits (the
    softmax's input) and the probabilities."""
    soft = next(n for n in net.order if net.nodes[n].kind == "op"
                and net.nodes[n].op.name == "softmax")
    return [n.id for n in net.conv_nodes()] + [net.nodes[soft].inputs[0],
                                               soft]


def expected_launches(sel):
    """One launch per conv that the selection gives to each kernel."""
    want = {}
    for node in sel.net.conv_nodes():
        k = COUNTER_OF.get(sel.choices[node.id].primitive.name)
        if k:
            want[k] = want.get(k, 0) + 1
    return want


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.convnets import alexnet, googlenet
    from repro_torch.core.costs import (H100_SPEC, AnalyticCostModel,
                                        ProfiledCostModel)
    from repro_torch.core.plan import compile_plan, measure
    from repro_torch.core.primitives import registry
    from repro_torch.core.selection import (select_fixed, select_pbqp,
                                            select_sum2d)
    from repro_torch.kernels import kernel_libs
    from repro_torch.kernels.common import (build_all, launch_counts,
                                            reset_launch_counts, true_f32)

    # ---- 1. environment + build ----
    t_start = time.perf_counter()
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    libs = build_all(kernel_libs())
    print(f"built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(p.name for p in libs))

    # ---- 2. kernels against their plain versions ----
    print("== kernels (device ms per call: CUDA events over 20 queued "
          "calls, median of 5; bound = max(flops / 67e12, bytes / "
          "3.35e12)) ==")
    with true_f32():
        reports = kernel_phase(torch, F)
        print("== whole convolutions of the kernel primitives against f64 "
              "F.conv2d ==")
        conv_phase(torch, F)

    # each plan run below is one path: counts at 0 just before its one
    # forward, read just after, and exactly one launch per conv that its
    # selection gives to a kernel
    paths = {}

    def run_path(name, cnet, x):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = cnet(x)
        torch.cuda.synchronize()
        paths[name] = launch_counts()
        want = expected_launches(cnet.sel)
        check(paths[name] == want, f"path {name}: launches {paths[name]}, "
              f"expected one per kernel conv {want}")
        print(f"  path {name}: launches {paths[name]}")
        return out

    # ---- 3. main path: AlexNet 227x227 ----
    cost = AnalyticCostModel(H100_SPEC, include_kernels=True)
    net = alexnet(1.0)
    params = net.init_params(seed=0)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8,) + net.nodes["data"].out_shape).astype(
        np.float32)
    sel = select_pbqp(net, cost)
    print(f"== main path: {net.name}, PBQP under {H100_SPEC.name} with "
          f"kernels priced: optimal={sel.optimal}, predicted "
          f"{sel.predicted_cost * 1e3:.4f} ms, {len(sel.conversions)} "
          f"conversions {sorted(sel.conversions.items())} ==")
    for node in net.conv_nodes():
        ch = sel.choices[node.id]
        print(f"  {node.id:6s} {node.scn.key():34s} -> "
              f"{ch.primitive.name} [{ch.l_in}->{ch.l_out}]")
    base_sel = select_sum2d(net, cost)
    opt, base = compile_plan(sel, params), compile_plan(base_sel, params)
    opt8 = compile_plan(sel, params, batch=8)
    base8 = compile_plan(base_sel, params, batch=8)
    x1, x8 = (torch.from_numpy(a).to(opt.device) for a in (xs[0], xs))
    out = to_np(run_path("pbqp_alexnet_b1", opt, x1)["prob"])
    check(out.shape == (1000, 1, 1) and abs(out.sum() - 1.0) < 1e-3,
          f"AlexNet output {out.shape} sums to {out.sum()}")
    run_path("pbqp_alexnet_b8", opt8, x8)
    t_ = taps(net)
    base_t = compile_plan(base_sel, params, batch=8, outputs=t_)(x8)
    opt_t = compile_plan(sel, params, batch=8, outputs=t_)(x8)
    agree(opt_t, base_t, "PBQP vs SUM2D, batch 8")
    agree(compile_plan(sel, params, outputs=t_)(x1),
          {k: v[0] for k, v in base_t.items()}, "PBQP vs SUM2D, batch 1")
    agree(compile_plan(sel, params, outputs=t_)(x1),
          compile_plan(sel, params, device="cpu", outputs=t_)(xs[0]),
          "PBQP on the card vs the port's CPU path, batch 1")
    print(f"  PBQP agrees with SUM2D at batch 1 and 8 and with the CPU "
          f"path at {len(t_)} outputs ({', '.join(t_[-2:])} and every "
          f"conv)")
    t_opt, t_base = measure(opt, x1, reps=20), measure(base, x1, reps=20)
    t_opt8, t_base8 = measure(opt8, x8, reps=20), measure(base8, x8,
                                                          reps=20)
    for what, cn, x in (("PBQP batch 1", opt, x1), ("PBQP batch 8", opt8, x8),
                        ("SUM2D batch 1", base, x1)):
        wall, busy, top = device_profile(torch, lambda: cn(x))
        share = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / wall):.4f}"
        print(f"  profile {what}: wall {wall:.4f} ms/forward, device busy "
              f"{'not measured' if busy is None else f'{busy:.4f} ms'}, "
              f"idle share {share}")
        for t, key in top:
            print(f"    {t:9.4f} ms  {key[:90]}")
    for b, to, tb in ((1, t_opt, t_base), (8, t_opt8, t_base8)):
        print(f"  batch {b} (host clock to synchronize, 20 forwards): PBQP "
              f"mean {to['mean_s'] * 1e3:.4f} ms (min "
              f"{to['min_s'] * 1e3:.4f}, std {to['std_s'] * 1e3:.4f}); "
              f"SUM2D mean {tb['mean_s'] * 1e3:.4f} ms (min "
              f"{tb['min_s'] * 1e3:.4f}, std {tb['std_s'] * 1e3:.4f}); "
              f"PBQP/SUM2D {to['mean_s'] / tb['mean_s']:.4f}")

    # ---- 4. each kernel primitive pinned onto every conv it supports ----
    print("== pinned kernel primitives (batch 2 and 1) ==")
    gnet = googlenet(1.0)
    gparams = gnet.init_params(seed=0)
    gxs = torch.from_numpy(rng.normal(
        size=(2,) + gnet.nodes["data"].out_shape).astype(np.float32)).to(
            opt.device)
    sum2d_outs = {}
    for prim in (p for p in registry() if "kernel" in p.tags):
        n_, p_, x_ = (gnet, gparams, gxs) if prim.name == \
            "pallas_pw_gemm_chw" else (net, params, x8[:2])
        pick = {nd.id: prim for nd in n_.conv_nodes()
                if prim.supports(nd.scn)}
        check(bool(pick), f"{prim.name} supports no conv of {n_.name}")
        if n_.name not in sum2d_outs:
            sum2d_outs[n_.name] = compile_plan(
                select_sum2d(n_, cost), p_, batch=2, outputs=taps(n_))(x_)
        want = sum2d_outs[n_.name]
        psel = select_fixed(n_, cost, pick, f"pinned_{prim.name}")
        run_path(f"pinned_{prim.name}_b2",
                 compile_plan(psel, p_, batch=2), x_)
        run_path(f"pinned_{prim.name}_b1", compile_plan(psel, p_), x_[0])
        agree(compile_plan(psel, p_, batch=2, outputs=taps(n_))(x_), want,
              f"{prim.name} pinned on {n_.name}, batch 2")
        agree(compile_plan(psel, p_, outputs=taps(n_))(x_[0]),
              {k: v[0] for k, v in want.items()},
              f"{prim.name} pinned on {n_.name}, batch 1")
        print(f"  {prim.name:22s} on {len(pick):2d} convs of {n_.name}: "
              f"agrees with SUM2D at batch 2 and 1")
    for r in reports:
        check(any(c.get(r.name) for c in paths.values()),
              f"kernel {r.name} never launched on a path")

    # ---- 5. fused selection on GoogLeNet ----
    fsel = select_pbqp(gnet, cost, fuse=True)
    run_path("fused_pbqp_googlenet_b2", compile_plan(fsel, gparams, batch=2),
             gxs)
    agree(compile_plan(fsel, gparams, batch=2, outputs=taps(gnet))(gxs),
          sum2d_outs[gnet.name], "GoogLeNet fused PBQP vs SUM2D")
    print(f"== fused PBQP on {gnet.name}: {len(fsel.fusions)} fused edges, "
          f"{len(fsel.conversions)} conversions, agrees with SUM2D ==")

    # ---- 6. profiled selection on AlexNet ----
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        prof = ProfiledCostModel(str(pathlib.Path(tmp) / "profile.json"),
                                 reps=1, min_time=1e-3)
        psel = select_pbqp(net, prof)
        wall = time.perf_counter() - t0
    run_path("profiled_pbqp_alexnet_b1", compile_plan(psel, params), x1)
    agree(compile_plan(psel, params, outputs=t_)(x1),
          {k: v[0] for k, v in base_t.items()}, "profiled PBQP vs SUM2D")
    print(f"== profiled selection on {net.name}: {wall:.2f} s wall, "
          f"predicted {psel.predicted_cost * 1e3:.4f} ms ==")
    for node in net.conv_nodes():
        ch = psel.choices[node.id]
        print(f"  {node.id:6s} -> {ch.primitive.name} [{ch.l_in}->"
              f"{ch.l_out}]")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [r.entry(paths) for r in reports]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
