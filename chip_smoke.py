#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for Hopper, sm_90a) and
``nvcc``; exits non-zero, printing no result, without them or outside a
checkout of the repository.  Phases, each of which raises on failure:

1. environment: card, power limit, versions; build every CUDA kernel
   from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and print each kernel's registers, shared memory and spills as
   ``nvcc -Xptxas -v`` reports them (the GEMM mainloop's kernels, in
   every dtype, and every flash-attention instantiation must spill
   nothing);
2. kernels: each hand-written kernel's binding against its plain PyTorch
   version on the card at AlexNet's (and GoogLeNet's 1x1) shapes, at
   batch 1 and 8, with its time, the plain version's, one library
   call's and the card's lower bound, and for the GEMM, the Winograd
   GEMM (its batch folded into N) and the direct conv the launch
   planner's choice (tile, K splits, blocks) and a second call that must
   give the same bits, in f32 and in bf16 and f16; the layout transforms
   (K5, bit for bit, in 1- to 8-byte elements, short channel axes
   included) and flash attention (K6, every masking and layout option,
   head dims 7 to 320, f32, bf16 and f16, its planner's query tile, KV
   split and blocks, the same bits on a repeated call) at the
   calibration sweep's shapes; then every kernel primitive's
   whole convolution (padding, gathers, transforms, crops and each
   fused layout) at batch 8 against an f64 ``F.conv2d``;
3. main path: AlexNet at 227x227 through ``select_pbqp`` under the H100
   cost model with the kernels priced, ``compile_plan`` on the card at
   batch 1 and 8, against the SUM2D plan and the port's CPU path;
4. pinned: each kernel primitive pinned by ``select_fixed`` onto every
   conv that supports it (AlexNet; GoogLeNet for the 1x1 GEMM), against
   SUM2D at batch 2 and 1;
5. fused: ``select_pbqp(fuse=True)`` on GoogLeNet against SUM2D;
6. profiled selection: ``ProfiledCostModel`` on AlexNet, timed;
7. calibration: ``python -m repro_torch.launch.calibrate`` (its
   ``main``) sweeps AlexNet's buckets at batch 1 and 8 with the kernel
   microbenchmarks on; the profile must hold every planned key, a second
   run must resume with nothing to measure, each of the 56 kernel items
   must launch exactly one kernel of its own package, and
   ``CalibratedCostModel`` must select plans, at batch 1 and 8, that
   agree with SUM2D; a CPU-stamped profile must be refused on the card.

Plans are compared at every conv's output, the pre-softmax logits and
the probabilities, each within 1e-3 of the reference's largest
magnitude (the probabilities also at the quickstart's 2e-3).

Every plan run in phases 3-7 is a path: the launch counts are set to 0
just before its one forward and read just after, and must equal one
launch per conv that its selection gave to each kernel (the batch runs
on the kernels' grids).  So is each calibration kernel item: counts at
0, its builder's function called once, counts read.  The last lines are
a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
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
#: largest plain magnitude; bf16 and f16: one rounding of the output
TOL_F32 = 1e-3
TOL_BF16 = 2e-2
#: flash attention in f32: kernel and plain version sum the D-term
#: logits and the Lk-term P V in other orders and round exp/tanh
#: differently, a few f32 ulps of the output (~1e-6 of its largest
#: magnitude), so 1e-5; bf16 outputs are rounded to 8 bits, as above.
#: The layout transforms copy bits: they must be exact.
TOL_ATTN = 1e-5
#: the calibration sweep's layout-transform shapes (AlexNet's buckets),
#: a ragged one, and short channel axes (C = 1 .. 8, the kernel's
#: short-axis routes) over ragged H*W
LAYOUT_SHAPES = [(4, 256, 256), (128, 32, 32), (256, 16, 16), (512, 16, 16),
                 (96, 27, 27), (1, 13, 17), (2, 27, 27), (3, 227, 227),
                 (4, 27, 31), (5, 7, 9), (8, 13, 13)]
#: phase 7's calibration CLI arguments; the measurement discipline is
#: the CLI's default (``--reps 3 --min-time 5e-3``)
CALIB_NET, CALIB_SCALE, CALIB_BATCHES = "alexnet", 1.0, (1, 8)
CALIB_ARGS = ["--net", CALIB_NET, "--scale", str(CALIB_SCALE), "--batches",
              *map(str, CALIB_BATCHES), "--kernels", "on"]
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


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    """Accumulates one kernel's shapes: error, times and bound.

    ``name`` is the kernel's launch counter.  ``on_path``: whether the
    calibration path launches it (K5b and K5d, the reverse transforms,
    are reached only through ``convert``, which the sweep does not call
    in that direction)."""

    def __init__(self, name, source, replaces, on_path=True):
        self.name, self.source, self.replaces = name, source, replaces
        self.on_path = on_path
        self.err = self.rel_err = 0.0
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.ops_s = self.bytes_s = self.bound_s = 0.0
        self.batch8 = None  # K3: a second report, its times at batch 8

    def same_bits(self, fn, what):
        """Two calls give the same bits: the split-K sum has a fixed
        order (no atomics)."""
        check(bool(fn().equal(fn())), f"{self.name} {what}: two calls "
              "differ")

    def compare(self, got, want, tol, what):
        """Within ``tol`` of the plain version's largest magnitude;
        ``tol=0`` asks for the same bits."""
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{self.name} {what}: {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        if tol == 0:
            check(got.equal(want),
                  f"{self.name} {what}: not bit-exact")
            return
        got, want = got.float(), want.float()
        check(bool(got.isfinite().all()), f"{self.name} {what}: non-finite")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= tol * max(scale, 1e-30),
              f"{self.name} {what}: max error {err:.3e} > {tol} x "
              f"{scale:.3e}")
        self.err = max(self.err, err)
        self.rel_err = max(self.rel_err, err / max(scale, 1e-30))

    def time(self, torch, what, kernel, plain, library, flops, nbytes,
             plan=None):
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
              f"{max(o, b) * 1e3:.4f} ms ({'ops' if o >= b else 'bytes'})"
              + (f"  [{plan.describe()}]" if plan is not None else ""))

    def entry(self, paths):
        """``paths``: each path's launch counts, in the order run.  The
        kernel's ``launches`` are those of the first plan path that ran
        it (the PBQP main path where it picks the kernel, else the pinned
        plan at batch 1 that puts it there); for the kernels that no plan
        runs (K5, K6), the sum over the calibration path's kernel items,
        one call each.  Every path's own count is listed beside, and
        K3's times at batch 8 (``batch8``)."""
        by_path = {p: c[self.name] for p, c in paths.items()
                   if c.get(self.name)}
        first = next((p for p in by_path if p.endswith("_b1")), None)
        if first:
            launches = by_path[first]
        else:
            first = "calibrate_kernel_items"
            launches = sum(n for p, n in by_path.items()
                           if p.startswith("calibrate_"))
        entry = {"name": self.name, "route": "cuda", "source": self.source,
                 "replaces": self.replaces, "launches": launches,
                 "launches_path": first, "launches_by_path": by_path,
                 "max_abs_err": self.err, "max_rel_err": self.rel_err,
                 "ms": self.ms,
                 "plain_ms": self.plain_ms, "bound_ms": self.bound_s * 1e3,
                 "bound_by": ("operations" if self.ops_s >= self.bytes_s
                              else "bytes"),
                 "library_ms": self.library_ms}
        if self.batch8 is not None:
            b8 = self.batch8
            entry["batch8"] = {"ms": b8.ms, "plain_ms": b8.plain_ms,
                               "library_ms": b8.library_ms,
                               "bound_ms": b8.bound_s * 1e3}
        return entry


#: the sources whose kernels must spill nothing: those on the GEMM
#: mainloop (``csrc/sgemm_sm90.cuh``) and flash attention's
MAINLOOP_SOURCES = ("matmul.cu", "conv_direct.cu", "winograd_gemm.cu",
                    "flash_attention.cu")


def demangle(names):
    """C++ names as ``c++filt`` gives them, without the namespaces and
    the argument list; the mangled names where it is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    short = []
    for name in out:
        for ns in ("repro::sm90::", "(anonymous namespace)::", "void "):
            name = name.replace(ns, "")
        short.append(name.split("(")[0] if "(" in name else name)
    return short if len(short) == len(names) else list(names)


def ptxas_phase(libs):
    """Each kernel's registers, static shared memory, stack and spill
    bytes from its library's ``-Xptxas -v`` report."""
    from repro_torch.kernels.common import ptxas_usage
    for lib in libs:
        usage = ptxas_usage(lib.ptxas_report())
        check(bool(usage), f"{lib.source.name}: no kernel in the ptxas "
              "report")
        for name, (fn, u) in zip(demangle(list(usage)), usage.items()):
            print(f"  ptxas {lib.source.name:20s} {name[:60]:60s} "
                  f"{u['registers']:3d} registers, {u['smem']} B static "
                  f"smem, {u['stack']} B stack, {u['spill']} B spilled")
            if lib.source.name in MAINLOOP_SOURCES:
                check(u["spill"] == 0, f"{lib.source.name} {fn} spills "
                      f"{u['spill']} bytes")


def kernel_phase(torch, F):
    from repro_torch.convnets import alexnet, googlenet
    from repro_torch.kernels.conv_direct import conv_direct_cuda, \
        conv_direct_ref, conv_plan
    from repro_torch.kernels.matmul import matmul_cuda, matmul_plan, \
        matmul_ref
    from repro_torch.kernels.matmul.plan import vector_width
    from repro_torch.kernels.winograd_gemm import bgemm_ref, \
        winograd_bgemm_cuda
    from repro_torch.kernels.winograd_gemm.kernel import bgemm_plan

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
                k2.same_bits(lambda: matmul_cuda(w, pp, out_layout=out),
                             f"{nid} {out} batch {nb}")
        k2.time(torch, f"{nid} ({m}x{kk} @ {kk}x{n})",
                lambda: matmul_cuda(w, p), lambda: matmul_ref(w, p),
                lambda: torch.matmul(w, p), 2.0 * m * n * kk,
                4.0 * (m * kk + kk * n + m * n), matmul_plan(w, p))

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
                    kw = dict(fuse_relu=relu, lhs_layout=lhs,
                              out_layout=out)
                    k1.compare(matmul_cuda(a, x, bias, **kw),
                               matmul_ref(a, x, bias, **kw), TOL_F32,
                               f"{nid} {lhs}/{out} bias={relu}")
                    k1.same_bits(lambda: matmul_cuda(a, x, bias, **kw),
                                 f"{nid} {lhs}/{out} bias={relu}")
        # batch 8 as the 1x1 primitive runs it: a CHW batch (N, C, OHOW)
        # and an HWC batch (N, OHOW, C) against the strided w.T
        x8, xt8 = rand(8, c, n), rand(8, n, c)
        for out in ("mn", "nm"):
            for lhs_, rhs_, what in ((w, x8, "CHW"), (xt8, w.T, "HWC")):
                k1.compare(matmul_cuda(lhs_, rhs_, out_layout=out),
                           matmul_ref(lhs_, rhs_, out_layout=out), TOL_F32,
                           f"{nid} {what} batch 8 {out}")
                k1.same_bits(lambda: matmul_cuda(lhs_, rhs_, out_layout=out),
                             f"{nid} {what} batch 8 {out}")
        for dt in (torch.bfloat16, torch.float16):
            xb, wb, bb = (t.to(dt) for t in (x, w, b))
            k1.compare(matmul_cuda(wb, xb, bb, fuse_relu=True),
                       matmul_ref(wb, xb, bb, fuse_relu=True), TOL_BF16,
                       f"{nid} {dt}")
            k1.same_bits(lambda: matmul_cuda(wb, xb, bb, fuse_relu=True),
                         f"{nid} {dt}")
        k1.time(torch, f"{nid} ({m}x{c} @ {c}x{n})",
                lambda: matmul_cuda(w, x), lambda: matmul_ref(w, x),
                lambda: torch.matmul(w, x), 2.0 * m * n * c,
                4.0 * (m * c + c * n + m * n), matmul_plan(w, x))

    # K3: conv3..conv5 at F(2,3) and F(4,3), the reference's (P, M, C) @
    # (P, C, N) with U packed as prepare_kernel packs it (M contiguous)
    # and the images folded into N = images * T, as conv_winograd calls
    # it; batch 8 timed apart; plus a ragged shape (M, C, N odd)
    k3b8 = KernelReport("winograd_gemm", k3.source, k3.replaces)
    for nid in ("conv3", "conv4", "conv5"):
        s = convs[nid]
        for m_ in (2, 4):
            a = m_ + 2
            t = (-(-s.out_h // m_)) * (-(-s.out_w // m_))
            u = rand(a * a, s.c, s.m, scale=0.05).transpose(1, 2)
            for nb, rpt in ((1, k3), (8, k3b8)):
                v = rand(a * a, s.c, nb * t)
                what = f"{nid} F({m_},3) batch {nb}"
                k3.compare(winograd_bgemm_cuda(u, v), bgemm_ref(u, v),
                           TOL_F32, what)
                k3.same_bits(lambda: winograd_bgemm_cuda(u, v), what)
                n = nb * t
                rpt.time(torch, f"{what} P={a * a} N={n}",
                         lambda: winograd_bgemm_cuda(u, v),
                         lambda: bgemm_ref(u, v),
                         lambda: torch.matmul(u, v),
                         2.0 * a * a * s.m * s.c * n,
                         4.0 * a * a * (s.m * s.c + s.c * n + s.m * n),
                         bgemm_plan(u, v))
        # bf16 and f16 at F(4,3), batch 8: loaded through registers
        u = rand(36, s.c, s.m, scale=0.05).transpose(1, 2)
        v = rand(36, s.c, 8 * 16)
        for dt in (torch.bfloat16, torch.float16):
            ub, vb = u.to(dt), v.to(dt)
            what = f"{nid} F(4,3) batch 8 {dt}"
            k3.compare(winograd_bgemm_cuda(ub, vb), bgemm_ref(ub, vb),
                       TOL_BF16, what)
            k3.same_bits(lambda: winograd_bgemm_cuda(ub, vb), what)
    u, v = rand(16, 77, 45, scale=0.05), rand(16, 45, 51)
    k3.compare(winograd_bgemm_cuda(u, v), bgemm_ref(u, v), TOL_F32,
               "ragged 77x45 @ 45x51")
    k3.same_bits(lambda: winograd_bgemm_cuda(u, v), "ragged 77x45 @ 45x51")
    print(f"  {k3.name:14s} batch 8 total: kernel {k3b8.ms:.5f} ms  plain "
          f"{k3b8.plain_ms:.5f} ms  library {k3b8.library_ms:.5f} ms  "
          f"bound {k3b8.bound_s * 1e3:.5f} ms")
    k3.batch8 = k3b8

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
                    k4.same_bits(lambda: conv_direct_cuda(xx, w, b, **kw),
                                 f"{nid} {li}->{lo} batch {nb}")
                for dt in (torch.bfloat16, torch.float16):
                    xb, wb, bb = x8.to(dt), w.to(dt), b.to(dt)
                    what = f"{nid} {li}->{lo} batch 8 {dt}"
                    k4.compare(conv_direct_cuda(xb, wb, bb, **kw),
                               conv_direct_ref(xb, wb, bb, **kw), TOL_BF16,
                               what)
                    k4.same_bits(lambda: conv_direct_cuda(xb, wb, bb, **kw),
                                 what)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        kw = dict(stride=s.stride, pad=s.pad)
        ohow = s.out_h * s.out_w
        k4.time(torch, f"{nid} HWC->HWC",
                lambda: conv_direct_cuda(x_hwc, w, b, **kw),
                lambda: conv_direct_ref(x_hwc, w, b, **kw),
                lambda: F.conv2d(x_chw, w_oihw, b, s.stride, s.pad),
                2.0 * ohow * s.m * s.k * s.k * s.c + ohow * s.m,
                4.0 * (s.c * s.h * s.w + s.k * s.k * s.c * s.m + s.m
                       + ohow * s.m),
                conv_plan(1, s.c, s.m, s.k, s.out_h, s.out_w, False,
                          vector_width(w.view(-1, s.m), 1)))
    torch.cuda.synchronize()
    return [k1, k2, k3, k4]


def layout_phase(torch, dev):
    """K5: the four layout-transform entries (one CUDA transpose, with a
    route for a short axis) against their plain versions, bit for bit, at
    the sweep's shapes, a ragged one and short channel axes, single and
    batched, in 1-, 2-, 4- and 8-byte elements, one launch per call.  Timed at the sweep's
    shapes: CHW -> HWC at conv1's bucket (C % 8 != 0), CHW -> HWC8 at the
    others, and each reverse entry at the same shapes."""
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.kernels.layout_transform import kernel as lk
    from repro_torch.kernels.layout_transform import ops as lo
    from repro_torch.kernels.layout_transform import ref as lr

    src = "src/repro_torch/csrc/layout_transform.cu"
    ref = "src/repro/kernels/layout_transform/kernel.py"
    reports = {e: KernelReport(f"layout_transform.{e}", src, f"{ref}:{line}",
                               on_path=e in ("chw_to_hwc", "chw_to_hwc8"))
               for e, line in (("chw_to_hwc", 27), ("hwc_to_chw", 43),
                               ("chw_to_hwc8", 77), ("hwc8_to_chw", 94))}
    rng = np.random.default_rng(2)
    for c, h, w in LAYOUT_SHAPES:
        x = torch.from_numpy(rng.normal(size=(c, h, w)).astype(
            np.float32)).to(dev)
        hwc = x.permute(1, 2, 0).contiguous()
        cases = [("chw_to_hwc", x, lambda a: a.permute(1, 2, 0)),
                 ("hwc_to_chw", hwc, lambda a: a.permute(2, 0, 1))]
        if c % 8 == 0:
            cases += [("chw_to_hwc8", x, lambda a: a.permute(1, 2, 0)),
                      ("hwc8_to_chw", hwc.reshape(h, w, c // 8, 8),
                       lambda a: a.reshape(h, w, c).permute(2, 0, 1))]
        for e, xin, lib in cases:
            rpt = reports[e]
            for xx, what in ((xin, "single"),
                             (torch.stack([xin, -xin]), "batch 2"),
                             (xin.to(torch.bfloat16), "bf16"),
                             ((xin * 40).to(torch.int8), "int8"),
                             (xin.double(), "f64")):
                reset_launch_counts()
                got = getattr(lo, e)(xx)
                counts = launch_counts()
                check(counts == {rpt.name: 1},
                      f"{rpt.name} {what}: launches {counts}")
                rpt.compare(got, getattr(lr, f"{e}_ref")(xx), 0,
                            f"{(c, h, w)} {what}")
            swept = (c, h, w) in LAYOUT_SHAPES[:4]
            if swept and (c % 8 == 0) == ("8" in e):
                n = xin.numel()
                rpt.time(torch, f"{tuple(xin.shape)}",
                         lambda: getattr(lk, f"{e}_cuda")(xin),
                         lambda: getattr(lr, f"{e}_ref")(xin),
                         lambda: lib(xin).contiguous(), 0.0, 2.0 * 4 * n)
    sync(torch, dev)
    print("  layout transforms: all four entries bit-exact at "
          f"{LAYOUT_SHAPES}, single, batch 2, bf16, int8 and f64, one "
          "launch each")
    return list(reports.values())


def attention_phase(torch, F, dev):
    """K6: flash attention against its plain version on the sweep's two
    shapes and on every option of the kernel, head dims 7 to 320 (padded
    to an instantiated width, or sliced above 256), f32, bf16 and f16,
    one launch per call; a cluster split that leaves ranks with no KV
    tile; the sweep shapes timed, each with its launch plan, and a
    repeated call that gives the same bits."""
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (attention_plan,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.plan import make_plan

    rpt = KernelReport("flash_attention",
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention/kernel.py:93")
    rng = np.random.default_rng(3)
    bf16, f16 = torch.bfloat16, torch.float16
    # (what, (B, Hq, Hkv, Lq, Lk, D), dtype, options)
    cases = [
        ("sweep conv1/conv2", (1, 4, 4, 1024, 1024, 64), None, {}),
        ("sweep conv3-conv5", (1, 4, 4, 256, 256, 64), None, {}),
        ("causal", (2, 4, 4, 300, 300, 64), None, dict(causal=True)),
        ("causal + window", (1, 4, 4, 300, 300, 128), None,
         dict(causal=True, window=40)),
        ("softcap", (1, 4, 4, 200, 200, 64), None, dict(softcap=5.0)),
        ("GQA 8/2", (2, 8, 2, 200, 200, 64), None, {}),
        ("LHD", (2, 4, 2, 300, 300, 64), None,
         dict(layout="LHD", causal=True)),
        ("Lq != Lk, ragged", (1, 4, 4, 77, 45, 128), None, dict(window=9)),
        ("fully masked rows", (1, 2, 2, 64, 16, 64), None,
         dict(causal=True, window=8)),
        ("head dim 256", (1, 4, 4, 130, 130, 256), None, {}),
        ("head dim 16", (1, 4, 4, 200, 200, 16), None, dict(causal=True)),
        ("head dim 32", (2, 4, 2, 256, 256, 32), None, {}),
        ("head dim 112", (1, 4, 4, 300, 300, 112), None, dict(softcap=5.0)),
        ("head dim 320", (1, 4, 2, 130, 90, 320), None, dict(causal=True)),
        ("head dim 7, LHD", (1, 4, 4, 100, 100, 7), None,
         dict(layout="LHD")),
        ("bf16", (1, 4, 4, 256, 256, 64), bf16, {}),
        ("bf16 causal", (1, 4, 2, 200, 200, 128), bf16, dict(causal=True)),
        ("f16", (1, 4, 4, 256, 256, 64), f16, {}),
        ("f16 head dim 112", (1, 4, 2, 200, 200, 112), f16,
         dict(causal=True)),
    ]
    for what, (b, hq, hkv, lq, lk, d), dtype, kw in cases:
        lhd = kw.get("layout") == "LHD"
        qs = (b, lq, hq, d) if lhd else (b, hq, lq, d)
        ks = (b, lk, hkv, d) if lhd else (b, hkv, lk, d)
        q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                   .to(dev, dtype or torch.float32) for s in (qs, ks, ks))
        reset_launch_counts()
        got = flash_attention(q, k, v, **kw)
        counts = launch_counts()
        check(counts == {rpt.name: 1}, f"{rpt.name} {what}: launches "
              f"{counts}")
        plain = dict(scale=d ** -0.5, seq_major=lhd,
                     **{o: kw[o] for o in ("causal", "window", "softcap")
                        if o in kw})
        rpt.compare(got, flash_attention_ref(q, k, v, **plain),
                    TOL_ATTN if dtype is None else TOL_BF16, what)
        if what == "fully masked rows":
            # keys 0..15, window 8: rows 23 and up see no key
            check(bool((got[:, :, 23:] == 0).all()) and
                  bool((got[:, :, :23].abs().sum(-1) > 0).all()),
                  f"{rpt.name}: fully masked rows are not exactly 0")
        if what.startswith("sweep"):
            rpt.same_bits(lambda: flash_attention_cuda(q, k, v,
                                                       scale=d ** -0.5),
                          what)
            rpt.time(torch, f"{what} {qs}",
                     lambda: flash_attention_cuda(q, k, v, scale=d ** -0.5),
                     lambda: flash_attention_ref(q, k, v, scale=d ** -0.5),
                     lambda: F.scaled_dot_product_attention(q, k, v),
                     4.0 * b * hq * lq * lk * d,
                     4.0 * (2 * q.numel() + k.numel() + v.numel()),
                     attention_plan(q, k, v))
    # a split of 4 over the first query tile's one KV tile: ranks 1-3
    # hold no key (m = -1e30, l = 0) and must weigh nothing
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 512, 64)).astype(
        np.float32)).to(dev) for _ in range(3))
    kw = dict(scale=0.125, causal=True, window=48, lk_valid=300)
    plan = make_plan(1, 4, 512, 64, 64, 64, 4)
    got = flash_attention_cuda(q, k, v, plan=plan, **kw)
    rpt.compare(got, flash_attention_ref(q, k, v, **kw), TOL_ATTN,
                "split of 4 with empty ranks")
    check(bool((got[:, :, 347:] == 0).all()),
          f"{rpt.name}: rows no key reaches are not exactly 0")
    rpt.same_bits(lambda: flash_attention_cuda(q, k, v, plan=plan, **kw),
                  "split of 4 with empty ranks")
    sync(torch, dev)
    print(f"  flash attention: {len(cases) + 1} cases within {TOL_ATTN} "
          f"(f32) / {TOL_BF16} (bf16, f16) of the largest plain magnitude, "
          f"head dims 7 to 320, fully masked rows exactly 0, one launch "
          f"each")
    return [rpt]


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


def run_calibrate_cli(cli, argv, log):
    """``repro_torch.launch.calibrate.main(argv)`` with its output (one
    line per measurement) written to ``log``; returns that output."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    log.write(f"$ calibrate {' '.join(argv)}\n{text}")
    check(rc == 0, f"calibrate {argv} exited {rc}")
    for line in text.splitlines():
        if line.startswith(("sweep plan", "device ", "measured ")):
            print(f"  {line}")
    return text


def calibration_phase(torch, dev, out_dir, run_path, paths, net, params,
                      inputs, sum2d, taps_, plans):
    """Phase 7: the calibration CLI on the card, then selection on its
    profile.  ``inputs``/``sum2d``: batch -> input and SUM2D outputs at
    ``taps_``; ``plans``: name -> (batch, compiled plan) timed beside the
    calibrated plans."""
    import collections
    import re

    from repro_torch.calibrate import (CalibratedCostModel, HardwareProfile,
                                       plan_sweep, registry_hash,
                                       scenarios_from_net)
    from repro_torch.calibrate.sweep import _kernel_benchmarks
    from repro_torch.convnets import NETWORKS
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.plan import compile_plan, measure
    from repro_torch.core.selection import select_pbqp
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.launch import calibrate as cli

    out_dir.mkdir(parents=True, exist_ok=True)
    prof_path = out_dir / "alexnet_profile.json"
    prof_path.unlink(missing_ok=True)
    argv = ["--out", str(prof_path)] + CALIB_ARGS
    with open(out_dir / "calibrate.log", "w") as log:
        t0 = time.perf_counter()
        run_calibrate_cli(cli, argv, log)
        sweep_s = time.perf_counter() - t0
        prof = HardwareProfile.load(prof_path)
        default = (prof.reps, prof.min_time) == (3, 5e-3)
        print(f"  sweep wall time {sweep_s:.1f} s at reps={prof.reps}, "
              f"min_time={prof.min_time}"
              f"{' (the CLI default)' if default else ''}; log and profile "
              f"in {out_dir}")

        # every planned key, by the port's own plan
        scns = scenarios_from_net(NETWORKS[CALIB_NET](CALIB_SCALE),
                                  batches=CALIB_BATCHES)
        items = plan_sweep(scns, exclude_tags=(), kernels=True, device=dev)
        kinds = collections.Counter(it.kind for it in items)
        missing = [it.key for it in items if it.key not in prof]
        check(not missing and len(prof) == len(items),
              f"profile holds {len(prof)} entries for {len(items)} planned "
              f"keys; missing {missing[:5]}")
        print(f"  profile holds every planned key: {len(items)} "
              f"({dict(kinds)}), device {prof.device}")
        slow = sorted(prof.entries.items(), key=lambda kv: -kv[1])[:5]
        print("  slowest entries: " + ", ".join(
            f"{k} {v * 1e3:.3f} ms" for k, v in slow))

        # resumption: a second run on the same profile measures nothing
        text = run_calibrate_cli(cli, argv, log)
        m = re.search(r"^measured (\d+), skipped (\d+)", text, re.M)
        check(m is not None and int(m.group(1)) == 0
              and int(m.group(2)) == len(items),
              f"resumed sweep: {m.group(0) if m else text[-300:]}")

    # each kernel item is a path: exactly one launch of its own kernel
    kernel_keys = []
    for scn in scns:  # already bucketed
        for kname, entry in _kernel_benchmarks():
            builder = entry(scn, device=dev)
            if builder is None:
                continue
            fn, args = builder()
            sync(torch, dev)
            reset_launch_counts()
            fn(*args)
            sync(torch, dev)
            counts = launch_counts()
            paths[f"calibrate_{kname}_{scn.key()}"] = counts
            want = {kname: 1}
            if kname == "layout_transform":
                entry_ = "chw_to_hwc8" if scn.c % 8 == 0 else "chw_to_hwc"
                want = {f"layout_transform.{entry_}": 1}
            check(counts == want, f"kernel item {kname} @ {scn.key()}: "
                  f"launches {counts}, expected {want}")
            kernel_keys.append(f"kernel::{kname}::{scn.key()}")
    check(sorted(kernel_keys) == sorted(it.key for it in items
                                        if it.kind == "kernel"),
          "the kernel items run differ from the planned ones")
    per_pkg = collections.Counter(k.split("::")[1] for k in kernel_keys)
    print(f"  {len(kernel_keys)} kernel items, one launch each of their own "
          f"kernel: {dict(per_pkg)}")

    class Fallback(AnalyticCostModel):
        """``H100_SPEC``, recording what the profile leaves to it (fused
        edges fall back through ``transform_cost``)."""

        def __init__(self):
            super().__init__(H100_SPEC)
            self.seen = collections.Counter()

        def primitive_cost(self, prim, scn):
            self.seen[f"primitive {prim.name}"] += 1
            return super().primitive_cost(prim, scn)

        def transform_cost(self, src, dst, shape_chw, dtype):
            self.seen[f"transform {'x'.join(map(str, shape_chw))}"] += 1
            return super().transform_cost(src, dst, shape_chw, dtype)

    # selection on the measured profile, at batch 1 and 8
    for b in CALIB_BATCHES:
        fallback = Fallback()
        cost = CalibratedCostModel(prof, fallback=fallback, device=dev)
        nb = net if b == 1 else net.with_batch(b)
        csel = select_pbqp(nb, cost)
        prim_fb = [k for k in fallback.seen if k.startswith("primitive")]
        check(not prim_fb, f"primitive lookups fall back: {prim_fb[:5]}")
        print(f"  calibrated PBQP, batch {b}: optimal={csel.optimal}, "
              f"predicted {csel.predicted_cost * 1e3:.4f} ms, table_hits "
              f"{cost.table_hits}, fallback_hits {cost.fallback_hits} "
              f"(none for a primitive; {dict(fallback.seen)}), "
              f"{len(csel.conversions)} conversions")
        for nd in nb.conv_nodes():
            ch = csel.choices[nd.id]
            print(f"    {nd.id:6s} -> {ch.primitive.name} [{ch.l_in}->"
                  f"{ch.l_out}]")
        cnet = compile_plan(csel, params, batch=b, device=dev)
        x = inputs[b]
        run_path(f"calibrated_pbqp_alexnet_b{b}", cnet, x)
        agree(compile_plan(csel, params, batch=b, device=dev,
                           outputs=taps_)(x), sum2d[b],
              f"calibrated PBQP vs SUM2D, batch {b}")
        plans[f"calibrated PBQP, batch {b}"] = (b, cnet)
    print(f"  calibrated plans agree with SUM2D at batch 1 and 8 at "
          f"{len(taps_)} outputs (every conv and the logits)")
    for what, (b, cn) in plans.items():
        t = measure(cn, inputs[b], reps=20)
        print(f"  host clock, 20 forwards: {what}: mean "
              f"{t['mean_s'] * 1e3:.4f} ms (min {t['min_s'] * 1e3:.4f}, "
              f"std {t['std_s'] * 1e3:.4f})")

    # the device guard: a CPU profile must not price the card
    stale = HardwareProfile(device="cpu:cpu:n1", registry=registry_hash(),
                            entries=dict(prof.entries))
    try:
        CalibratedCostModel(stale, device=dev)
    except ValueError as e:
        print(f"  a profile stamped cpu:cpu:n1 is refused: {e}")
    else:
        check(False, "CalibratedCostModel took a CPU profile on the card")


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
    ptxas_phase(kernel_libs())

    # ---- 2. kernels against their plain versions ----
    print("== kernels (device ms per call: CUDA events over 20 queued "
          "calls, median of 5; bound = max(flops / 67e12, bytes / "
          "3.35e12)) ==")
    dev = torch.device("cuda")
    with true_f32():
        reports = (kernel_phase(torch, F) + layout_phase(torch, dev)
                   + attention_phase(torch, F, dev))
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

    # ---- 7. calibration on the card, and selection on its profile ----
    print("== calibration: python -m repro_torch.launch.calibrate "
          f"{' '.join(CALIB_ARGS)} ==")
    calibration_phase(
        torch, dev, ROOT / "build" / "calibration", run_path, paths,
        net, params, {1: x1, 8: x8},
        {1: {k: v[0] for k, v in base_t.items()}, 8: base_t}, t_,
        {"H100_SPEC PBQP, batch 1": (1, opt), "SUM2D, batch 1": (1, base),
         "H100_SPEC PBQP, batch 8": (8, opt8), "SUM2D, batch 8": (8, base8)})
    for r in reports:
        check(not r.on_path or any(c.get(r.name) for c in paths.values()),
              f"kernel {r.name} never launched on a path")

    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [r.entry(paths) for r in reports]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
