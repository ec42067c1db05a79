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
   agree with SUM2D; a CPU-stamped profile must be refused on the card;
8. serving: the conv ``PlanServer`` on AlexNet (exact buckets, the H100
   model with the kernels priced, ``jit=True``: each executable is a
   CUDA graph captured at its warm-up) answers 4 ``infer`` requests, an
   ``infer_batch`` of 8 and 5 queued requests in one ``flush``; every
   answer must hold the eager plan's bits and agree with SUM2D, each
   capture must count one launch per kernel conv (the Winograd kernel on
   conv3-conv5 at batch 1), a second server on the same cache directory
   must solve nothing, a NaN fault on the Winograd kernel must be
   quarantined and re-solved away with a correct answer, a failed
   compile retried, and the batch-2 and batch-4 buckets captured on the
   worker pool while the main thread serves; then per-request host
   latency (p50, p95) of ``jit=True`` against a ``jit=False`` server, in
   turns, and the profiler's device-busy time of one replayed forward;
9. tune: every valid configuration of the six kernels' launch spaces
   (``kernels/*/space.py``: tile and cluster split count, flash
   attention's query tile and KV split, the transpose's route) launched
   once with its pinned plan, which the C entry must receive, against
   its plain version; then ``python -m repro_torch.launch.tune`` (its
   ``main``) times every variant over phase 7's AlexNet buckets and
   ``autotune.tune`` resumes its profile with GoogLeNet's 1x1 buckets at
   batch 1; per kernel the catalog's generated, surviving and pruned
   counts, and per bucket the best variant against the planner's own
   launch; the catalog installed, AlexNet solved at batch 1 and 8 on
   phase 7's profile merged with the tune's, its plans (``jit=False``
   and ``jit=True``) against SUM2D and timed beside phase 7's
   calibrated plans; a ``PlanServer`` built after ``install()`` must
   miss the plan-cache key one built before hit; uninstalled after;
10. drift: ``obs.drift.recalibration_loop`` on AlexNet at batch 1 from a
   copy of phase 7's profile (threshold 2, 4 instrumented runs per round,
   at most 8 rounds, eager plans): every instrumented output must be its
   round's eager walk's bits, every round's plan must agree with SUM2D,
   and the profile's hash must change if and only if an entry was
   written; ``converged`` is printed, not gated.

Plans are compared at every conv's output, the pre-softmax logits and
the probabilities, each within 1e-3 of the reference's largest
magnitude (the probabilities also at the quickstart's 2e-3).

Every plan run in phases 3-7 is a path (eager, ``jit=False``): the
launch counts are set to 0 just before its one forward and read just
after, and must equal one launch per conv that its selection gave to
each kernel (the batch runs on the kernels' grids).  So is each
calibration kernel item: counts at 0, its benchmark function called
once, counts read.  Phase 8's requests are one path: counts at 0 before
the first request, read after the last, and they must equal each
executable's warm-up and replays (a capture records its launches and
counts none; each replay adds them).  Phase 9's tuning (the CLI's run and the
resumed ``tune``) is one path, ``tune``, which must launch every kernel;
its tuned plans are paths as phases 3-7's.  Phase 10's loop is one path,
``drift``: (1 + runs) forwards' launches per round.  The last lines are
a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
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
#: phase 8: timed requests per server and request kind (enough samples
#: for a p95 resolved between the 15th and 16th largest)
SERVE_REPS = 300
#: phase 9: the tuner's buckets are phase 7's (AlexNet at batch 1 and 8,
#: through the CLI), then GoogLeNet's 1x1 convs at batch 1 (the pointwise
#: GEMM's variants: AlexNet has no 1x1 conv); each item is timed with the
#: CLI's default discipline.  ``TUNE_BUDGET`` caps the new measurements
#: of each of the two runs (None: every planned item)
TUNE_SCALE, TUNE_MEASURE, TUNE_BUDGET = 1.0, "real", None
#: phase 9: device timings per candidate launch (one call behind a sleep
#: kernel, CUDA events), median of this many
WINNER_REPS = 7
#: phase 10: the recalibration loop's threshold (a ratio), instrumented
#: runs per round and most rounds
DRIFT_THRESHOLD, DRIFT_RUNS, DRIFT_ROUNDS = 2.0, 4, 8
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
    if isinstance(t, np.ndarray):
        return t.astype(np.float32, copy=False)
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

    eager_plan = functools.partial(compile_plan, jit=False)

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
        cnet = eager_plan(csel, params, batch=b, device=dev)
        x = inputs[b]
        run_path(f"calibrated_pbqp_alexnet_b{b}", cnet, x)
        agree(eager_plan(csel, params, batch=b, device=dev,
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
    return prof


def same_bits(got, want, what):
    """A served answer (numpy) holds the eager plan's bits."""
    for k in want:
        a, b = to_np(got[k]), to_np(want[k])
        check(a.shape == b.shape and np.array_equal(a, b),
              f"{what} {k}: the captured graph's output differs from the "
              f"eager plan's (max |diff| {np.abs(a - b).max():.3e})")


def percentiles(samples):
    ms = np.asarray(samples) * 1e3
    return (f"p50 {np.percentile(ms, 50):.4f} ms, p95 "
            f"{np.percentile(ms, 95):.4f} ms, mean {ms.mean():.4f} ms "
            f"({len(ms)} requests)")


def serving_phase(torch, dev, xs, sum2d_prob, paths):
    """Phase 8: the conv ``PlanServer`` on the card, its executables
    captured as CUDA graphs (``jit=True``).  ``xs``: the main path's
    eight 227 x 227 images (numpy); ``sum2d_prob``: SUM2D's
    probabilities for them (batch 8)."""
    import collections

    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import expected_launches
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.reliability import FaultInjector, parse_fault_plan
    from repro_torch.serving import BucketPolicy, PlanServer

    cost = AnalyticCostModel(H100_SPEC, include_kernels=True)
    policy = BucketPolicy(spatial="exact", channel="exact")
    shape = xs.shape[1:]
    params = alexnet(1.0).init_params(0)  # the servers' params_seed
    eager = {}

    def server(**kw):
        return PlanServer(lambda s: alexnet(1.0), cost, policy=policy,
                          device=dev, **kw)

    def eager_out(sel, x, n):
        """The eager plan of ``sel`` at batch ``n`` on images ``x``: one
        call per image at batch 1, else one call with zero rows padding
        the batch, as the server pads it."""
        key = (id(sel), n)
        if key not in eager:
            eager[key] = compile_plan(sel, params, batch=n, jit=False,
                                      device=dev)
        if n == 1:
            return [eager[key](xi) for xi in x]
        xb = np.zeros((n, *shape), np.float32)
        xb[:len(x)] = x
        out = eager[key](xb)
        return [{k: v[i] for k, v in out.items()} for i in range(len(x))]

    def held(srv, answers, rows, n, what):
        """Each answer holds the eager plan's bits and agrees with SUM2D."""
        sel = srv.plan_for(shape, n)
        for a, e, i in zip(answers, eager_out(sel, xs[rows], n), rows):
            same_bits(a, e, f"{what}, request {i}")
            agree({"prob": a["prob"]}, {"prob": sum2d_prob[i]},
                  f"{what} vs SUM2D, request {i}")

    def wino_convs(sel):
        return [nid for nid, c in sel.choices.items() if c.primitive
                and c.primitive.name.startswith("pallas_wino")]

    def check_capture(srv, n, what):
        cnet = srv.compiled_for(shape, n)
        want = expected_launches(cnet.sel)
        check(cnet.graph is not None and cnet.capture_launches == want,
              f"{what}: capture launches {cnet.capture_launches}, "
              f"expected {want}")
        return cnet

    # ---- requests: 4 single, one batch of 8, 5 queued + one flush ----
    cache = tempfile.TemporaryDirectory()
    srv = server(cache_dir=cache.name, lru_capacity=4)
    torch.cuda.synchronize()
    reset_launch_counts()
    single = [srv.infer(xs[i]) for i in range(4)]
    batch = srv.infer_batch(list(xs))
    futs = [srv.enqueue(xs[i]) for i in range(5)]
    check(srv.flush() == 5, "flush served another count than 5")
    queued = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    counts = launch_counts()
    paths["serve_alexnet"] = counts
    st = srv.stats()
    sels = {n: srv.plan_for(shape, n) for n in (1, 8)}
    # each executable launched its kernels in its eager warm-up and on
    # every replay (the capture records them and launches none): the
    # build's own call replays once, then batch 1 serves 4 requests and
    # batch 8 two calls (infer_batch, flush)
    replays = {1: 1 + 4, 8: 1 + 2}
    want = collections.Counter()
    for n, sel in sels.items():
        got = srv.compiled_for(shape, n).graph.replays
        check(got == replays[n], f"batch {n}: {got} replays, expected "
              f"{replays[n]}")
        for k, v in expected_launches(sel).items():
            want[k] += (1 + replays[n]) * v
    check(counts == dict(want), f"serving path: launches {counts}, "
          f"expected warm-up + replays of each executable {dict(want)}")
    check(st["compiles"] == 2 and st["batch_calls"] == 2 and
          st["coalesced"] == 11 and st["requests"] == 17,
          f"serving counters {st}")
    wc = wino_convs(sels[1])
    check(wc == ["conv3", "conv4", "conv5"], f"batch 1: the Winograd kernel "
          f"runs on {wc}, expected conv3-conv5")
    for n, sel in sels.items():
        cnet = check_capture(srv, n, f"batch {n}")
        picks = [(nid, c.primitive.name) for nid, c in sel.choices.items()
                 if c.primitive]
        print(f"  batch {n}: plan {picks}; capture launches "
              f"{cnet.capture_launches}")
    print(f"  path serve_alexnet (4 infer, infer_batch of 8, 5 queued + "
          f"flush): launches {counts} = warm-up + {replays[1]} replays "
          f"of the batch-1 executable, warm-up + {replays[8]} of the "
          f"batch-8 one")
    held(srv, single, list(range(4)), 1, "infer")
    held(srv, batch, list(range(8)), 8, "infer_batch")
    held(srv, queued, list(range(5)), 8, "enqueue + flush")
    print("  every answer holds the eager plan's bits and agrees with "
          f"SUM2D within {NET_REL}; counters: "
          + ", ".join(f"{k}={st[k]}" for k in (
              "requests", "solves", "compiles", "exec_hits", "batch_calls",
              "coalesced", "plan_misses"))
          + f"; solve {st['solve_s']:.3f} s, compile (packing, warm-up "
          f"and capture) {st['compile_s']:.3f} s, for both buckets")

    # ---- the plan cache: a second server reads the plans from disk ----
    srv2 = server(cache_dir=cache.name, lru_capacity=4)
    again = [srv2.infer(xs[0])] + srv2.infer_batch(list(xs))
    st2 = srv2.stats()
    check(st2["solves"] == 0 and st2["plan_disk_hits"] == 2,
          f"second server on the cache: {st2}")
    for a, b in zip(again, [single[0]] + batch):
        same_bits(a, b, "second server")
    print(f"  second server on the same cache_dir: solves={st2['solves']}, "
          f"plan_disk_hits={st2['plan_disk_hits']}, same bits")
    del srv2

    # ---- faults: NaN from the Winograd kernel, a failed compile ----
    inj = FaultInjector(parse_fault_plan(
        "compile:raise@0+1,kernel:nan@0+0~pallas_wino"), seed=0)
    fsrv = server(fault_injector=inj, kernel_retries=2,
                  compile_backoff_s=0.01)
    out = fsrv.infer(xs[0])
    fst = fsrv.stats()
    fsel = fsrv.plan_for(shape)
    check(fst["compile_retries"] >= 1, f"no compile retry: {fst}")
    check(fst["quarantines"] >= 1 and not wino_convs(fsel) and
          "winograd_gemm" not in expected_launches(fsel),
          f"the quarantine left the Winograd kernel in the plan: {fst}")
    check_capture(fsrv, 1, "after the quarantine")
    held(fsrv, [out], [0], 1, "after the quarantine")
    picks = [(nid, fsel.choices[nid].primitive.name)
             for nid in ("conv3", "conv4", "conv5")]
    print(f"  faults (compile:raise@0+1, kernel:nan~pallas_wino): "
          f"quarantined {fst['quarantined']}; re-solved without K3: "
          f"{picks}; answer correct; counters: " + ", ".join(
              f"{k}={fst[k]}" for k in (
                  "compile_retries", "compile_fallbacks", "kernel_failures",
                  "quarantines", "solves", "compiles", "ladder_exact")))
    del fsrv

    # ---- concurrency: prefetch batch 2 and 4, serve batch 1 meanwhile ----
    f2, f4 = srv.prefetch(shape, n=2), srv.prefetch(shape, n=4)
    served, during = [], 0
    while len(served) < 4 or not (f2.done() and f4.done()):
        i = len(served) % 8
        busy = not (f2.done() and f4.done())
        served.append((i, srv.infer(xs[i])))
        during += busy
    f2.result(timeout=600), f4.result(timeout=600)
    ref1 = eager_out(srv.plan_for(shape), xs, 1)
    for i, a in served:
        same_bits(a, ref1[i], f"infer during prefetch, request {i}")
        agree({"prob": a["prob"]}, {"prob": sum2d_prob[i]},
              f"infer during prefetch vs SUM2D, request {i}")
    for n in (2, 4):
        check_capture(srv, n, f"prefetched batch {n}")
        held(srv, srv.infer_batch(list(xs[:n])), list(range(n)), n,
             f"prefetched batch {n}")
    print(f"  prefetch of batch 2 and 4 on the worker pool while the main "
          f"thread served {len(served)} requests at batch 1 ({during} "
          f"while a capture ran): every answer correct")

    # ---- times: jit=True against a jit=False server, in turns ----
    esrv = server(jit=False, lru_capacity=4)
    reqs = {"infer, batch 1": lambda s: s.infer(xs[0]),
            "infer_batch, batch 8": lambda s: s.infer_batch(list(xs))}
    for fn in reqs.values():
        for s in (srv, esrv):
            fn(s)
    held(esrv, [esrv.infer(xs[0])], [0], 1, "jit=False server")
    lat = {(w, j): [] for w in reqs for j in ("jit=True", "jit=False")}
    for rep in range(SERVE_REPS):
        for what, fn in reqs.items():
            order = ((srv, "jit=True"), (esrv, "jit=False"))
            for s, j in (order if rep % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(s)
                lat[(what, j)].append(time.perf_counter() - t0)
    card = gpu_line()
    for (what, j), samples in lat.items():
        print(f"  host clock per request, {what}, {j}: "
              f"{percentiles(samples)} [{card}]")
    for j, s in (("jit=True", srv), ("jit=False", esrv)):
        ph = s.stats()["phases"]
        print(f"  {j}: the server's execute phase (executable call, copy "
              "back, finiteness guard) per bucket, p50 interpolated in the "
              "registry's histogram buckets: " + ", ".join(
                  f"{k[len('execute['):-1]} {v['p50'] * 1e3:.4f} ms"
                  for k, v in sorted(ph.items())
                  if k.startswith("execute[")))
    wall, busy, _ = device_profile(torch, lambda: srv.infer(xs[0]))
    print(f"  profile, one served infer at batch 1 (jit=True): wall "
          f"{wall:.4f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'} [{card}]")
    x1 = torch.from_numpy(xs[0]).to(dev)
    for what, cn in (("replayed graph", srv.compiled_for(shape)),
                     ("eager walk", esrv.compiled_for(shape))):
        wall, busy, top = device_profile(torch, lambda: cn(x1))
        share = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / wall):.4f}"
        print(f"  profile, one batch-1 forward, {what}: wall {wall:.4f} ms, "
              f"device busy "
              f"{'not measured' if busy is None else f'{busy:.4f} ms'}, "
              f"idle share {share} [{card}]")
        for t, key in top[:5]:
            print(f"    {t:9.4f} ms  {key[:90]}")
        host = []
        for _ in range(SERVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cn(x1)
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
        print(f"  one batch-1 forward, {what}, outside the server: device "
              f"span {cuda_ms(torch, lambda: cn(x1)):.4f} ms per call (CUDA "
              f"events over 20 queued calls), host clock to synchronize "
              f"{percentiles(host)} [{card}]")
    srv.close()
    esrv.close()
    cache.cleanup()


def tune_args():
    """Phase 9's arguments of ``repro_torch.launch.tune`` (its catalog and
    profile paths aside)."""
    return (["--net", CALIB_NET, "--scale", str(TUNE_SCALE), "--batches",
             *map(str, CALIB_BATCHES), "--measure", TUNE_MEASURE]
            + ([] if TUNE_BUDGET is None else ["--budget", str(TUNE_BUDGET)]))


class LaunchSpy:
    """Records every C entry's arguments while active: the pinned tile
    and split count (the query tile and KV split, the route) a wrapper
    passed down are the launch the card ran."""

    def __init__(self):
        from repro_torch.kernels.common import KernelLib
        self.cls, self.calls = KernelLib, []

    def __enter__(self):
        orig, calls = self.cls.call, self.calls

        def call(lib, entry, *args):
            calls.append((entry, args))
            return orig(lib, entry, *args)
        self.orig = orig
        self.cls.call = call
        return self

    def __exit__(self, *exc):
        self.cls.call = self.orig

    def launched(self, pos):
        """The values at argument positions ``pos`` of the last call."""
        _, args = self.calls[-1]
        return tuple(args[i] for i in pos)


def pinned_configs_phase(torch, dev, buckets):
    """Every valid configuration of all six spaces, launched once with
    its pinned plan at the first tuning bucket it applies to (batch 1
    first), against the plain version: a registering space's variant
    against its entry's plain version on the CPU, flash attention's
    launches against its plain version on the card, the layout
    transform's routes bit for bit."""
    from repro_torch.autotune import spaces
    from repro_torch.core.costs import MeasureCache
    from repro_torch.core.layouts import LAYOUT_BY_NAME
    from repro_torch.core.primitives import to_tensor
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels.flash_attention import flash_attention_ref

    cache, plain = MeasureCache(), {}
    order = sorted(buckets, key=lambda b: b.n)
    #: where each C entry receives the pinned launch
    gemm_pos = {"repro_conv_direct": (-5, -4)}
    n_checked = {}
    for kname, space in sorted(spaces().items()):
        for cfg in space.configs():
            if space.registers:
                prim = space.make_primitive(cfg)
                scn = next((b for b in order if prim.supports(b)), None)
                check(scn is not None, f"{prim.name} supports no bucket")
                entry = prim.name.split("@")[0]
                w, b, x = cache.draws(scn)
                lay = LAYOUT_BY_NAME[prim.l_in]
                xm = lay.to_memory(x) if scn.n == 1 else \
                    np.stack([lay.to_memory(xi) for xi in x])
                packed = prim.prepare(scn, w.copy(), b.copy())
                if (entry, scn) not in plain:
                    cpu = {k: to_tensor(v) for k, v in packed.items()}
                    plain[(entry, scn)] = prim.make(scn)(to_tensor(xm), cpu)
                with LaunchSpy() as spy:
                    got = prim.make(scn)(
                        to_tensor(xm).to(dev),
                        {k: to_tensor(v).to(dev) for k, v in packed.items()})
                    torch.cuda.synchronize()
                    pos = gemm_pos.get(spy.calls[-1][0], (-6, -5))
                    launched = spy.launched(pos)
                check(launched == (cfg["tile"], cfg["splits"]),
                      f"{prim.name} at {scn.key()} launched tile and "
                      f"splits {launched}")
                want = plain[(entry, scn)]
                err = float((got.cpu() - want).abs().max())
                scale = float(want.abs().max())
                check(bool(got.isfinite().all())
                      and err <= TOL_F32 * scale,
                      f"{prim.name} at {scn.key()}: max error {err:.3e} > "
                      f"{TOL_F32} x {scale:.3e}")
            else:
                # a route that runs at no tuning bucket (K5's short
                # columns: every bucket has H*W > 16) at a shape it runs
                scn = next((b for b in order
                            if space.benchmark(b, cfg, device=dev)),
                           Scenario(c=64, h=4, w=4, stride=1, k=3, m=8))
                fn, args = space.benchmark(scn, cfg, device=dev)()
                with LaunchSpy() as spy:
                    got = fn(*args)
                    torch.cuda.synchronize()
                    if kname == "flash_attention":
                        launched = spy.launched((-3, -2))
                        pin = (cfg["bq"], cfg["splits"])
                    else:
                        launched, pin = spy.launched((-2,)), (cfg["route"],)
                check(launched == pin, f"{kname} {cfg} launched {launched}")
                if kname == "flash_attention":
                    q, k, v = args
                    want = flash_attention_ref(q, k, v, scale=64 ** -0.5)
                    err = float((got - want).abs().max())
                    check(err <= TOL_ATTN * float(want.abs().max()),
                          f"flash attention {cfg} at {scn.key()}: max "
                          f"error {err:.3e}")
                else:
                    x, = args
                    c = x.shape[0]
                    want = x.permute(1, 2, 0).contiguous()
                    if c % 8 == 0:
                        want = want.unflatten(-1, (c // 8, 8))
                    check(got.equal(want), f"layout transform {cfg} at "
                          f"{scn.key()}: not bit-exact")
            n_checked[kname] = n_checked.get(kname, 0) + 1
    print("  every valid configuration launched once with its pinned plan "
          f"(tile and splits, BQ and S, route as the C entry received "
          f"them) and held against its plain version (TOL_F32 "
          f"{TOL_F32}, TOL_ATTN {TOL_ATTN}, the routes bit for bit): "
          f"{n_checked}")


def winners_report(torch, dev, prof, cat, buckets):
    """Phase 9's answer to the planners' question.  Per kernel and bucket:
    the host-clock times the tuner measured (``time_callable``: the
    planner's own launch, which is the hand-written entry, or for K5 and
    K6 the configuration the planner picks; the same launch pinned by a
    variant, which gives the spread; the fastest variant), then each
    candidate's device time (CUDA events around one call behind a sleep
    kernel, median of ``WINNER_REPS``): whether the planner's launch is
    the device's best, by how much it misses, and what the host-clock
    winner costs on the device."""
    import collections

    from repro_torch.autotune import spaces
    from repro_torch.autotune.measure import _space_of, kernel_variant_key
    from repro_torch.core.costs import MeasureCache, prim_cost_key
    from repro_torch.core.layouts import LAYOUT_BY_NAME
    from repro_torch.core.primitives import build_registry, to_tensor

    cache = MeasureCache()
    sp = spaces()
    pos = {"repro_conv_direct": (-5, -4)}
    #: per kernel: host (planner - host best), host spread, device
    #: (planner - device best), device (planner - host best)
    stats = collections.defaultdict(lambda: collections.defaultdict(list))
    card = gpu_line()

    def dev_ms(fn):
        return cuda_ms(torch, fn, reps=WINNER_REPS, inner=1)

    def call_of(prim, scn):
        w, b, x = cache.draws(scn)
        lay = LAYOUT_BY_NAME[prim.l_in]
        xm = lay.to_memory(x) if scn.n == 1 else \
            np.stack([lay.to_memory(xi) for xi in x])
        xin = to_tensor(xm).to(dev)
        packed = {k: to_tensor(v).to(dev)
                  for k, v in prim.prepare(scn, w.copy(), b.copy()).items()}
        f = prim.make(scn)
        return lambda: f(xin, packed)

    def record(kname, scn, own_name, own, host, same, device):
        """``host``/``device``: candidate name -> host s / device ms, the
        planner's launch under ``own_name``."""
        hbest = min(host, key=host.get)
        dbest = min(device, key=device.get)
        st = stats[kname]
        st["host"].append(own - host[hbest])
        if same is not None:
            st["spread"].append(abs(own - same))
        st["dev_miss"].append((device[own_name] - device[dbest]) * 1e-3)
        st["dev_host_best"].append((device[own_name] - device[hbest]) * 1e-3)
        print(f"    {kname:20s} {scn.key():34s} planner {own_name}: host "
              f"{own * 1e3:.4f} ms"
              + ("" if same is None else f" (pinned again {same * 1e3:.4f})")
              + f", device {device[own_name]:.4f} ms; host best {hbest} "
              f"{host[hbest] * 1e3:.4f} ms, device {device[hbest]:.4f} ms; "
              f"device best {dbest} {device[dbest]:.4f} ms")

    for entry in (p for p in build_registry() if p.family == "pallas"):
        space = _space_of(entry.name).SPACE
        m_ = {"m_": int(entry.name[len("pallas_wino_f")])} \
            if space.kernel == "winograd_gemm" else {}
        for scn in buckets:
            own = prof.get(prim_cost_key(entry.name, scn))
            if own is None:
                continue
            names = [n for n, e in cat.variants.items()
                     if n.split("@")[0] == entry.name
                     and scn.key() in e["costs"]]
            host = {n.split("@")[1]: cat.variants[n]["costs"][scn.key()]
                    for n in names}
            run = call_of(entry, scn)
            with LaunchSpy() as spy:
                run()
                torch.cuda.synchronize()
                tile, splits = spy.launched(pos.get(spy.calls[-1][0],
                                                    (-6, -5)))
            own_name = f"tile{tile}_splits{splits}"
            same = host.get(own_name)
            device = {n.split("@")[1]: dev_ms(call_of(space.make_primitive(
                {**m_, **cat.variants[n]["params"]}), scn)) for n in names}
            device[own_name] = dev_ms(run)  # the entry: the planner's
            host[own_name] = own
            record(entry.name, scn, own_name, own, host, same, device)
    for kname in ("flash_attention", "layout_transform"):
        space = sp[kname]
        mod = sys.modules[f"repro_torch.kernels.{kname}.space"]
        for scn in buckets:
            own_p = mod.planner_params(scn)
            if own_p is None:
                continue
            host, device = {}, {}
            for cfg in space.configs():
                sec = prof.get(kernel_variant_key(space, cfg, scn))
                if sec is None:
                    continue
                name = "_".join(f"{k}{v}" for k, v in cfg.items())
                fn, args = space.benchmark(scn, cfg, device=dev)()
                host[name] = sec
                device[name] = dev_ms(lambda: fn(*args))
            own_name = "_".join(f"{k}{v}" for k, v in own_p.items())
            if own_name in host:
                record(kname, scn, own_name, host[own_name], host, None,
                       device)
    for k in sorted(stats):
        st = stats[k]
        g, dm, dh = st["host"], st["dev_miss"], st["dev_host_best"]
        print(f"  {k}: host clock, a variant under the planner's launch at "
              f"{sum(x > 0 for x in g)} of {len(g)} buckets, by up to "
              f"{max(g) * 1e6:.2f} us (median {np.median(g) * 1e6:+.2f} us)"
              + ("" if not st["spread"] else
                 f"; the planner's launch timed twice differs by a median "
                 f"{np.median(st['spread']) * 1e6:.2f} us, at most "
                 f"{max(st['spread']) * 1e6:.2f} us")
              + f"; device (CUDA events): the planner's launch the best at "
              f"{sum(x <= 0 for x in dm)} of {len(dm)} buckets, missing it "
              f"by a median {np.median(dm) * 1e6:.2f} us, at most "
              f"{max(dm) * 1e6:.2f} us; the host's winner under the "
              f"planner's launch at {sum(x > 0 for x in dh)} buckets, over "
              f"it by a median {-np.median(dh) * 1e6:+.2f} us [{card}]")


def tune_phase(torch, dev, out_dir, run_path, paths, net, params, inputs,
               sum2d, taps_, calib_prof, untuned):
    """Phase 9: the tuner on the card.  Every pinned configuration
    against its plain version; ``repro_torch.launch.tune`` over phase 7's
    AlexNet buckets, resumed by ``tune`` with GoogLeNet's 1x1 buckets
    (one path, ``tune``); per kernel the catalog's counts and each
    bucket's winner against the planner's own launch; the catalog
    installed and AlexNet solved over the widened registry on phase 7's
    profile merged with the tune's, its plans (``jit=False`` and
    ``jit=True``) against SUM2D and timed beside ``untuned`` (batch ->
    phase 7's calibrated eager plan); a ``PlanServer`` built after
    ``install()`` misses where one built before hit; uninstall."""
    import collections
    import contextlib
    import io

    from repro_torch.autotune import VariantCatalog, tune
    from repro_torch.calibrate import (CalibratedCostModel, HardwareProfile,
                                       scenarios_from_net)
    from repro_torch.convnets import NETWORKS, googlenet
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.plan import compile_plan, measure
    from repro_torch.core.primitives import registry
    from repro_torch.core.selection import select_pbqp
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.launch import tune as cli
    from repro_torch.serving import BucketPolicy, PlanServer

    alex = scenarios_from_net(NETWORKS[CALIB_NET](TUNE_SCALE),
                              batches=CALIB_BATCHES)
    pw = [s for s in scenarios_from_net(googlenet(TUNE_SCALE)) if s.k == 1]
    buckets = alex + pw
    pinned_configs_phase(torch, dev, buckets)

    # ---- the tuning path: the CLI over AlexNet, tune() adds GoogLeNet ----
    out_dir.mkdir(parents=True, exist_ok=True)
    cat_path = out_dir / "alexnet_catalog.json"
    prof_path = cat_path.with_suffix(".profile.json")
    for p in (cat_path, prof_path):
        p.unlink(missing_ok=True)
    argv = ["--catalog", str(cat_path), "--device", dev.type] + tune_args()
    sync(torch, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with open(out_dir / "tune.log", "w") as log:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        log.write(f"$ tune {' '.join(argv)}\n{buf.getvalue()}")
        check(rc == 0, f"tune {argv} exited {rc}")
        for line in buf.getvalue().splitlines():
            if line.startswith(("tune plan", "measured ", "catalog: ")):
                print(f"  {line}")
        cli_s = time.perf_counter() - t0
        prof = HardwareProfile.load(prof_path)
        n_cli = len(prof)
        res = tune(buckets, measure_mode=TUNE_MEASURE, profile=prof,
                   profile_path=prof_path, budget=TUNE_BUDGET, device=dev)
        sync(torch, dev)
        tune_s = time.perf_counter() - t0
        res.catalog.save(cat_path)
        log.write(f"tune(+ GoogLeNet 1x1 at batch 1): {res.sweep}\n")
    paths["tune"] = counts = launch_counts()
    cat = res.catalog
    check(res.sweep["remaining"] == 0 or TUNE_BUDGET is not None,
          f"tune left items: {res.sweep}")
    check(res.sweep["skipped"] == n_cli, f"tune() did not resume the CLI's "
          f"{n_cli} entries: {res.sweep}")
    print(f"  path tune: the CLI measured {n_cli} items over {len(alex)} "
          f"AlexNet buckets in {cli_s:.1f} s; tune() resumed them and "
          f"measured {res.sweep['measured']} more over {len(pw)} GoogLeNet "
          f"1x1 buckets; {tune_s:.1f} s in all [{gpu_line()}]; launches "
          f"{counts}")
    for k in ("matmul", "conv_im2col", "winograd_gemm", "conv_direct",
              "flash_attention"):
        check(counts.get(k, 0) > 0, f"the tune path launched no {k}")
    check(any(k.startswith("layout_transform.") for k in counts),
          "the tune path launched no layout transform")

    # ---- per kernel: the catalog, and each bucket's winner ----
    by_kernel = collections.defaultdict(lambda: [0, 0])
    for name, e in cat.variants.items():
        by_kernel[e["kernel"]][0] += 1
        by_kernel[e["kernel"]][1] += name in cat.survivors()
    for k, (gen, surv) in sorted(by_kernel.items()):
        print(f"  {k:14s} generated {gen:3d}, surviving {surv:3d}, pruned "
              f"{gen - surv:3d}")
    print(f"  catalog: {res.generated} generated, {res.surviving} "
          f"surviving, {res.pruned} pruned, {len(cat.kernels)} kernel-only "
          f"winners, content {cat.content_hash()} -> {cat_path}")
    winners_report(torch, dev, prof, cat, buckets)

    # ---- install; solve over the widened registry ----
    n0 = len(registry())
    policy = BucketPolicy(spatial="exact", channel="exact")
    shape = net.nodes["data"].out_shape
    cache = tempfile.TemporaryDirectory()
    scost = AnalyticCostModel(H100_SPEC, include_kernels=True)

    def plan_server():
        return PlanServer(lambda s: net, scost, policy=policy, device=dev,
                          cache_dir=cache.name)

    before = [plan_server() for _ in range(2)]
    for srv in before:
        srv.plan_for(shape)
    installed = cat.install()
    check(len(registry()) == n0 + installed and installed == res.surviving,
          f"install registered {installed}, the registry grew by "
          f"{len(registry()) - n0}")
    merged = HardwareProfile(device=calib_prof.device,
                             registry=calib_prof.registry,
                             entries={**calib_prof.entries, **prof.entries})
    cost = CalibratedCostModel(merged, fallback=AnalyticCostModel(H100_SPEC),
                               device=dev)
    card = gpu_line()
    for b in CALIB_BATCHES:
        nb = net if b == 1 else net.with_batch(b)
        tsel = select_pbqp(nb, cost)
        picks = {nd.id: tsel.choices[nd.id].primitive.name
                 for nd in nb.conv_nodes()}
        tuned = {k: v for k, v in picks.items() if "@" in v}
        print(f"  tuned PBQP, batch {b}: predicted "
              f"{tsel.predicted_cost * 1e3:.4f} ms; picks {picks}; "
              f"variants picked: {tuned or 'none'}")
        eager = compile_plan(tsel, params, batch=b, jit=False, device=dev)
        run_path(f"tuned_pbqp_alexnet_b{b}", eager, inputs[b])
        for jit in (False, True):
            agree(compile_plan(tsel, params, batch=b, jit=jit, device=dev,
                               outputs=taps_)(inputs[b]), sum2d[b],
                  f"tuned PBQP (jit={jit}) vs SUM2D, batch {b}")
        times = {}
        for what, cn in (("un-tuned", untuned[b]), ("tuned", eager),
                         ("tuned ", eager), ("un-tuned ", untuned[b])):
            t = measure(cn, inputs[b], reps=20)["mean_s"]
            times.setdefault(what.strip(), []).append(t)
        print(f"  batch {b}: tuned and un-tuned calibrated plans agree with "
              f"SUM2D (jit=False and jit=True); host clock, 20 eager "
              "forwards, in turns: " + ", ".join(
                  f"{k} {np.mean(v) * 1e3:.4f} ms" for k, v in times.items())
              + f" [{card}]")

    # ---- the plan cache: a server built after install() misses ----
    after = plan_server()
    after.plan_for(shape)
    hit = before[1].stats()["plan_disk_hits"]
    st = after.stats()
    check(hit == 1 and st["plan_disk_hits"] == 0 and st["plan_misses"] == 1,
          f"plan cache across install(): before {hit} disk hit(s), after "
          f"{st}")
    check(after.cost_version != before[0].cost_version,
          "install() left the server's cost version")
    print(f"  PlanServer on one cache_dir: built before install() it hit "
          f"the disk ({hit}); built after it missed "
          f"(plan_misses={st['plan_misses']}, plan_disk_hits="
          f"{st['plan_disk_hits']}): the extension token rotated its key")
    for srv in before + [after]:
        srv.close()
    cache.cleanup()
    check(VariantCatalog.uninstall() and len(registry()) == n0,
          "uninstall left variants in the registry")


class RecordingProfile:
    """Mixin over ``HardwareProfile``: the keys ``put`` wrote."""

    def put(self, key, seconds):
        self.__dict__.setdefault("written", []).append(key)
        super().put(key, seconds)


def drift_phase(torch, dev, paths, net, params, x1, sum2d1, taps_,
                calib_prof):
    """Phase 10: ``recalibration_loop`` on AlexNet at batch 1 from a copy
    of phase 7's profile.  One path, ``drift``: counts at 0 before the
    loop, read after; each round launches one forward's kernels per
    instrumented run and its warm-up.  Each round's instrumented outputs
    must be its eager walk's bits, and its plan must agree with SUM2D."""
    from repro_torch.calibrate import HardwareProfile
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import expected_launches
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.obs import drift

    class Profile(RecordingProfile, HardwareProfile):
        pass

    class Recorded(drift.InstrumentedNet):
        """The loop's instrumented nets, one per round, and their runs'
        outputs."""
        made = []

        def __init__(self, cnet, warmup=True):
            self.outs = []
            Recorded.made.append(self)
            super().__init__(cnet, warmup)

        def __call__(self, x):
            outs, tm = super().__call__(x)
            self.outs.append(outs)
            return outs, tm

    prof = Profile.from_payload(calib_prof.to_payload())
    h0 = prof.content_hash()
    sync(torch, dev)
    reset_launch_counts()
    orig, drift.InstrumentedNet = drift.InstrumentedNet, Recorded
    try:
        t0 = time.perf_counter()
        res = drift.recalibration_loop(
            net, params, x1, prof, threshold=DRIFT_THRESHOLD,
            runs=DRIFT_RUNS, max_rounds=DRIFT_ROUNDS,
            fallback=AnalyticCostModel(H100_SPEC), device=dev)
        sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        drift.InstrumentedNet = orig
    paths["drift"] = counts = launch_counts()
    rounds = res["rounds"]
    check(0 < len(rounds) <= DRIFT_ROUNDS and len(Recorded.made) ==
          len(rounds), f"{len(rounds)} rounds, {len(Recorded.made)} "
          f"instrumented nets, at most {DRIFT_ROUNDS}")
    want = {}
    for rnd, inst in zip(rounds, Recorded.made):
        sel = inst.cnet.sel
        check({n.id: sel.choices[n.id].primitive.name
               for n in net.conv_nodes()} == rnd["primitives"],
              f"round {rnd['round']}: recorded plan differs")
        # the warm-up call is recorded too: 1 + DRIFT_RUNS forwards
        check(len(inst.outs) == 1 + DRIFT_RUNS,
              f"round {rnd['round']}: {len(inst.outs)} instrumented calls")
        eager = inst.cnet(x1)
        for outs in inst.outs[1:]:
            for k in eager:
                check(outs[k].equal(eager[k]), f"round {rnd['round']}: the "
                      f"instrumented {k} differs from the eager walk's")
        agree(compile_plan(sel, params, jit=False, device=dev,
                           outputs=taps_)(x1), sum2d1,
              f"drift round {rnd['round']} vs SUM2D")
        for k, v in expected_launches(sel).items():
            want[k] = want.get(k, 0) + (1 + DRIFT_RUNS) * v
        print(f"  round {rnd['round']}: plan ratio {rnd['plan_ratio']:.4f}, "
              f"predicted {rnd['predicted_cost'] * 1e3:.4f} ms, flagged "
              f"{rnd['flagged']}; picks {rnd['primitives']}")
    check(counts == want, f"drift path: launches {counts}, expected "
          f"(1 + {DRIFT_RUNS}) forwards per round {want}")
    written = prof.__dict__.get("written", [])
    check((prof.content_hash() != h0) == bool(written),
          f"profile hash {'moved' if prof.content_hash() != h0 else 'kept'}"
          f" with {len(written)} entries written")
    det = res["detector"]
    print(f"  {len(rounds)} round(s) in {wall:.1f} s; converged="
          f"{res['converged']}; plan ratio {det.plan_ratio():.4f}; "
          f"{len(written)} profile entries rewritten "
          f"({sorted(set(written))[:6]}{' ...' if len(set(written)) > 6 else ''}"
          f"); profile hash {h0} -> {prof.content_hash()}; path drift: "
          f"launches {counts}; every instrumented output the eager walk's "
          f"bits, every round's plan agrees with SUM2D [{gpu_line()}]")
    for row in det.report()[:8]:
        print(f"    {row['kind']:4s} {row['node']:14s} {row['primitive']:26s} "
              f"predicted {row['predicted_ms']:.4f} ms observed "
              f"{row['observed_ms']:.4f} ms ratio {row['ratio']:.3f}"
              f"{' flagged' if row['flagged'] else ''}")


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
    from repro_torch.kernels import expected_launches, kernel_libs
    from repro_torch.kernels.common import (build_all, launch_counts,
                                            reset_launch_counts, true_f32)

    # phases 3-7 run the eager walk: one host dispatch per operator, the
    # paper's additive per-layer costs; phase 8 serves captured graphs
    eager_plan = functools.partial(compile_plan, jit=False)

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
    opt, base = eager_plan(sel, params), eager_plan(base_sel, params)
    opt8 = eager_plan(sel, params, batch=8)
    base8 = eager_plan(base_sel, params, batch=8)
    x1, x8 = (torch.from_numpy(a).to(opt.device) for a in (xs[0], xs))
    out = to_np(run_path("pbqp_alexnet_b1", opt, x1)["prob"])
    check(out.shape == (1000, 1, 1) and abs(out.sum() - 1.0) < 1e-3,
          f"AlexNet output {out.shape} sums to {out.sum()}")
    run_path("pbqp_alexnet_b8", opt8, x8)
    t_ = taps(net)
    base_t = eager_plan(base_sel, params, batch=8, outputs=t_)(x8)
    opt_t = eager_plan(sel, params, batch=8, outputs=t_)(x8)
    agree(opt_t, base_t, "PBQP vs SUM2D, batch 8")
    agree(eager_plan(sel, params, outputs=t_)(x1),
          {k: v[0] for k, v in base_t.items()}, "PBQP vs SUM2D, batch 1")
    agree(eager_plan(sel, params, outputs=t_)(x1),
          eager_plan(sel, params, device="cpu", outputs=t_)(xs[0]),
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
            sum2d_outs[n_.name] = eager_plan(
                select_sum2d(n_, cost), p_, batch=2, outputs=taps(n_))(x_)
        want = sum2d_outs[n_.name]
        psel = select_fixed(n_, cost, pick, f"pinned_{prim.name}")
        run_path(f"pinned_{prim.name}_b2",
                 eager_plan(psel, p_, batch=2), x_)
        run_path(f"pinned_{prim.name}_b1", eager_plan(psel, p_), x_[0])
        agree(eager_plan(psel, p_, batch=2, outputs=taps(n_))(x_), want,
              f"{prim.name} pinned on {n_.name}, batch 2")
        agree(eager_plan(psel, p_, outputs=taps(n_))(x_[0]),
              {k: v[0] for k, v in want.items()},
              f"{prim.name} pinned on {n_.name}, batch 1")
        print(f"  {prim.name:22s} on {len(pick):2d} convs of {n_.name}: "
              f"agrees with SUM2D at batch 2 and 1")
    # ---- 5. fused selection on GoogLeNet ----
    fsel = select_pbqp(gnet, cost, fuse=True)
    run_path("fused_pbqp_googlenet_b2", eager_plan(fsel, gparams, batch=2),
             gxs)
    agree(eager_plan(fsel, gparams, batch=2, outputs=taps(gnet))(gxs),
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
    run_path("profiled_pbqp_alexnet_b1", eager_plan(psel, params), x1)
    agree(eager_plan(psel, params, outputs=t_)(x1),
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
    calib_plans = {"H100_SPEC PBQP, batch 1": (1, opt),
                   "SUM2D, batch 1": (1, base),
                   "H100_SPEC PBQP, batch 8": (8, opt8),
                   "SUM2D, batch 8": (8, base8)}
    calib_prof = calibration_phase(
        torch, dev, ROOT / "build" / "calibration", run_path, paths,
        net, params, {1: x1, 8: x8},
        {1: {k: v[0] for k, v in base_t.items()}, 8: base_t}, t_,
        calib_plans)
    # ---- 8. the conv PlanServer, serving captured CUDA graphs ----
    print("== serving: PlanServer(alexnet(1.0), H100_SPEC with kernels, "
          "exact buckets), jit=True on the card ==")
    serving_phase(torch, dev, xs, base_t["prob"], paths)
    # ---- 9. the autotuner over the kernels' launch plans ----
    print("== tune: python -m repro_torch.launch.tune "
          f"{' '.join(tune_args())}, then GoogLeNet's 1x1 buckets ==")
    sum2d = {1: {k: v[0] for k, v in base_t.items()}, 8: base_t}
    tune_phase(torch, dev, ROOT / "build" / "tune", run_path, paths, net,
               params, {1: x1, 8: x8}, sum2d, t_, calib_prof,
               {b: calib_plans[f"calibrated PBQP, batch {b}"][1]
                for b in CALIB_BATCHES})
    # ---- 10. drift: the recalibration loop on the card ----
    print(f"== drift: recalibration_loop({net.name}, batch 1, phase 7's "
          f"profile, threshold {DRIFT_THRESHOLD}, runs {DRIFT_RUNS}) ==")
    drift_phase(torch, dev, paths, net, params, x1, sum2d[1], t_,
                calib_prof)
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
