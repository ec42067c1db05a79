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
   every dtype, every flash-attention instantiation and every layout
   transform must spill nothing);
2. kernels: each hand-written kernel's binding against its plain PyTorch
   version on the card at AlexNet's (and GoogLeNet's 1x1) shapes, at
   batch 1 and 8, with its time, the plain version's, one library
   call's and the card's lower bound, and for the GEMM, the Winograd
   GEMM (its batch folded into N) and the direct conv the launch
   planner's choice (tile, K splits, blocks) and a second call that must
   give the same bits, in f32 and in bf16 and f16; the layout transforms
   (K5, bit for bit, in 1- to 8-byte elements, short channel axes,
   ragged and misaligned planes, one tile and 1449 x 1449 HWC planes
   included, VGG-16's buckets timed cold) and flash attention (K6,
   every masking and layout option, head dims 7 to 320, f32, bf16 and
   f16, its planner's query tile, KV split and blocks, the same bits on
   a repeated call) at the calibration sweep's shapes; then every
   kernel primitive's whole convolution (padding, gathers, transforms,
   crops and each fused layout) at batch 8 against an f64
   ``F.conv2d``;
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
11. lm: TinyLlama-1.1B at full width and depth (f32, random weights from
   seed 0) served by ``ServeLoop`` (``attn_impl="flash"``, 4 slots,
   ``max_seq`` 2048) with the conv tower's ``PlanServer`` (captured
   graphs) behind its ``ContinuousScheduler``: 8 requests of 7 to 1500
   prompt tokens, 16 new tokens each, every second one with an image;
   served cold, then warm.  Each run must launch flash attention (K6)
   exactly once per layer and prefill (decode launches none); K6 at the
   run's layer-0 prefill shapes (T = 7, 128, 1024, 1504) within
   ``TOL_ATTN`` of its plain version; every request's flash prefill
   logits within ``NET_REL`` of the plain path's largest; every served
   token the argmax of a one-request offline ``prefill`` +
   ``decode_step`` on the served history wherever the top-2 margin
   exceeds ``NET_REL`` of the largest logit; and ``python -m
   repro_torch.launch.serve`` (its ``main``, the reference driver's
   scaled-down config, ``--attn-impl flash``) must exit 0 with its plan
   cache line.  Printed: prefill host ms per prompt, admissions and
   decode ticks on the host clock, tokens/s, K6 at T = 1024 beside SDPA
   and its bound, a decode tick's device busy time under the profiler.
12. families: Jamba-v0.1 at full width, one period of 8 layers (13.27 B
   parameters: attention at index 4, seven Mamba layers, four MoE FFNs
   of 16 experts top-2), served as phase 11 serves TinyLlama (path
   ``jamba_serve``: K6 exactly once per prefill, none in decode; K6 at
   the run's prefill shapes as below; flash prefill logits
   within ``NET_REL`` of the plain path's largest; every served token
   the offline decode's at a clear margin; the pairs the MoE layers drop
   by capacity at the longest prompt); Mamba2-2.7B at full width and
   depth served the same way with 4 prompts (``mamba2_serve``, no
   kernel on its path); Whisper-large-v3 at full width and depth,
   ``prefill`` on 1500 frames and 64 tokens and 8 decode steps against
   ``encode``'s output (``whisper``: K6 32 times non-causal in
   the encoder and 32 causal in the decoder; ``whisper_encode``: the
   cross-attention source, 32); LLaVA-NeXT-34B at full width, 4 layers,
   on 2880 patches and 128 tokens (``llava``: 4); each flash run's
   logits within ``NET_REL`` of the plain run's largest or within the
   plain run's own move under a one-rounding nudge of its input
   (Whisper's 64 random layers amplify f32 rounding past ``NET_REL``),
   and Whisper's encoder output and decoder logits each within
   ``NET_REL``; K6 at each recorded call's shapes within ``TOL_ATTN``
   of its plain version on unit normals, and on the path's operands no
   farther from a float64 evaluation than ``TOL_ATTN`` or twice the
   plain version, timed at each model's longest prefill shape beside
   SDPA and its bound; each model's size, prefill host ms and a decode
   step's host and device time beside its floor, each model freed
   before the next.
13. train: TinyLlama-1.1B at full width and depth trained by ``python -m
   repro_torch.launch.train --full-config --steps 20`` (its ``main``: seq
   256 x batch 8, AdamW, one checkpoint at step 20): exit 0, every loss
   finite, the last 5 losses below the first 5, no kernel launched (path
   ``train``); printed: step ms, tokens/s, peak memory, the checkpoint's
   GiB and write seconds, one step under the profiler beside its floor.
   Then ``train()`` at seq 2048 x batch 4 under remat "full" and "dots"
   (their losses equal within 1e-5 relative; step ms and peak memory
   each); at 2 layers of full width from one step-0 state, the card
   against the CPU: the loss within 1e-5 relative, each gradient leaf
   of the card's within max(1e-4, twice the CPU's worst leaf) of a
   float64 evaluation, per leaf of its largest (the gradient of the next
   batch, a wrong one, must fail that gate), AdamW's update of the same
   gradients within
   1e-6 of each leaf's largest; then 3 steps of ``train()`` on each from
   one step-0 checkpoint (step 0's loss within 1e-5, the next within
   1e-3 relative: AdamW's sign-like first step parts the runs), 10 steps
   straight against 5 +
   restart + 5 (losses within 1e-4), a fault at step 7 recovered, a
   persistent fault aborted; the last checkpoint restored onto the card
   and a 64-token prompt prefilled with K6 (path ``train_serve``: once
   per layer; logits within 1e-4 of the plain prefill's largest), and
   ``loss_fn`` with ``attn_impl="flash"`` under grad refused before K6
   launches.
14. mesh: worlds of 4 and then 2 ranks (``launch.mesh.run_spmd``), all
   on the one card over gloo (NCCL refuses two ranks on one device): a
   functional check of the mesh path, not a measurement of multi-GPU
   scaling.  First each collective the mesh executables issue, on CUDA
   tensors, against its expected values; then (a) AlexNet 227 x 227 at
   batch 8 under ``H100_SPEC`` PBQP (kernels priced) on ``{data: 2}``
   and ``{data: 2, model: 2}``, its mode and node counts printed, its
   host-clock forward beside the single-device plan's (that one alone on
   the card); (b) the reference's towers in the four modes:
   ``conv_stack`` "shard_map" and ``conv_tower`` "gspmd" on ``{data:
   2}``, ``bottleneck_tower`` "tp_shard_map" on ``{data: 2, model:
   2}``, ``uniform_stack`` (depth 6) "pipeline" on ``{stage: 4}``; (c)
   each kernel primitive pinned into AlexNet (GoogLeNet for the 1x1
   GEMM) at batch 4, every node dp on ``{data: 2}``, tp wherever
   ``tp_feasible`` admits it on ``{data: 2, model: 2}``; (d) a mesh
   ``PlanServer`` on ``{data: 2}`` against a meshless one on 16
   requests over 7 buckets, then a fresh mesh server on its cache that
   solves nothing.  (b)'s collective probe, cases and checks and (d)'s
   servers are ``tests/_torch_mesh_cases.py``'s, which the card tests'
   ``TestMesh`` runs too.  Every compared output on every rank within
   ``NET_REL`` of the largest magnitude of its single-device plan and
   of a plain one, where no kernel runs: the SUM2D plan on the card for
   (a) and (c), the same selection on the CPU for (b); (b)'s and (c)'s
   launches one per kernel conv on every rank.
15. lm mesh: (a) TinyLlama-1.1B unscaled on ``{data: 2, model: 2}`` (4
   ranks on the card over gloo) under the port's ``select_rules`` with
   ``H100_SPEC`` (it must pick head-parallel attention, Megatron FFNs, a
   replicated stream and embedding, the vocab-sharded head and the
   batch-sharded cache), ``ShardingPlan(mesh=)`` over DTensor: 4 prompts
   of 7-512 tokens prefilled at batch 1 with K6 on each rank's 16 / 2
   heads, then 16 ``decode_step``s over 4 slots (``drop_free``); every
   rank's logits within ``SERVE_REL`` of the single-device flash run's
   largest, or no farther from a float64 evaluation than ``SERVE_REL``
   or twice the single-device f32 run; K6 22 times per prefill on every
   rank, none in decode; K6 at the shard's shape against its plain
   version, timed; (b) one ``train_step`` at 2 layers of full width, seq
   256 x batch 4, on the same mesh: loss and gradients against float64
   as 13c holds them; (c) one Jamba-v0.1 MoE layer at full width through
   ``moe_ffn_alltoall`` on ``{model: 2}`` against the single-device
   ``moe_ffn`` within 1e-5 (no pair drops); (d) ``compressed_psum_tree``
   over 4 ranks against the CPU's arithmetic; (e) ``python -m
   repro_torch.launch.dryrun`` on one cell (a fake process group of 256
   ranks).  The cases and gates are ``tests/_torch_mesh_lm_cases.py``'s,
   shared with the card tests' ``TestMeshLM``; host times are labelled
   gloo on one card, not scaling.

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
limit, and ``{"ok": true, "device": {...}}``.  Phase 11's served runs
are paths too (``lm_serve``, ``lm_serve_warm``), as is its CLI run
(``lm_cli``); K6's ``launches`` are ``lm_serve``'s, and every path's
count, phase 12's and 13's included, is listed beside them.  Phase 14's
mesh forwards are paths on every rank (``mesh_<mode>_<net>_<mesh>_r<rank>``,
counts at 0 in that rank just before its forward, read just after), and
so are phase 15's prefills and decode steps (``mesh_lm_<call>_r<rank>``).
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
#: the Winograd transforms in f32: the plain einsums' arithmetic with the
#: same matrices, summed in another order, so 1e-5 of the largest magnitude
TOL_WT = 1e-5
#: the Winograd transforms' timed shapes: (conv, C, M, H = W) of VGG-16's
#: 3x3 convolutions and F(m, 3) as the cells' plans run them at batch 1
#: (``wino2d_f6x3_chw``, and K3's F(4,3) on conv3_1 and conv5) and at batch
#: 16 (``wino2d_f6x3_chw`` on every one), then AlexNet's conv2 (F(4,5),
#: batch 1); conv3_3, conv4_3 and conv5_2-5_3 repeat a shape above
WT_VGG = [("conv1_2", 64, 64, 224), ("conv2_1", 64, 128, 112),
          ("conv2_2", 128, 128, 112), ("conv3_1", 128, 256, 56),
          ("conv3_2", 256, 256, 56), ("conv4_1", 256, 512, 28),
          ("conv4_2", 512, 512, 28), ("conv5_1", 512, 512, 14)]
WT_B1_M = {"conv3_1": 4, "conv5_1": 4}
WT_ALEXNET = ("conv2", 96, 256, 27, 5, 2, 4)
#: the transforms' ragged planes (tiles overhang): (C, M, H, W) at every
#: (m, k) the kernels are built for, CHW and HWC in and out, batch 1 and 3
WT_RAGGED = [(5, 7, 13, 9), (3, 4, 7, 7)]
#: the calibration sweep's layout-transform shapes (AlexNet's buckets),
#: a ragged one, and short channel axes (C = 1 .. 8, the kernel's
#: short-axis routes) over ragged H*W
LAYOUT_SHAPES = [(4, 256, 256), (128, 32, 32), (256, 16, 16), (512, 16, 16),
                 (96, 27, 27), (1, 13, 17), (2, 27, 27), (3, 227, 227),
                 (4, 27, 31), (5, 7, 9), (8, 13, 13)]
#: the tile route's own cases, (entry's input shape, dtype, take
#: ``x[1:]``): R * e and S * e not multiples of 16, a base 1575 bytes
#: past a 16-byte boundary, one 8 KB tile (128 x 64) in uint8, and HWC
#: planes of 1449 x 1449 (more than 65535 tiles of 32 along R, about
#: 67 MB each); VGG-16's (64, 256, 256) is timed below
LAYOUT_TILE_CASES = [
    ("chw_to_hwc", (27, 13, 17), "uint8", False),
    ("hwc_to_chw", (13, 17, 27), "uint8", False),
    ("chw_to_hwc", (27, 13, 17), "bfloat16", False),
    ("hwc_to_chw", (13, 17, 27), "bfloat16", False),
    ("chw_to_hwc", (3, 25, 7, 9), "uint8", True),
    ("hwc_to_chw", (3, 7, 9, 25), "uint8", True),
    ("chw_to_hwc8", (128, 8, 8), "uint8", False),
    ("hwc_to_chw", (1449, 1449, 32), "uint8", False),
    ("hwc8_to_chw", (1449, 1449, 4, 8), "uint8", False),
]
#: VGG-16's largest calibration buckets and GoogLeNet's (1024, 16, 16):
#: K5c and K5d timed cold (HBM feeds each call, not L2), f32
LAYOUT_COLD_SHAPES = [(64, 256, 256), (128, 128, 128), (256, 64, 64),
                      (512, 32, 32), (1024, 16, 16)]
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


#: bytes of operands a cold timing rotates over: twice the H100's 50 MB L2
COLD_BYTES = 100e6
#: repetitions of a lone call (``cuda_ms(..., reps=LONE_REPS, inner=1)``):
#: one call after the sleep kernel, as a caller that synchronises after
#: every call (calibration, the tuner) sees it, with no call of its own
#: before it whose tail it could overlap
LONE_REPS = 21


def cold_copies(x):
    """Copies of ``x`` enough that they and as many outputs of their size
    span ``COLD_BYTES``, at least 2."""
    pair = 2 * x.numel() * x.element_size()
    return [x.clone() for _ in range(max(2, -(-int(COLD_BYTES) // pair)))]


def cold_ms(torch, fn, inputs, reps: int = 5, inner: int = 20) -> float:
    """``cuda_ms`` with the operands rotated, so that HBM and not L2 feeds
    each call: call i takes ``inputs[i % len(inputs)]``, and its output
    lives until that slot comes round again, so the outputs rotate over
    as many blocks of the caching allocator (``cold_copies`` sizes the
    list past the L2)."""
    outs = [None] * len(inputs)
    turn = [0]

    def call():
        i = turn[0] % len(inputs)
        turn[0] += 1
        outs[i] = fn(inputs[i])
    for _ in inputs:  # every output block allocated before the timing
        call()
    ms = cuda_ms(torch, call, reps, inner)
    outs.clear()
    return ms


def device_profile(torch, fn, calls: int = 3):
    """(wall ms, device-busy ms, top device activities, device events)
    per call of ``fn`` over ``calls`` calls under ``torch.profiler``;
    device-busy is None where the profiler recorded no device time.  Busy
    time sums the device-side events only (kernels and copies, one
    stream), not the host operators that launched them; device events
    counts them."""
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
    events = sum(e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / calls
    top = sorted((r for r in rows if r[0] > 0), reverse=True)[:8]
    return wall, (busy if busy > 0 else None), top, events


class KernelReport:
    """Accumulates one kernel's shapes: error, times and bound.

    ``name`` is the kernel's launch counter unless ``counter`` names
    another (one shared with other kernels).  ``on_path``: whether the
    calibration path launches it (K5b and K5d, the reverse transforms,
    are reached only through ``convert``, which the sweep does not call
    in that direction)."""

    def __init__(self, name, source, replaces, on_path=True, counter=None,
                 shared_by=1):
        self.name, self.source, self.replaces = name, source, replaces
        self.on_path = on_path
        #: the launch counter that counts this kernel (by default its
        #: name), and how many kernels, launched once each, share it (the
        #: Winograd transforms' input and output: 2)
        self.counter, self.shared_by = counter or name, shared_by
        self.err = self.rel_err = 0.0
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.ops_s = self.bytes_s = self.bound_s = 0.0
        #: further reports of this kernel at other shapes, by name (K3's
        #: times at batch 8, K6's at the LM paths' prefill shapes)
        self.subs = {}

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
             plan=None, inputs=None, lone=False):
        """Warm (``cuda_ms``) where ``inputs`` is None; else cold, each of
        the three called on ``inputs`` in turn (``cold_ms``).  ``lone``:
        a lone call's time (``LONE_REPS``), not back-to-back calls'.
        ``library`` None: no one PyTorch call computes the function, and
        ``library_ms`` stays None."""
        kw = dict(reps=LONE_REPS, inner=1) if lone else {}

        def timed(fn):
            return cuda_ms(torch, fn, **kw) if inputs is None else \
                cold_ms(torch, fn, inputs, **kw)
        ms, pms = timed(kernel), timed(plain)
        lms = None if library is None else timed(library)
        o, b = flops / PEAK_F32, nbytes / HBM_BW
        self.ms += ms
        self.plain_ms += pms
        self.library_ms = None if lms is None else self.library_ms + lms
        self.ops_s += o
        self.bytes_s += b
        self.bound_s += max(o, b)
        lib = "none" if lms is None else f"{lms:.4f} ms"
        print(f"  {self.name:14s} {what:34s} kernel {ms:.4f} ms  plain "
              f"{pms:.4f} ms  library {lib}  bound "
              f"{max(o, b) * 1e3:.4f} ms ({'ops' if o >= b else 'bytes'})"
              + (f"  [{plan.describe()}]" if plan is not None else ""))

    def entry(self, paths):
        """``paths``: each path's launch counts, in the order run.  The
        kernel's ``launches`` are those of the first plan path that ran
        it (the PBQP main path where it picks the kernel, else the pinned
        plan at batch 1 that puts it there; K6: phase 11's served run,
        ``lm_serve``); for the kernels that no path runs (K5), the sum
        over the calibration path's kernel items, one call each.  Every
        path's own count is listed beside, and each report in ``subs``
        (K3's times at batch 8, K6's at the LM paths' prefill shapes).
        A counter shared by ``shared_by`` kernels counts each once a use:
        this kernel's launches are its count over ``shared_by``, and the
        entry names the counter."""
        by_path = {p: c[self.counter] // self.shared_by
                   for p, c in paths.items() if c.get(self.counter)}
        first = next((p for p in by_path
                      if p.endswith("_b1") or p == "lm_serve"), None)
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
        if self.shared_by > 1:
            entry["launches_of_counter"] = (
                f"{self.counter} / {self.shared_by}: the counter counts "
                f"{self.shared_by} kernels, each launched once a use")
        for key, sub in self.subs.items():
            entry[key] = {"ms": sub.ms, "plain_ms": sub.plain_ms,
                          "library_ms": sub.library_ms,
                          "bound_ms": sub.bound_s * 1e3}
        return entry


#: the sources whose kernels must spill nothing: those on the GEMM
#: mainloop (``csrc/sgemm_sm90.cuh``), flash attention's, the layout
#: transform's and the Winograd transforms'
MAINLOOP_SOURCES = ("matmul.cu", "conv_direct.cu", "winograd_gemm.cu",
                    "flash_attention.cu", "layout_transform.cu",
                    "winograd_transform.cu")


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
    k3.subs["batch8"] = k3b8

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
    batched, in 1-, 2-, 4- and 8-byte elements, one launch per call, and
    at the tile route's own cases (``LAYOUT_TILE_CASES``).  Timed as its
    callers (calibration, the tuner) run it, a lone call at a time
    (``LONE_REPS``), warm at the sweep's shapes: CHW -> HWC at conv1's
    bucket (C % 8 != 0), CHW -> HWC8 at the others, and each reverse entry
    at the same shapes; K5c and K5d also cold at ``LAYOUT_COLD_SHAPES``
    (the reports' ``cold`` entry)."""
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

    def hold(e, xx, what):
        rpt = reports[e]
        reset_launch_counts()
        got = getattr(lo, e)(xx)
        counts = launch_counts()
        check(counts == {rpt.name: 1}, f"{rpt.name} {what}: launches {counts}")
        want = getattr(lr, f"{e}_ref")(xx)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{rpt.name} {what}: {tuple(got.shape)} {got.dtype}")
        # as bytes: random bits hold NaNs, which compare unequal as floats
        rpt.compare(got.reshape(-1).view(torch.uint8),
                    want.reshape(-1).view(torch.uint8), 0, what)

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
                hold(e, xx, f"{(c, h, w)} {what}")
            swept = (c, h, w) in LAYOUT_SHAPES[:4]
            if swept and (c % 8 == 0) == ("8" in e):
                n = xin.numel()
                rpt.time(torch, f"{tuple(xin.shape)}",
                         lambda: getattr(lk, f"{e}_cuda")(xin),
                         lambda: getattr(lr, f"{e}_ref")(xin),
                         lambda: lib(xin).contiguous(), 0.0, 2.0 * 4 * n,
                         lone=True)
    for e, shape, dtype, sliced in LAYOUT_TILE_CASES:
        dt = getattr(torch, dtype)
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
        xx = torch.from_numpy(rng.integers(0, 256, nbytes, dtype=np.uint8)).to(
            dev).view(dt).reshape(shape)
        if sliced:
            xx = xx[1:]
            check(bool(xx.data_ptr() % 16), "the sliced case is aligned")
        hold(e, xx, f"{tuple(xx.shape)} {dtype}" + (" x[1:]" if sliced
                                                   else ""))
        del xx
    for c, h, w in LAYOUT_COLD_SHAPES:
        x = torch.from_numpy(rng.normal(size=(c, h, w)).astype(
            np.float32)).to(dev)
        hwc8 = x.permute(1, 2, 0).reshape(h, w, c // 8, 8).contiguous()
        for e, xin, lib in (("chw_to_hwc8", x, lambda a: a.permute(1, 2, 0)),
                            ("hwc8_to_chw", hwc8, lambda a: a.reshape(
                                h, w, c).permute(2, 0, 1))):
            hold(e, xin, f"{tuple(xin.shape)} f32")
            rpt = reports[e]
            cold = rpt.subs.setdefault(
                "cold", KernelReport(rpt.name, src, rpt.replaces))
            p = lk.plan(*((c, h * w) if e == "chw_to_hwc8" else (h * w, c)), 4)
            cold.time(torch, f"{tuple(xin.shape)} cold",
                      getattr(lk, f"{e}_cuda"), getattr(lr, f"{e}_ref"),
                      lambda a: lib(a).contiguous(), 0.0,
                      2.0 * 4 * xin.numel(), inputs=cold_copies(xin),
                      lone=True)
            print(f"  {'':14s} tile {p.tile} {lk.tile_elems(p.tile, 4)}, "
                  f"{p.grid} blocks over {p.units} tiles")
    sync(torch, dev)
    print("  layout transforms: all four entries bit-exact at "
          f"{LAYOUT_SHAPES}, single, batch 2, bf16, int8 and f64, at "
          f"{[(e, s, d) for e, s, d, _ in LAYOUT_TILE_CASES]} and at "
          f"{LAYOUT_COLD_SHAPES} in f32, one launch each")
    return list(reports.values())


def winograd_transform_phase(torch, dev):
    """The 2-D Winograd input and output transforms against their plain
    einsums (``TOL_WT``), one launch each: every (m, k) on the ragged
    planes ``WT_RAGGED``, CHW and HWC in and out, batch 1 and 3; at each
    timed shape in CHW, and at batch 1 also HWC.  Timed as a lone call,
    warm, at VGG-16's shapes as the b1 and b16 cells' plans run them
    (``WT_VGG``) and AlexNet's conv2, beside their bound (the bytes each
    must move over 3.35e12 B/s) and the plain version; no one PyTorch call
    computes a transform (library none).  Reports: the input and output
    transforms at VGG-16 batch 1, and as ``subs`` at batch 16 and at
    AlexNet's conv2."""
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.kernels.winograd_transform import (
        PAIRS, input_transform_cuda, input_transform_ref, operands,
        output_transform_cuda, output_transform_ref, transform_bytes)
    from repro_torch.kernels.winograd_transform import ops as wo

    src = "src/repro_torch/csrc/winograd_transform.cu"
    reports = {w: KernelReport(f"winograd_transform.{w}", src,
                               f"none: the {w} transform's einsums, which "
                               "XLA fuses", counter="winograd_transform",
                               shared_by=2)
               for w in ("input", "output")}

    def hold(rpt, fn, args, plain, what):
        reset_launch_counts()
        got = fn(*args)
        counts = launch_counts()
        check(counts == {"winograd_transform": 1},
              f"winograd_transform {what}: launches {counts}")
        rpt.compare(got, plain(*args), TOL_WT, what)

    def hold_both(scn, m_, lays, what):
        """Both transforms at ``scn`` (batch ``scn.n``), F(m_, scn.k), for
        each (input layout, output layout) of ``lays``."""
        x, q, b = operands(scn, m_, device=dev)
        k, pad = scn.k, scn.pad
        for li, lo in lays:
            xv = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2) \
                if li == "HWC" else x
            hold(reports["input"], lambda a: wo.input_transform(
                a, m_=m_, k=k, pad=pad), (xv,),
                lambda a: input_transform_ref(a, m_, k, pad),
                f"input F({m_},{k}) {what} {li}")
            hold(reports["output"], lambda a, c: wo.output_transform(
                a, c, m_=m_, k=k, n=scn.n, oh=scn.out_h, ow=scn.out_w,
                out_layout=lo), (q, b),
                lambda a, c: output_transform_ref(
                    a, c, m_, k, scn.n, scn.out_h, scn.out_w, lo),
                f"output F({m_},{k}) {what} {lo}")
        return x, q, b

    every = [("CHW", "CHW"), ("HWC", "HWC"), ("CHW", "HWC"), ("HWC", "CHW")]
    for c, mo, h, w in WT_RAGGED:
        for m_, k in PAIRS:
            for n in (1, 3):
                hold_both(Scenario(c=c, h=h, w=w, stride=1, k=k, m=mo,
                                   pad=k // 2, n=n), m_, every,
                          f"{(n, c, h, w)}")

    def timed(label, conv, scn, m_, batch_rpt):
        x, q, b = hold_both(
            scn, m_, every if scn.n == 1 else every[:1], f"{conv} {label}")
        nin, nout = transform_bytes(scn, m_)
        k, pad = scn.k, scn.pad
        for w, fn, plain, nbytes in (
                ("input", lambda: input_transform_cuda(x, m_, k, pad),
                 lambda: input_transform_ref(x, m_, k, pad), nin),
                ("output", lambda: output_transform_cuda(
                    q, b, m_, k, scn.n, scn.out_h, scn.out_w),
                 lambda: output_transform_ref(q, b, m_, k, scn.n, scn.out_h,
                                              scn.out_w), nout)):
            r = reports[w] if batch_rpt is None else \
                reports[w].subs.setdefault(batch_rpt, KernelReport(
                    reports[w].name, src, reports[w].replaces))
            ms0 = r.ms
            r.time(torch, f"{w} {conv} F({m_},{k}) {label}", fn, plain, None,
                   0.0, nbytes, lone=True)
            print(f"  {'':14s} {w} {conv} {label}: kernel / bound "
                  f"{(r.ms - ms0) / (nbytes / HBM_BW * 1e3):.2f}")

    for conv, c, mo, hw in WT_VGG:
        for n, label, sub in ((1, "b1", None), (16, "b16", "b16")):
            m_ = WT_B1_M.get(conv, 6) if n == 1 else 6
            timed(label, conv, Scenario(c=c, h=hw, w=hw, stride=1, k=3,
                                        m=mo, n=n), m_, sub)
    conv, c, mo, hw, k, pad, m_ = WT_ALEXNET
    timed("b1", f"alexnet {conv}",
          Scenario(c=c, h=hw, w=hw, stride=1, k=k, m=mo, pad=pad), m_,
          "alexnet_conv2")
    sync(torch, dev)
    print(f"  winograd transforms: both within {TOL_WT} of the plain "
          f"einsums at every (m, k) of {PAIRS} on {WT_RAGGED}, CHW and HWC "
          f"in and out, batch 1 and 3, and at the timed shapes; one launch "
          f"each")
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
            if kname == "winograd_gemm":  # and its two transforms
                want["winograd_transform"] = 2
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
    from repro_torch.kernels import all_launches, expected_launches
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
        want = all_launches(cnet.sel)
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
        for k, v in all_launches(sel).items():
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
    wall, busy, _, _ = device_profile(torch, lambda: srv.infer(xs[0]))
    print(f"  profile, one served infer at batch 1 (jit=True): wall "
          f"{wall:.4f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'} [{card}]")
    x1 = torch.from_numpy(xs[0]).to(dev)
    for what, cn in (("replayed graph", srv.compiled_for(shape)),
                     ("eager walk", esrv.compiled_for(shape))):
        wall, busy, top, _ = device_profile(torch, lambda: cn(x1))
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
    passed down are the launch the card ran.  The Winograd transforms
    around a pinned GEMM pin nothing and are not recorded."""

    def __init__(self):
        from repro_torch.kernels.common import KernelLib
        from repro_torch.kernels.winograd_transform import LIB
        self.cls, self.calls, self.skip = KernelLib, [], LIB

    def __enter__(self):
        orig, calls, skip = self.cls.call, self.calls, self.skip

        def call(lib, entry, *args):
            if lib is not skip:
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
    from repro_torch.kernels import all_launches
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
        for k, v in all_launches(sel).items():
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


#: phase 11: TinyLlama-1.1B at full width and depth (f32, random
#: weights from seed 0) served through ``ServeLoop`` and its
#: ``ContinuousScheduler``: 8 requests of these prompt lengths, 16 new
#: tokens each, every second request (the odd ones) with an image of
#: 12-40 px for the conv tower; K6 is checked against its plain version
#: at the prefill shapes of these prompt lengths
LM_ARCH = "tinyllama-1.1b"
LM_PROMPTS = (7, 33, 128, 257, 512, 1000, 1024, 1500)
LM_MAX_NEW, LM_MAX_BATCH, LM_MAX_SEQ = 16, 4, 2048
LM_K6_CHECK = (7, 128, 1024, 1500)
#: the serve CLI at the reference driver's scaled-down config
LM_CLI_ARGS = ["--requests", "6", "--max-new", "4", "--vision-every", "2",
               "--attn-impl", "flash"]


def lm_requests(cfg, prompt_lens, max_new):
    """Requests of these prompt lengths from seed 11, every second one
    (the odd ones) with an image of 12-40 px for the conv tower."""
    from repro_torch.runtime import Request
    rng = np.random.default_rng(11)
    out = []
    for i, n in enumerate(prompt_lens):
        pixels = None
        if i % 2 == 1:
            hw = int(rng.integers(12, 41))
            pixels = rng.normal(size=(3, hw, hw)).astype(np.float32)
        out.append(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=n).astype(np.int32),
            max_new_tokens=max_new, pixels=pixels))
    return out


def serve_runs(torch, dev, cfg, params, prompt_lens, names, paths, k6,
               k6_per_prefill, what):
    """Serve ``lm_requests`` through a ``ServeLoop`` (``attn_impl=
    "flash"``, ``LM_MAX_BATCH`` slots, ``max_seq`` ``LM_MAX_SEQ``) with
    the conv tower's ``PlanServer`` behind its ``ContinuousScheduler``,
    once per name in ``names``, each run one path: counts at 0 before,
    read after.  Each run must serve every token and launch K6 (``k6``)
    exactly ``k6_per_prefill`` times per request, none of them in a
    decode tick.  Returns (the loop, {name: requests})."""
    from repro_torch.core.costs import AnalyticCostModel
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.models import ModelRuntime
    from repro_torch.runtime import ServeLoop
    from repro_torch.serving import BucketPolicy, PlanServer, conv_tower

    server = PlanServer(lambda s: conv_tower(s, depth=2, width=8),
                        AnalyticCostModel(),
                        policy=BucketPolicy(min_hw=8, max_hw=128),
                        device=dev)
    loop = ServeLoop(cfg, params, max_batch=LM_MAX_BATCH,
                     max_seq=LM_MAX_SEQ, rt=ModelRuntime(attn_impl="flash"),
                     plan_server=server, device=dev)
    # host clock per admission (vision, prefill) and per decode tick: each
    # ends on a copy to the host, so each call's time includes its device
    # work; a tick's K6 launches are counted apart
    spent = {"admit": [], "tick": [], "tick_k6": []}

    def timed(name, fn):
        def call():
            n0 = launch_counts().get(k6, 0)
            t0 = time.perf_counter()
            fn()
            spent[name].append(time.perf_counter() - t0)
            if name == "tick":
                spent["tick_k6"].append(launch_counts().get(k6, 0) - n0)
        return call

    loop._admit = timed("admit", loop._admit)
    loop._tick = timed("tick", loop._tick)
    want_k6 = k6_per_prefill * len(prompt_lens)
    runs = {}
    try:
        for name in names:
            reqs = lm_requests(cfg, prompt_lens, LM_MAX_NEW)
            for v in spent.values():
                v.clear()
            sync(torch, dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            loop.run(reqs)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            paths[name] = counts = launch_counts()
            stats = loop.scheduler.stats()
            n_tok = sum(len(r.tokens) for r in reqs)
            check(all(r.done and len(r.tokens) == LM_MAX_NEW for r in reqs),
                  f"{what}: not every request served {LM_MAX_NEW} tokens")
            print(f"  path {name}: launches {counts}")
            check(counts.get(k6, 0) == want_k6 and sum(spent["tick_k6"]) == 0,
                  f"{what}: {k6} launched {counts.get(k6, 0)} times on {name}"
                  f" ({sum(spent['tick_k6'])} in decode ticks), expected "
                  f"{k6_per_prefill} per prefill = {want_k6} (decode "
                  f"launches none)")
            ticks = np.asarray(spent["tick"]) * 1e3
            print(f"  {name}: {len(reqs)} requests, {n_tok} tokens in "
                  f"{wall:.4f} s (host clock): {n_tok / wall:.2f} tokens/s; "
                  f"admissions {sum(spent['admit']):.4f} s "
                  f"({len(spent['admit'])} calls), {len(ticks)} decode ticks "
                  f"{ticks.sum() / 1e3:.4f} s (median {np.median(ticks):.4f} "
                  f"ms); vision {stats['requests']} images over "
                  f"{stats['buckets']} buckets, {stats['solves']} solves, "
                  f"{stats['compiles']} compiles, {stats['sched_batches']} "
                  f"scheduler batches; vision kernel launches "
                  f"{({k: v for k, v in counts.items() if k != k6}) or 'none'}")
            runs[name] = reqs
    finally:
        loop.close()
        server.close()
    return loop, runs


def check_served(torch, dev, cfg, params, reqs, prompt_lens, max_new, what,
                 on_flash=None):
    """Each served request against the plain path and an offline decode:
    its flash prefill logits within ``NET_REL`` of the plain path's
    largest, and every served token the argmax of a teacher-forced
    one-request ``prefill`` + ``decode_step`` on the served history
    wherever the top-2 margin exceeds ``NET_REL`` of the largest logit.
    ``on_flash(t)``: a context manager around the flash prefill of a
    T-token prompt.  Returns the flash prefill's host ms per T."""
    import contextlib

    from repro_torch.kernels.common import true_f32
    from repro_torch.models import (ModelRuntime, ShardingPlan, decode_step,
                                    prefill)
    plain = ShardingPlan()
    flash_rt, xla_rt = ModelRuntime(attn_impl="flash"), ModelRuntime()
    prefill_ms = {}
    for r in sorted(reqs, key=lambda r: len(r.prompt)):
        t = len(r.prompt)
        tok = torch.from_numpy(r.prompt.astype(np.int64))[None].to(dev)
        with true_f32():
            lx, cache = prefill(cfg, params, {"tokens": tok}, plain, xla_rt,
                                max_seq=t + max_new)
            del cache
            sync(torch, dev)
            t0 = time.perf_counter()
            with (on_flash(t) if on_flash else contextlib.nullcontext()):
                lf, cache = prefill(cfg, params, {"tokens": tok}, plain,
                                    flash_rt, max_seq=t + max_new)
                sync(torch, dev)
            prefill_ms[t] = (time.perf_counter() - t0) * 1e3
            lx, lf = lx[0, -1], lf[0, -1]
            scale = float(lx.abs().max())
            err = float((lf - lx).abs().max())
            check(bool(lf.isfinite().all()) and err <= NET_REL * scale,
                  f"{what} request {r.rid} (T = {t}): flash prefill logits "
                  f"differ from the plain path's by {err:.3e} > "
                  f"{NET_REL} x {scale:.3e}")
            # teacher-forced offline greedy decode on the served tokens:
            # each step's argmax must be the served token wherever the
            # top-2 margin is clear of the tolerance
            logits, clear, pos = lf, 0, t
            for j, served in enumerate(r.tokens):
                top2 = torch.topk(logits, 2).values
                margin = float(top2[0] - top2[1])
                mine = int(torch.argmax(logits))
                if margin > NET_REL * float(logits.abs().max()):
                    clear += 1
                    check(mine == served,
                          f"{what} request {r.rid}: step {j} served "
                          f"{served}, offline decode {mine} at a clear "
                          f"margin {margin:.3e}")
                elif mine != served:
                    print(f"  request {r.rid} step {j}: served {served}, "
                          f"offline {mine}, margin {margin:.3e} within "
                          f"the tolerance")
                if j + 1 < len(r.tokens):
                    lg, cache = decode_step(
                        cfg, params, cache,
                        torch.tensor([[served]], device=dev), pos, plain,
                        flash_rt)
                    logits, pos = lg[0, 0], pos + 1
            del cache
        print(f"  request {r.rid}: T = {t}{' (4 image tokens)' if prompt_lens[r.rid] != t else ''}, flash "
              f"prefill {prefill_ms[t]:.4f} ms (host clock), logits within "
              f"{err / max(scale, 1e-30):.3e} of the plain path's largest, "
              f"{clear}/{len(r.tokens)} steps at a clear margin, all equal "
              f"to the offline decode")
    return prefill_ms


def tick_profile(torch, cfg, params, cache, toks, pos, floor_bytes, floor_is,
                 cross_kv=None):
    """One decode step of ``toks`` (B, 1) at positions ``pos`` on
    ``cache``, as the serving loop runs it (``drop_free``), under
    ``torch.profiler``: host wall, device busy, idle
    share, device events and the top kernels, beside the device floor
    ``floor_bytes`` / ``HBM_BW``.  Returns (wall ms, busy ms or None)."""
    from repro_torch.kernels.common import true_f32
    from repro_torch.models import ModelRuntime, ShardingPlan, decode_step
    with true_f32():
        tick_ms, busy, top, events = device_profile(
            torch, lambda: decode_step(cfg, params, cache, toks, pos,
                                       ShardingPlan(),
                                       ModelRuntime(attn_impl="flash"),
                                       cross_kv=cross_kv, drop_free=True),
            calls=5)
    floor = floor_bytes / HBM_BW * 1e3
    share = "not measured" if busy is None else \
        f"{max(0.0, 1 - busy / tick_ms):.4f}"
    print(f"  decode tick ({toks.shape[0]} slots) under torch.profiler: "
          f"wall {tick_ms:.4f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'}, idle "
          f"share {share}, {events:.0f} device events (floor for "
          f"{floor_is}: {floor:.4f} ms)")
    for tm, key in top:
        print(f"    {tm:9.4f} ms  {key[:90]}")
    return tick_ms, busy


def slot_tick(torch, dev, reqs):
    """The tokens and positions of a decode tick after a served run:
    each slot at a request's last token."""
    toks = torch.tensor([[r.tokens[-1]] for r in reqs[:LM_MAX_BATCH]],
                        device=dev)
    pos = torch.tensor([len(r.prompt) + len(r.tokens) - 1
                        for r in reqs[-LM_MAX_BATCH:]], device=dev)
    return toks, pos


def lm_phase(torch, F, dev, paths, attn_rpt):
    """Phase 11: the LM serving path on the card.  ``attn_rpt``: K6's
    report, which gains the served run's launches and the TinyLlama
    prefill shape's times (``lm_prefill``)."""
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.kernels.common import (launch_counts,
                                            reset_launch_counts, true_f32)
    from repro_torch.kernels.flash_attention import (attention_plan,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import init_params, param_count
    from repro_torch.models.common import rms_norm, rope

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.float32, dev)
    sync(torch, dev)
    n_par = param_count(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, "
          f"vocab {cfg.vocab}: {n_par} parameters in f32 "
          f"({n_par * 4 / 1e9:.2f} GB), made in "
          f"{time.perf_counter() - t0:.2f} s")

    loop, runs = serve_runs(torch, dev, cfg, params, LM_PROMPTS,
                            ("lm_serve", "lm_serve_warm"), paths,
                            attn_rpt.name, cfg.n_layers, "lm")
    reqs = runs["lm_serve"]
    same = [a.tokens == b.tokens for a, b in zip(reqs, runs["lm_serve_warm"])]
    print(f"  the warm run served the cold run's tokens for {sum(same)} of "
          f"{len(same)} requests")

    # ---- K6 against its plain version at the run's prefill shapes ----
    hd = cfg.resolved_head_dim
    blk = params["blocks"]["layer0"]
    k6_check = [r for r in reqs if LM_PROMPTS[r.rid] in LM_K6_CHECK]
    qkv = {}
    for r in k6_check:
        tok = torch.from_numpy(r.prompt.astype(np.int64))[None].to(dev)
        with true_f32():
            x = rms_norm(params["embed"][tok], blk["norm1"][0], cfg.norm_eps)
            pos = torch.arange(tok.shape[1], device=dev)[None]
            q = rope(torch.einsum("btd,dhk->bthk", x, blk["attn"]["wq"][0]),
                     pos, cfg.rope_theta)
            k = rope(torch.einsum("btd,dhk->bthk", x, blk["attn"]["wk"][0]),
                     pos, cfg.rope_theta)
            v = torch.einsum("btd,dhk->bthk", x, blk["attn"]["wv"][0])
            kw = dict(scale=hd ** -0.5, causal=True)
            got = flash_attention(q, k, v, layout="LHD", **kw)
            attn_rpt.compare(got, flash_attention_ref(q, k, v, seq_major=True,
                                                      **kw), TOL_ATTN,
                             f"TinyLlama layer 0 prefill, T = {q.shape[1]}")
        qkv[q.shape[1]] = (q, k, v)
        print(f"  {attn_rpt.name} TinyLlama layer 0 prefill q "
              f"{tuple(q.shape)} k/v {tuple(k.shape)} causal: within "
              f"{TOL_ATTN} of the plain version [{attention_plan(q, k, v, seq_major=True).describe()}]")

    # ---- the served model against the plain path and an offline decode ----
    check_served(torch, dev, cfg, params, reqs, LM_PROMPTS, LM_MAX_NEW,
                 "lm")

    # ---- numbers: K6 at T = 1024, the decode tick, the serve CLI ----
    q, k, v = qkv[1024]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(scale=hd ** -0.5, causal=True, seq_major=True)
    lm = KernelReport(attn_rpt.name, attn_rpt.source, attn_rpt.replaces)
    t_ = q.shape[1]
    with true_f32():
        lm.time(torch, f"TinyLlama prefill {tuple(q.shape)} causal",
                lambda: flash_attention_cuda(q, k, v, **kw),
                lambda: flash_attention_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True),
                4.0 * t_ * (t_ + 1) / 2 * hd * cfg.n_heads,
                4.0 * (2 * q.numel() + k.numel() + v.numel()),
                attention_plan(q, k, v, seq_major=True))
    attn_rpt.subs["lm_prefill"] = lm
    tick_profile(torch, cfg, params, loop.cache, *slot_tick(torch, dev, reqs),
                 n_par * 4, "reading the f32 weights once")
    del loop
    small = get_config(LM_ARCH).scaled_down()
    buf = io.StringIO()
    sync(torch, dev)
    reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main(LM_CLI_ARGS)
    sync(torch, dev)
    paths["lm_cli"] = counts = launch_counts()
    out = buf.getvalue()
    line = next((ln for ln in out.splitlines()
                 if ln.startswith("plan cache:")), None)
    check(rc == 0 and line is not None,
          f"lm: the serve CLI exited {rc} without its plan cache line:\n"
          f"{out[-2000:]}")
    check(counts.get(attn_rpt.name) == small.n_layers * 6,
          f"lm: the serve CLI launched {counts.get(attn_rpt.name)} "
          f"{attn_rpt.name}, expected {small.n_layers} per prefill")
    print(f"  python -m repro_torch.launch.serve {' '.join(LM_CLI_ARGS)}: "
          f"exit {rc}, path lm_cli: launches {counts}")
    print(f"  {next(ln for ln in out.splitlines() if ln.startswith('served'))}")
    print(f"  {line}")


#: phase 12: the MoE/SSM/hybrid families and the encoder-decoder and VLM
#: input paths (f32, random weights from seed 0).  Jamba-v0.1 at full
#: width, its depth cut to one period of 8 layers (13.27 B parameters,
#: 49.4 GiB; all 32 layers would be 191.7 GiB), served as phase 11 serves
#: TinyLlama; Mamba2-2.7B at full width and depth served with 4 prompts;
#: Whisper-large-v3 at full width and depth (prefill on 1500 frames and 64
#: tokens, then decode steps against the encoder's output); LLaVA-NeXT-34B
#: at full width, its depth cut to 4 layers (3.20 B parameters; all 60
#: would be 128 GiB), prefill on 2880 patches and 128 tokens, then decode
#: steps
JAMBA_ARCH, JAMBA_LAYERS = "jamba-v0.1-52b", 8
MAMBA_ARCH, MAMBA_PROMPTS = "mamba2-2.7b", (7, 128, 1024, 1500)
WHISPER_ARCH, WHISPER_TOKENS = "whisper-large-v3", 64
LLAVA_ARCH, LLAVA_LAYERS, LLAVA_TOKENS = "llava-next-34b", 4, 128
FAMILY_STEPS = 8


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def made(torch, dev, cfg):
    """The parameters of ``cfg`` in f32 from seed 0 on ``dev``, their
    size printed."""
    from repro_torch.models import init_params, param_count
    t0 = time.perf_counter()
    params = init_params(cfg, 0, torch.float32, dev)
    sync(torch, dev)
    n = param_count(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers"
          f"{f' (+{cfg.enc_layers} encoder)' if cfg.enc_layers else ''}, "
          f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.head_dim or '-'}, d_ff {cfg.d_ff}, vocab {cfg.vocab}"
          f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}"
          f"{f', ssm_state {cfg.ssm_state}' if cfg.ssm_state else ''}: {n} "
          f"parameters in f32 ({n * 4 / 2**30:.2f} GiB), made in "
          f"{time.perf_counter() - t0:.2f} s")
    return params


class FlashCalls:
    """Inside ``with``: the operands of the first flash-attention call of
    each (shape, causal) kind, as the models pass them (the first
    attention layer's)."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import repro_torch.kernels.flash_attention as fa
        self._fa, self._kept = fa, fa.flash_attention

        def spy(q, k, v, **kw):
            self.calls.setdefault((tuple(q.shape), tuple(k.shape),
                                   kw.get("causal")), (q, k, v, kw))
            return self._kept(q, k, v, **kw)
        fa.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self._fa.flash_attention = self._kept


class MoeDrops:
    """Inside ``with``: per MoE layer called, (pairs, pairs dropped by
    capacity), read from the router's dispatch of the layer's input."""

    def __init__(self):
        self.layers = []

    def __enter__(self):
        import repro_torch.models.blocks as blocks
        from repro_torch.models.moe import _local_dispatch, capacity
        self._blocks, self._kept = blocks, blocks.moe_ffn

        def spy(cfg, p, x, plan, **kw):
            n = x.shape[0] * x.shape[1]
            c = max(capacity(cfg, n), n if kw.get("drop_free") else 0)
            _, (keep, *_) = _local_dispatch(cfg, p, x.reshape(n, -1), c)
            self.layers.append((n * cfg.top_k, int((~keep).sum())))
            return self._kept(cfg, p, x, plan, **kw)
        blocks.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        self._blocks.moe_ffn = self._kept


def attention64(q, k, v, *, scale, causal, window=0, softcap=0.0):
    """Sequence-major attention evaluated in float64 (GQA, causal,
    window, softcap): what an f32 evaluation is held to where the
    softmax amplifies f32 rounding."""
    import torch
    q, k, v = (t.double().transpose(1, 2) for t in (q, k, v))
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = (q * scale) @ k.transpose(-1, -2)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(q.shape[2], device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones_like(qp >= kp)
    if causal:
        mask = mask & (qp >= kp)
    if window > 0:
        mask = mask & (qp - kp < window)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    return (p @ v).transpose(1, 2)


def hold_k6(torch, F, attn_rpt, calls, what, sub=None):
    """K6 at each recorded call's shapes and options: on unit-normal
    operands from a seed against its plain version within ``TOL_ATTN``;
    on the recorded operands against a float64 evaluation, no farther
    from it than ``TOL_ATTN`` of its largest magnitude or twice the
    plain version's distance (random weights make the logits large
    enough for the softmax to turn f32 rounding into more than 1e-5:
    both f32 evaluations then lie as far from the exact one).  With
    ``sub``, the longest call is timed beside its plain version, SDPA
    and its bound as ``attn_rpt.subs[sub]``."""
    from repro_torch.kernels.common import true_f32
    from repro_torch.kernels.flash_attention import (attention_plan,
                                                     flash_attention,
                                                     flash_attention_cuda,
                                                     flash_attention_ref)
    gen = torch.Generator(device=next(iter(calls.values()))[0].device)
    gen.manual_seed(6)
    with true_f32():
        for (qs, ks, causal), (q, k, v, kw) in calls.items():
            kw = {n: kw[n] for n in ("scale", "causal", "window", "softcap")}
            rq, rk, rv = (torch.randn(t.shape, generator=gen,
                                      device=t.device) for t in (q, k, v))
            attn_rpt.compare(flash_attention(rq, rk, rv, layout="LHD", **kw),
                             flash_attention_ref(rq, rk, rv, seq_major=True,
                                                 **kw), TOL_ATTN,
                             f"{what} q {qs} causal={causal}, unit normals")
            got = flash_attention(q, k, v, layout="LHD", **kw)
            plain = flash_attention_ref(q, k, v, seq_major=True, **kw)
            exact = attention64(q, k, v, **kw)
            scale = float(exact.abs().max())
            e_k, e_p = (float((t.double() - exact).abs().max())
                        for t in (got, plain))
            check(bool(got.isfinite().all())
                  and e_k <= max(TOL_ATTN * scale, 2 * e_p),
                  f"{attn_rpt.name} {what} q {qs}: {e_k:.3e} from float64, "
                  f"the plain version {e_p:.3e}, largest {scale:.3e}")
            print(f"  {attn_rpt.name} {what} q {qs} k/v {ks} "
                  f"{'causal' if causal else 'non-causal'}: within "
                  f"{TOL_ATTN} of the plain version on unit normals; on the "
                  f"path's operands {e_k / scale:.3e} of the largest from "
                  f"float64 (the plain version {e_p / scale:.3e}, the two "
                  f"{float((got - plain).abs().max()) / scale:.3e} apart) "
                  f"[{attention_plan(q, k, v, seq_major=True).describe()}]")
        if sub is None:
            return
        (qs, _, causal), (q, k, v, kw) = max(calls.items(),
                                            key=lambda c: c[0][0][1])
        kw = {n: kw[n] for n in ("scale", "causal", "window", "softcap")}
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        t_, hq, d = q.shape[1], q.shape[2], q.shape[3]
        pairs = t_ * (t_ + 1) / 2 if causal else t_ * k.shape[1]
        rpt = KernelReport(attn_rpt.name, attn_rpt.source, attn_rpt.replaces)
        rpt.time(torch, f"{what} {qs} {'causal' if causal else 'full'}",
                 lambda: flash_attention_cuda(q, k, v, seq_major=True, **kw),
                 lambda: flash_attention_ref(q, k, v, seq_major=True, **kw),
                 lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, is_causal=causal, scale=kw["scale"],
                     enable_gqa=True),
                 4.0 * pairs * d * hq,
                 4.0 * (2 * q.numel() + k.numel() + v.numel()),
                 attention_plan(q, k, v, seq_major=True))
        attn_rpt.subs[sub] = rpt


def served_family(torch, F, dev, paths, attn_rpt, cfg, prompts, name,
                  sub=None):
    """12a/12b: ``cfg`` served by ``serve_runs`` as path ``name`` (K6 once
    per attention layer and prefill), then ``check_served``, K6 at the
    prefill shapes of ``LM_K6_CHECK``'s prompts, the pairs the MoE
    layers drop at the longest prompt, and a decode tick."""
    from repro_torch.models import param_count
    from repro_torch.models.blocks import layer_kinds, n_super
    params = made(torch, dev, cfg)
    n_attn = n_super(cfg) * sum(k["mixer"] == "attn"
                                for k in layer_kinds(cfg))
    loop, runs = serve_runs(torch, dev, cfg, params, prompts, (name,), paths,
                            attn_rpt.name, n_attn, name)
    reqs = runs[name]
    check_ts = {len(r.prompt) for r in reqs if prompts[r.rid] in LM_K6_CHECK}
    longest = max(len(r.prompt) for r in reqs)
    flash, drops = FlashCalls(), MoeDrops()

    def on_flash(t):
        import contextlib
        return flash if t in check_ts else contextlib.nullcontext()
    prefill_ms = check_served(torch, dev, cfg, params, reqs, prompts,
                              LM_MAX_NEW, name, on_flash)
    if cfg.n_experts:
        # the drops are read in a prefill of their own, out of the timed one
        from repro_torch.kernels.common import true_f32
        from repro_torch.models import ModelRuntime, ShardingPlan, prefill
        r = next(r for r in reqs if len(r.prompt) == longest)
        tok = torch.from_numpy(r.prompt.astype(np.int64))[None].to(dev)
        with true_f32(), drops:
            prefill(cfg, params, {"tokens": tok}, ShardingPlan(),
                    ModelRuntime(attn_impl="flash"), max_seq=longest)
        sync(torch, dev)
    print(f"  {name}: flash prefill host ms per T "
          f"{ {t: round(v, 4) for t, v in sorted(prefill_ms.items())} }")
    if n_attn:
        check(len(flash.calls) == len(check_ts),
              f"{name}: K6 recorded at {len(flash.calls)} prefill shapes")
        hold_k6(torch, F, attn_rpt, flash.calls,
                f"{cfg.name} first attention layer prefill", sub)
    if drops.layers:
        print(f"  {name}: pairs dropped by capacity (cf "
              f"{cfg.capacity_factor}) per MoE layer at T = {longest}: "
              + ", ".join(f"{d}/{n}" for n, d in drops.layers))
    tick_profile(torch, cfg, params, loop.cache,
                 *slot_tick(torch, dev, reqs), param_count(cfg) * 4,
                 "reading the f32 weights once")


def prefill_family(torch, F, dev, paths, attn_rpt, cfg, batch, name,
                   want_k6, sub):
    """12c/12d: ``prefill`` on ``batch`` and ``FAMILY_STEPS``
    ``decode_step``s, plain (``attn_impl="xla"``) and then flash as path
    ``name`` (``want_k6`` launches, none in decode); K6 at the first
    attention layers' prefill shapes; a decode step's profile.  An
    encoder-decoder decodes against ``encode``'s output, computed before
    the path (path ``name + "_encode"``).

    The flash run against the plain run: each stage that K6 runs in (an
    encoder's output; the decoder's logits at every position, given the
    same encoder output) within ``NET_REL`` of the plain stage's largest
    magnitude; the composed logits of the prefill and every decode step
    within ``NET_REL``, or no farther from the plain run's than the plain
    run moves when its input (frames or patches) moves by one f32
    rounding, 2^-23: a deep model with random weights amplifies f32
    rounding past ``NET_REL`` whatever computes its attention."""
    from repro_torch.kernels.common import (launch_counts,
                                            reset_launch_counts, true_f32)
    from repro_torch.models import (ModelRuntime, ShardingPlan, decode_step,
                                    encode, prefill)
    params = made(torch, dev, cfg)
    plain = ShardingPlan()
    flash_rt, xla_rt = ModelRuntime(attn_impl="flash"), ModelRuntime()
    rng = np.random.default_rng(12)
    steps = rng.integers(0, cfg.vocab, size=FAMILY_STEPS)
    calls = FlashCalls()

    # the prompt's length: a VLM's patches ahead of its tokens
    t = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                    if "patches" in batch else 0)

    def run(rt, cross, batch=batch):
        with true_f32():
            sync(torch, dev)
            t0 = time.perf_counter()
            lg, cache = prefill(cfg, params, batch, plain, rt,
                                max_seq=t + FAMILY_STEPS)
            sync(torch, dev)
            ms = (time.perf_counter() - t0) * 1e3
            outs = [lg[0, -1]]
            for j, tok in enumerate(steps):
                lg, cache = decode_step(
                    cfg, params, cache,
                    torch.tensor([[int(tok)]], device=dev), t + j, plain,
                    rt, cross_kv=cross)
                outs.append(lg[0, 0])
        return outs, cache, ms

    cross_x = cross_f = None
    if cfg.family == "encdec":
        with true_f32():
            cross_x = encode(cfg, params, batch["frames"], plain, xla_rt)
            sync(torch, dev)
            reset_launch_counts()
            cross_f = encode(cfg, params, batch["frames"], plain, flash_rt)
            sync(torch, dev)
        paths[name + "_encode"] = counts = launch_counts()
        check(counts.get(attn_rpt.name, 0) == cfg.enc_layers,
              f"{name}: encode launched {counts} (expected "
              f"{cfg.enc_layers} {attn_rpt.name})")
        print(f"  path {name}_encode (the cross-attention source): "
              f"launches {counts}")
    want, _, plain_ms = run(xla_rt, cross_x)
    # the plain run with its input moved by one f32 rounding
    key = "frames" if cfg.family == "encdec" else "patches"
    nudged = {**batch, key: batch[key] * (1 + 2.0 ** -23)}
    with true_f32():
        cross_n = None if cross_x is None else encode(
            cfg, params, nudged["frames"], plain, xla_rt)
    moved, _, _ = run(xla_rt, cross_n, nudged)
    sync(torch, dev)
    reset_launch_counts()
    with calls:
        got, cache, flash_ms = run(flash_rt, cross_f)
    sync(torch, dev)
    paths[name] = counts = launch_counts()
    check(counts.get(attn_rpt.name, 0) == want_k6,
          f"{name}: {attn_rpt.name} launched {counts.get(attn_rpt.name, 0)}"
          f" times, expected {want_k6} (decode launches none)")
    print(f"  path {name} (prefill T = {t} + {FAMILY_STEPS} decode steps): "
          f"launches {counts}")
    worst = nudge = 0.0
    for j, (a, b, c) in enumerate(zip(got, want, moved)):
        scale = float(b.abs().max())
        err, sens = (float((x - b).abs().max()) for x in (a, c))
        check(bool(a.isfinite().all()) and err <= max(NET_REL * scale, sens),
              f"{name} step {j}: flash logits differ from the plain "
              f"path's by {err:.3e} > {NET_REL} x {scale:.3e}, and the "
              f"plain path moves by {sens:.3e} under a one-rounding nudge")
        worst, nudge = max(worst, err / scale), max(nudge, sens / scale)
    print(f"  {name}: prefill T = {t} host {flash_ms:.4f} ms flash, "
          f"{plain_ms:.4f} ms plain; the prefill and {FAMILY_STEPS} decode "
          f"steps' flash logits within {worst:.3e} of the plain path's "
          f"largest (the plain path under a one-rounding nudge of its "
          f"{key}: {nudge:.3e})")
    if cross_x is not None:
        from repro_torch.models import model as lm

        def decoder(rt):
            h = lm._embed(cfg, params, batch["tokens"], plain)
            h, _ = lm._run_blocks(
                cfg, params["blocks"], h, plan=plain, rt=rt,
                positions=torch.arange(h.shape[1], device=dev)[None],
                cross_kv=cross_x)
            return lm._head(cfg, params, lm.rms_norm(
                h, params["final_norm"], cfg.norm_eps), plain)
        with true_f32():
            stages = {"encoder output": (cross_f, cross_x),
                      "decoder logits on the plain encoder's output":
                      (decoder(flash_rt), decoder(xla_rt))}
        for what, (a, b) in stages.items():
            scale = float(b.abs().max())
            err = float((a - b).abs().max())
            check(bool(a.isfinite().all()) and err <= NET_REL * scale,
                  f"{name} {what}: flash differs from plain by {err:.3e} > "
                  f"{NET_REL} x {scale:.3e}")
            print(f"  {name} {what}: flash within {err / scale:.3e} of the "
                  f"plain path's largest")
    hold_k6(torch, F, attn_rpt, calls.calls, f"{cfg.name} layer 0 prefill",
            sub)
    tail = {k: v for k, v in params.items()
            if k not in ("enc_blocks", "enc_pos", "enc_norm", "embed",
                         "patch_proj")}
    floor = tree_bytes(tail) + (0 if cross_f is None else
                                tree_bytes({"x": cross_f}))
    tok = torch.tensor([[int(steps[-1])]], device=dev)
    tick_profile(torch, cfg, params, cache, tok, t + FAMILY_STEPS - 1, floor,
                 "reading the decoder's f32 weights"
                 + (" and the encoder's output" if cross_f is not None else "")
                 + " once", cross_kv=cross_f)


def families_phase(torch, F, dev, paths, attn_rpt):
    """Phase 12: Jamba-v0.1 (one period, full width) and Mamba2-2.7B served,
    Whisper-large-v3 and LLaVA-NeXT-34B (4 layers) through prefill and
    decode, each model freed before the next."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    print("  -- 12a: Jamba-v0.1, one period of 8 layers at full width --")
    served_family(torch, F, dev, paths, attn_rpt,
                  replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS),
                  LM_PROMPTS, "jamba_serve", "jamba_prefill")
    torch.cuda.empty_cache()
    print(f"  -- 12b: Mamba2-2.7B at full width and depth "
          f"({time.perf_counter() - t0:.1f} s) --")
    served_family(torch, F, dev, paths, attn_rpt, get_config(MAMBA_ARCH),
                  MAMBA_PROMPTS, "mamba2_serve")
    torch.cuda.empty_cache()
    print(f"  -- 12c: Whisper-large-v3 at full width and depth "
          f"({time.perf_counter() - t0:.1f} s) --")
    cfg = get_config(WHISPER_ARCH)
    rng = np.random.default_rng(12)
    batch = {"frames": torch.from_numpy((rng.normal(size=(
        1, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)).to(dev),
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(1, WHISPER_TOKENS))).to(dev)}
    prefill_family(torch, F, dev, paths, attn_rpt, cfg, batch, "whisper",
                   cfg.enc_layers + cfg.n_layers, "whisper_encoder")
    torch.cuda.empty_cache()
    print(f"  -- 12d: LLaVA-NeXT-34B, {LLAVA_LAYERS} layers at full width "
          f"({time.perf_counter() - t0:.1f} s) --")
    cfg = replace(get_config(LLAVA_ARCH), n_layers=LLAVA_LAYERS)
    batch = {"patches": torch.from_numpy((rng.normal(size=(
        1, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)).to(dev),
        "tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(1, LLAVA_TOKENS))).to(dev)}
    prefill_family(torch, F, dev, paths, attn_rpt, cfg, batch, "llava",
                   cfg.n_layers, "llava_prefill")
    torch.cuda.empty_cache()


#: phase 13: training.  TinyLlama-1.1B at full width and depth through
#: the train CLI (``--full-config``: seq 256 x batch 8, the CLI's defaults,
#: AdamW with ``warmup_cosine(3e-4, 20, 20)``, one checkpoint at the last
#: step), then ``train()`` at seq 2048 x batch 4 under each remat policy;
#: at 2 layers of full width (219 M parameters) the card against the CPU
#: from one step-0 checkpoint, the loop's restart, fault and abort, and
#: the trained checkpoint served with K6
TRAIN_ARCH, TRAIN_STEPS = "tinyllama-1.1b", 20
#: the train CLI's default shape
TRAIN_SEQ, TRAIN_BATCH = 256, 8
TRAIN_CLI_ARGS = ["--full-config", "--steps", str(TRAIN_STEPS),
                  "--ckpt-every", str(TRAIN_STEPS)]
REMAT_SEQ, REMAT_BATCH, REMAT_STEPS = 2048, 4, 3
SMALL_LAYERS, SMALL_SEQ, SMALL_BATCH, SMALL_STEPS = 2, 64, 2, 3
TRAIN_PROMPT = 64
#: the card against the CPU from one step-0 state: the loss within 1e-5
#: relative (f32 on both, summed in other orders).  The gradients of
#: these random-weight models are ill-conditioned (the stacked weights'
#: fan-in is the layer count, ROADMAP §3): the CPU's own f32 gradient
#: lies up to ~4e-3 of a leaf's largest from a float64 evaluation, so
#: each leaf of the card's is held to a float64 evaluation on the CPU,
#: within 1e-4 of the leaf's largest or twice the worst leaf of the
#: CPU's f32 gradient (the rule of ``tests/test_torch_train.py``'s
#: ``GRAD_REL``); the next batch's gradient, a wrong one, must fail that
#: gate.  AdamW's update of the
#: same gradients within 1e-6 of each leaf's largest (its only
#: reduction is the global norm).  Then ``train()`` on each device: step
#: 0's loss within 1e-5; the runs part after it, since AdamW's first
#: step is ~lr x sign(g) and a gradient near 0 that rounds to the other
#: sign moves its element 2 lr apart (3.5e-5 and 8.9e-5 relative after
#: one and two updates on the H100 against the CPU), so the next losses
#: are held within 1e-3 relative, a check that both train one model.  A
#: resumed run: losses within 1e-4, as the reference's
#: ``test_restart_resumes_and_matches``; served: the LM parity
#: tolerance, 1e-4 of the largest logit
TRAIN_LOSS_REL, GRAD_REL, UPDATE_REL, TRAIN_DRIFT_REL = 1e-5, 1e-4, 1e-6, \
    1e-3
RESUME_TOL, SERVE_REL = 1e-4, 1e-4


def leaf_dists(got, want) -> list:
    """Per leaf of two trees of one structure (any devices): the largest
    ``|got - want|`` over the leaf's largest ``|want|``."""
    from repro_torch.tree import leaves
    out = []
    for x, y in zip(leaves(got), leaves(want)):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        scale = float(y.abs().max()) if y.numel() else 0.0
        err = float((x - y).abs().max()) if y.numel() else 0.0
        out.append(err / scale if scale else err)
    return out


def leaf_dist(got, want) -> float:
    """The worst leaf of :func:`leaf_dists`."""
    return max(leaf_dists(got, want))


def float64_grads(cfg, params, batch):
    """``loss_and_grads`` on the CPU in float64: the parameters and the
    batch's floats made float64, and the model's f32 casts
    (``Tensor.float``) made float64 for the call (RoPE's tables stay
    f32, inputs alike to every evaluation)."""
    import torch
    from repro_torch.models import ModelRuntime, ShardingPlan
    from repro_torch.runtime.train_loop import loss_and_grads
    from repro_torch.tree import leaves, unflatten

    def f64(t):
        t = t.detach().cpu()
        return t.double() if t.is_floating_point() else t
    p64 = unflatten(params, [f64(t) for t in leaves(params)])
    b64 = {k: f64(v) for k, v in batch.items()}
    real = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    try:
        return loss_and_grads(cfg, ShardingPlan(), ModelRuntime(), p64, b64)
    finally:
        torch.Tensor.float = real


def reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(torch, dev) -> str:
    """The most the card held since :func:`reset_peak`, in GiB."""
    if dev.type != "cuda":
        return "not measured"
    return f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"


def dir_gib(path) -> float:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file()) / 2**30


def train_floor_s(cfg, n_par, seq, batch, passes):
    """The least time of one step at 67 TFLOP/s f32: ``passes`` x 2
    flops per weight of the products (the embedding gather has none) per
    token (6: forward and backward; 8: with full remat), and the plain
    attention's scores and P V over the whole T x T, ``passes / 2``
    times its forward."""
    tokens = seq * batch
    dense = passes * (n_par - cfg.vocab * cfg.d_model) * tokens
    attn = 4.0 * batch * cfg.n_heads * seq * seq * cfg.resolved_head_dim \
        * cfg.n_layers * passes / 2
    return (dense + attn) / PEAK_F32


def steps_ms(metrics, skip=0):
    return float(np.median([m["time_s"] for m in metrics[skip:]])) * 1e3


def train_cli_run(torch, dev, tmp):
    """13a: ``python -m repro_torch.launch.train --full-config`` (its
    ``main``), with a spy on ``train`` for the losses and the final state
    and a timed ``Checkpointer.save``.  Returns (cfg, state, losses)."""
    import repro_torch.runtime as runtime
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import train_loop

    seen, saves = {}, []
    real_train, real_ckpt = runtime.train, train_loop.Checkpointer

    def spy(*a, **kw):
        seen["metrics"] = kw["metrics_out"]
        seen["state"] = real_train(*a, **kw)
        return seen["state"]

    class TimedCheckpointer(real_ckpt):
        def save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            super().save(step, tree, extra)
            saves.append((step, time.perf_counter() - t0,
                          dir_gib(self.dir / f"step_{step}")))

    argv = TRAIN_CLI_ARGS + ["--device", dev.type, "--ckpt-dir", str(tmp)]
    runtime.train, train_loop.Checkpointer = spy, TimedCheckpointer
    try:
        reset_peak(torch, dev)
        t0 = time.perf_counter()
        rc = train_cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        runtime.train, train_loop.Checkpointer = real_train, real_ckpt
    cfg = get_config(TRAIN_ARCH)
    m = seen["metrics"]
    losses = [x["loss"] for x in m]
    check(rc == 0 and len(losses) == TRAIN_STEPS,
          f"train: the CLI exited {rc} after {len(losses)} steps")
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"train: no learning: the first 5 losses average "
          f"{first:.4f}, the last 5 {last:.4f}")
    check(len(saves) == 1 and saves[0][0] == TRAIN_STEPS,
          f"train: checkpoints {saves}, expected one at {TRAIN_STEPS}")
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}: exit "
          f"{rc} in {wall:.1f} s; peak {peak_gib(torch, dev)}")
    print(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  mean of the first 5 {first:.4f} > of the last 5 {last:.4f}")
    print(f"  checkpoint at step {saves[0][0]}: {saves[0][2]:.2f} GiB "
          f"written in {saves[0][1]:.2f} s")
    return cfg, seen["state"], m


def training_phase(torch, dev, paths, attn_rpt):
    """Phase 13: training on the card (13a-e above ``TRAIN_ARCH``)."""
    import shutil
    from dataclasses import replace

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    from repro_torch.models import (ModelRuntime, ShardingPlan, init_params,
                                    loss_fn, param_count, prefill)
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.runtime import TrainLoopConfig, train
    from repro_torch.runtime.train_loop import loss_and_grads, train_step
    from repro_torch.tree import leaves, unflatten

    root = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    try:
        # ---- 13a: the CLI at full width and depth ----
        print(f"  -- 13a: {TRAIN_ARCH} at full width and depth through the "
              f"train CLI --")
        sync(torch, dev)
        reset_launch_counts()
        cfg, st, m = train_cli_run(torch, dev, root / "cli")
        sync(torch, dev)
        paths["train"] = launch_counts()
        check(paths["train"] == {}, f"train: kernels launched "
              f"{paths['train']}; the training path runs none")
        n_par = param_count(cfg)
        seq, bsz = TRAIN_SEQ, TRAIN_BATCH
        step_ms = steps_ms(m, skip=5)
        floor = train_floor_s(cfg, n_par, seq, bsz, 6)
        print(f"  {cfg.name}: {n_par} parameters; step (host clock, median "
              f"of steps 5-{TRAIN_STEPS - 1}) {step_ms:.2f} ms, "
              f"{seq * bsz / step_ms * 1e3:.1f} tokens/s; floor "
              f"{floor * 1e3:.2f} ms at 67 TFLOP/s f32; path train: "
              f"launches {paths['train']}")
        opt_lr = warmup_cosine(3e-4, 20, TRAIN_STEPS)
        opt = adamw(opt_lr)
        batch = make_batch(cfg, ShapeConfig("cli", seq, bsz, "train"),
                           TRAIN_STEPS, dtype=torch.float32, device=dev)
        wall, busy, top, events = device_profile(
            torch, lambda: train_step(cfg, opt, ShardingPlan(),
                                      ModelRuntime(), st.params,
                                      st.opt_state, batch), calls=1)
        share = "not measured" if busy is None else \
            f"{max(0.0, 1 - busy / wall):.4f}"
        print(f"  one step under torch.profiler: wall {wall:.2f} ms, device "
              f"busy {'not measured' if busy is None else f'{busy:.2f} ms'},"
              f" idle share {share}, {events:.0f} device events")
        for t, key in top:
            print(f"    {t:9.3f} ms  {key[:90]}")
        del st, m, batch
        shutil.rmtree(root / "cli")
        torch.cuda.empty_cache()

        # ---- 13b: remat at seq 2048 x batch 4 ----
        print(f"  -- 13b: train() at seq {REMAT_SEQ} x batch {REMAT_BATCH}, "
              f"{REMAT_STEPS} steps under each remat policy --")
        shape = ShapeConfig("remat", REMAT_SEQ, REMAT_BATCH, "train")
        floor = train_floor_s(cfg, n_par, REMAT_SEQ, REMAT_BATCH, 8)
        runs = {}
        for policy in ("full", "dots"):
            reset_peak(torch, dev)
            mr = []
            train(cfg, shape, opt,
                  rt=ModelRuntime(remat=True, remat_policy=policy),
                  loop=TrainLoopConfig(total_steps=REMAT_STEPS,
                                       ckpt_every=REMAT_STEPS,
                                       ckpt_dir=str(root / policy), keep=1,
                                       log_every=0),
                  metrics_out=mr, device=dev)
            runs[policy] = [x["loss"] for x in mr]
            print(f"  remat {policy}: losses {runs[policy]}; step (host "
                  f"clock, median of {REMAT_STEPS}) {steps_ms(mr):.2f} ms, "
                  f"{REMAT_SEQ * REMAT_BATCH / steps_ms(mr) * 1e3:.1f} "
                  f"tokens/s; peak {peak_gib(torch, dev)}; floor "
                  f"{floor * 1e3:.2f} ms (full remat's flops)")
            shutil.rmtree(root / policy)
            torch.cuda.empty_cache()
        for a, b in zip(runs["full"], runs["dots"]):
            check(abs(a - b) <= TRAIN_LOSS_REL * abs(a), f"train: remat "
                  f"full {runs['full']} vs dots {runs['dots']}")
        print(f"  the two policies' losses agree within {TRAIN_LOSS_REL} "
              f"relative")

        # ---- 13c: 2 layers at full width, the card against the CPU ----
        small = replace(cfg, n_layers=SMALL_LAYERS)
        sshape = ShapeConfig("small", SMALL_SEQ, SMALL_BATCH, "train")
        print(f"  -- 13c: {SMALL_LAYERS} layers at full width "
              f"({param_count(small)} parameters) from one step-0 state: "
              f"the gradients and the update on the card against the CPU, "
              f"then {SMALL_STEPS} steps of train() on each --")
        p0 = init_params(small, 0, torch.float32, "cpu")
        s0 = opt.init(p0)

        def to_card(tree):
            return unflatten(tree, [t.to(dev) for t in leaves(tree)])

        def batch_at(step, d):
            return make_batch(small, sshape, step, dtype=torch.float32,
                              device=d)

        def grads_at(params, step, d):
            return loss_and_grads(small, ShardingPlan(), ModelRuntime(),
                                  params, batch_at(step, d))
        lc, gc_ = grads_at(p0, 0, "cpu")
        pg = to_card(p0)
        lg, gg = grads_at(pg, 0, dev)
        l64, g64 = float64_grads(small, p0, batch_at(0, "cpu"))
        lc, lg, l64 = float(lc), float(lg), float(l64)
        check(abs(lc - lg) <= TRAIN_LOSS_REL * abs(lc),
              f"train: step 0's loss on the card {lg} vs the CPU {lc}")
        e_cpu, e_card = leaf_dists(gc_, g64), leaf_dists(gg, g64)
        gate = max(GRAD_REL, 2 * max(e_cpu))
        check(max(e_card) <= gate, f"train: step 0's gradients on the "
              f"card lie {e_card} of each leaf's largest from float64, "
              f"beyond {gate:.3e} (the CPU's {e_cpu})")
        # a wrong gradient (the card's of step 1's batch) fails the gate
        wrong = leaf_dist(grads_at(pg, 1, dev)[1], g64)
        check(wrong > gate, f"train: the gradient gate passes a wrong "
              f"gradient ({wrong:.3e} <= {gate:.3e})")
        # the update: the CPU's gradients through AdamW on each device
        new_c = opt.update(gc_, s0, p0)
        new_g = opt.update(to_card(gc_), to_card(s0), pg)
        upd = leaf_dist(new_g, new_c)
        check(upd <= UPDATE_REL, f"train: AdamW's first update on the "
              f"card lies {upd:.3e} of a leaf's largest from the CPU's > "
              f"{UPDATE_REL}")
        print(f"  step 0: loss {lg} on the card, {lc} on the CPU, {l64} in "
              f"float64 (gate {TRAIN_LOSS_REL} relative); gradients from "
              f"float64, per leaf of its largest: the card's worst "
              f"{max(e_card):.3e}, the CPU's worst {max(e_cpu):.3e} (gate "
              f"{gate:.3e}; step 1's batch, a wrong gradient: "
              f"{wrong:.3e}); AdamW's update of "
              f"the same gradients, parameters and state within "
              f"{upd:.3e} (gate {UPDATE_REL})")
        print(f"    per leaf, card / CPU from float64: " + ", ".join(
            f"{a:.2e}/{b:.2e}" for a, b in zip(e_card, e_cpu)))
        del gc_, gg, g64, pg, new_c, new_g
        Checkpointer(root / "cpu").save(0, (p0, s0))
        shutil.copytree(root / "cpu", root / "card")
        res = {}
        for where, d in (("card", dev.type), ("cpu", "cpu")):
            mr = []
            t0 = time.perf_counter()
            st_ = train(small, sshape, opt, loop=TrainLoopConfig(
                total_steps=SMALL_STEPS, ckpt_dir=str(root / where),
                log_every=0), metrics_out=mr, device=d)
            res[where] = ([x["loss"] for x in mr], st_.params)
            print(f"  train() on the {where}: losses {res[where][0]} "
                  f"({time.perf_counter() - t0:.1f} s)")
        (lc, pc), (lg, pg) = res["cpu"], res["card"]
        check(abs(lc[0] - lg[0]) <= TRAIN_LOSS_REL * abs(lc[0]),
              f"train: step 0 on the card {lg} vs the CPU {lc}")
        for a, b in zip(lc[1:], lg[1:]):
            check(abs(a - b) <= TRAIN_DRIFT_REL * abs(a), f"train: card "
                  f"{lg} vs CPU {lc}")
        print(f"  steps 1-{SMALL_STEPS - 1}: losses within "
              f"{max(abs(a - b) / abs(a) for a, b in zip(lc, lg)):.3e} "
              f"relative (gate {TRAIN_DRIFT_REL}); parameters after step "
              f"{SMALL_STEPS} within {leaf_dist(pg, pc):.3e} of each leaf's "
              f"largest")
        del res, p0, s0, pc, pg
        for where in ("card", "cpu"):
            shutil.rmtree(root / where)

        # ---- 13d: restart, fault and abort ----
        print(f"  -- 13d: restart, fault and abort at {SMALL_LAYERS} "
              f"layers --")

        def run(name, steps, **kw):
            mr = []
            s = train(small, sshape, opt, loop=TrainLoopConfig(
                total_steps=steps, ckpt_every=5, ckpt_dir=str(root / name),
                keep=1, log_every=0, max_retries=2), metrics_out=mr,
                device=dev, **kw)
            return s, mr
        _, full = run("straight", 10)
        run("resumed", 5)
        s, resumed = run("resumed", 10)
        check([x["step"] for x in resumed] == list(range(5, 10)),
              f"train: the restart ran steps {[x['step'] for x in resumed]}")
        worst = max(abs(a["loss"] - b["loss"])
                    for a, b in zip(full[5:], resumed))
        check(worst <= RESUME_TOL, f"train: 10 straight vs 5 + restart + 5: "
              f"{worst:.3e}")
        print(f"  10 steps straight vs 5 + restart + 5: losses within "
              f"{worst:.3e} (gate {RESUME_TOL})")
        fired = []

        def fault(step):
            if step == 7 and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure @ 7")
        sf, mf = run("fault", 10, fault_hook=fault)
        check(fired == [7] and sf.step == 10 and mf[-1]["step"] == 9,
              f"train: a fault at step 7: fired {fired}, ended at {sf.step}")
        print(f"  a fault at step 7: restored from step 5, finished at step "
              f"{sf.step} ({len(mf)} steps run)")

        def always(step):
            raise RuntimeError("dead node")
        try:
            run("abort", 3, fault_hook=always)
        except RuntimeError as e:
            check("aborting" in str(e), f"train: the abort said {e}")
            print(f"  a persistent fault: {e}")
        else:
            raise RuntimeError("train: a persistent fault did not abort")
        del full, resumed, mf, sf

        # ---- 13e: the trained checkpoint on the serving path ----
        print(f"  -- 13e: the checkpoint of 13d's step 10 served, K6 in "
              f"prefill --")
        like = init_params(small, 1, torch.float32, dev)
        step, (params, _), _ = Checkpointer(root / "resumed").restore(
            (like, opt.init(like)))
        del like
        check(step == 10 and all(t.equal(u) for t, u in zip(
            leaves(params), leaves(s.params))),
            "train: the restored parameters are not the trained ones")
        tok = torch.from_numpy(np.random.default_rng(13).integers(
            0, small.vocab, size=(1, TRAIN_PROMPT))).to(dev)
        with torch.no_grad():
            plain, _ = prefill(small, params, {"tokens": tok},
                               ShardingPlan(), ModelRuntime())
            sync(torch, dev)
            reset_launch_counts()
            flash, _ = prefill(small, params, {"tokens": tok},
                               ShardingPlan(), ModelRuntime(attn_impl="flash"))
            sync(torch, dev)
            paths["train_serve"] = launch_counts()
        want = {attn_rpt.name: small.n_layers}
        check(paths["train_serve"] == want, f"train_serve: launches "
              f"{paths['train_serve']}, expected {want}")
        err = float((flash - plain).abs().max())
        scale = float(plain.abs().max())
        check(bool(flash.isfinite().all()) and err <= SERVE_REL * scale,
              f"train_serve: flash vs plain logits {err:.3e} > "
              f"{SERVE_REL} x {scale:.3e}")
        print(f"  prefill of {TRAIN_PROMPT} tokens: flash vs plain logits "
              f"{err:.3e} (gate {SERVE_REL} x {scale:.3e}); path "
              f"train_serve: launches {paths['train_serve']}")
        grad = {**params, "embed": params["embed"].detach().requires_grad_()}
        batch = make_batch(small, sshape, 0, dtype=torch.float32, device=dev)
        reset_launch_counts()
        try:
            loss_fn(small, grad, batch, ShardingPlan(),
                    ModelRuntime(attn_impl="flash"))
        except NotImplementedError as e:
            check(launch_counts() == {}, "train: K6 launched under grad")
            print(f"  loss_fn with attn_impl='flash' under grad: "
                  f"NotImplementedError: {e}")
        else:
            raise RuntimeError("train: K6 ran under autograd")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------
# phase 14: the mesh on the card
# ---------------------------------------------------------------------
#: phase 14: the worlds (ranks sharing ``cuda:0`` over gloo) and their
#: meshes, AlexNet's batch on them (PBQP) and the pinned kernels' batch
#: (the smallest that divides over a 2 x 2 mesh's batch axes)
MESH_BATCH, MESH_PINNED_BATCH = 8, 4
MESH_TIMEOUT_S = 120.0
#: phase 14: AlexNet's and GoogLeNet's resolution (``alexnet(scale)``) and
#: the host-clock forwards timed; the worlds get both as arguments
MESH_SCALE, MESH_REPS = 1.0, 10
#: phase 14 (d): the mesh server's 16 requests, H and W drawn from this
#: range: buckets 16, 32 and 64 at ``BucketPolicy(min_hw=8, max_hw=64)``
MESH_SERVE_HW = (12, 40)


def mesh_path(torch, dev, paths, name, cnet, x, want):
    """One mesh forward as a path: this rank's counts at 0 just before,
    read just after; ``want`` the launches this rank must make (none on
    the CPU, where every wrapper runs its plain version)."""
    from repro_torch.kernels.common import launch_counts, reset_launch_counts
    sync(torch, dev)
    reset_launch_counts()
    out = cnet(x)
    sync(torch, dev)
    paths[name] = launch_counts()
    want = want if dev.type == "cuda" else {}
    check(paths[name] == want, f"path {name}: launches {paths[name]}, "
          f"expected {want}")
    return out


def mesh_alexnet(torch, dev, mesh, axes, label, paths, scale, reps):
    """(a): AlexNet 227 x 227 at batch ``MESH_BATCH``, ``H100_SPEC`` PBQP
    with the kernels priced on ``axes``, against the single-device PBQP
    plan and the SUM2D plan (every conv the plain textbook routine) at
    every tap; the host-clock forward of the mesh and one-device PBQP
    plans."""
    import torch.distributed as dist

    from repro_torch.convnets import alexnet
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.plan import compile_plan, measure
    from repro_torch.core.selection import select_pbqp, select_sum2d
    from repro_torch.kernels import all_launches
    cost = AnalyticCostModel(H100_SPEC, include_kernels=True)
    net = alexnet(scale).with_batch(MESH_BATCH)
    params = net.init_params(seed=0)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(MESH_BATCH,) + net.nodes["data"].out_shape).astype(
            np.float32)).to(dev)
    sel = select_pbqp(net, cost, mesh_axes=axes)
    one_sel = select_pbqp(net, cost)
    t_ = taps(net)
    # jit=True (the default) is accepted on a mesh and captures nothing
    cn = compile_plan(sel, params, batch=MESH_BATCH, mesh=mesh, device=dev,
                      outputs=t_)
    one = compile_plan(one_sel, params, batch=MESH_BATCH, device=dev,
                       jit=False, outputs=t_)
    name = f"mesh_{cn.mesh_mode}_alexnet_{label}"
    out = mesh_path(torch, dev, paths, name, cn, x, all_launches(sel))
    check(cn.graph is None, f"{name}: a mesh executable was captured")
    agree(out, one(x), f"{name} vs the single-device PBQP plan")
    agree(out, compile_plan(select_sum2d(net, cost), params,
                            batch=MESH_BATCH, device=dev, jit=False,
                            outputs=t_)(x),
          f"{name} vs SUM2D on one device (no kernel)")
    bare = compile_plan(sel, params, batch=MESH_BATCH, mesh=mesh,
                        device=dev)
    t_mesh = measure(bare, x, reps=reps)
    dist.barrier()
    t_one = None
    if dist.get_rank() == 0:   # alone on the card
        t_one = measure(compile_plan(one_sel, params, batch=MESH_BATCH,
                                     device=dev, jit=False), x, reps=reps)
    dist.barrier()
    return {"path": name, "mode": cn.mesh_mode, "dp": cn.dp_nodes,
            "tp": cn.tp_nodes, "pp": cn.pp_nodes,
            "convs": {n.id: (sel.choices[n.id].primitive.name,
                             str(sel.choices[n.id].placement))
                      for n in net.conv_nodes()},
            "mesh_ms": t_mesh["mean_s"] * 1e3,
            "mesh_min_ms": t_mesh["min_s"] * 1e3,
            "one_ms": None if t_one is None else t_one["mean_s"] * 1e3,
            "one_min_ms": None if t_one is None else t_one["min_s"] * 1e3}


def mesh_pinned(torch, dev, mesh, axes, label, paths, scale):
    """(c): each kernel primitive pinned by ``select_fixed`` onto every
    conv that supports it (AlexNet; GoogLeNet for the 1x1 GEMM), every
    node ``dp``, or on a ``model`` axis ``tp`` wherever
    ``PlacementPricing.tp_feasible`` admits the pinned primitive, at
    batch ``MESH_PINNED_BATCH``: one launch per kernel conv on every
    rank, and every tap within ``NET_REL`` of the same selection's
    single-device plan and of the net's SUM2D plan (every conv the plain
    textbook routine): the kernels at the shards' shapes, held against
    plain versions."""
    import dataclasses

    from repro_torch.convnets import alexnet, googlenet
    from repro_torch.core.costs import H100_SPEC, AnalyticCostModel
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.primitives import registry
    from repro_torch.core.selection import (PlacementPricing, select_fixed,
                                            select_sum2d)
    from repro_torch.kernels import all_launches
    cost = AnalyticCostModel(H100_SPEC, include_kernels=True)
    b = MESH_PINNED_BATCH
    rng = np.random.default_rng(0)
    nets = {}
    res = []
    for prim in (p for p in registry() if "kernel" in p.tags):
        which = "googlenet" if prim.name == "pallas_pw_gemm_chw" else \
            "alexnet"
        if which not in nets:
            net = (googlenet if which == "googlenet" else alexnet)(
                scale).with_batch(b)
            params = net.init_params(seed=0)
            x = torch.from_numpy(rng.normal(
                size=(b,) + net.nodes["data"].out_shape).astype(
                    np.float32)).to(dev)
            nets[which] = (net, params, x, compile_plan(
                select_sum2d(net, cost), params, batch=b, device=dev,
                jit=False, outputs=taps(net))(x))
        net, params, x, plain = nets[which]
        pick = {nd.id: prim for nd in net.conv_nodes()
                if prim.supports(nd.scn)}
        psel = select_fixed(net, cost, pick, f"pinned_{prim.name}")
        pricing = PlacementPricing(net, cost, axes)

        def place(nid):
            node = net.nodes[nid]
            if "model" in axes and node.kind == "conv" and \
                    pricing.tp_feasible(node, psel.choices[nid].primitive):
                return "tp"
            return "dp"
        psel = dataclasses.replace(psel, choices={
            nid: dataclasses.replace(ch, placement=place(nid))
            for nid, ch in psel.choices.items()})
        t_ = taps(net)
        cn = compile_plan(psel, params, batch=b, mesh=mesh, device=dev,
                          jit=False, outputs=t_)
        name = f"mesh_{cn.mesh_mode}_pinned_{prim.name}_{which}_{label}"
        out = mesh_path(torch, dev, paths, name, cn, x,
                        all_launches(psel))
        agree(out, compile_plan(psel, params, batch=b, device=dev,
                                jit=False, outputs=t_)(x),
              f"{name} vs the same selection on one device")
        agree(out, plain, f"{name} vs SUM2D on one device (no kernel)")
        res.append({"path": name, "convs": len(pick), "tp": cn.tp_nodes,
                    "dp": cn.dp_nodes, "mode": cn.mesh_mode})
    return res


def mesh_towers(dev, cases, paths):
    """(b): the shared mesh cases ``cases`` (``tests/_torch_mesh_cases.py``,
    the reference's towers at batch 8 under ``AnalyticCostModel()``, as
    ``tests/test_distributed.py`` solves them) on this world, each held
    by the cases' own check: its mode, nothing captured, its path's
    launches, and every conv and sink within ``NET_REL`` of the same
    selection without a mesh on the card and on the CPU."""
    import _torch_mesh_cases as C
    got = C.plan_cases({c: C.CARD_CASES[c] for c in cases}, dev.type)
    res = []
    for c in cases:
        C.check_card_case(c, got[c], NET_REL, dev.type)
        paths[got[c]["path"]] = got[c]["launches"]
        res.append({k: got[c][k] for k in ("path", "mode", "dp", "tp",
                                           "pp")})
    return res


def mesh_world_two(dev_type, scale, reps, cache_dir):
    """Phase 14's world of 2 ranks: (a) and (c) on ``{data: 2}``, the
    two {dp, rep} towers of (b), and (d): a mesh ``PlanServer`` and a
    meshless one on 16 requests (H and W from ``MESH_SERVE_HW``), then
    a fresh mesh server on ``cache_dir`` that must solve nothing."""
    import _torch_mesh_cases as C
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import BucketPolicy
    from repro_torch.serving.bucketing import bucket_shape
    dev = torch.device(dev_type)
    paths, res = {}, {}
    axes = {"data": 2}
    mesh = make_mesh((2,), ("data",), dev)
    res["alexnet"] = mesh_alexnet(torch, dev, mesh, axes, "data2", paths,
                                  scale, reps)
    res["towers"] = mesh_towers(dev, ("conv_stack_data2",
                                      "conv_tower_data2"), paths)
    res["pinned"] = mesh_pinned(torch, dev, mesh, axes, "data2", paths,
                                scale)
    srv = C.serve_cases(cache_dir, dev_type, ((2,), ("data",)),
                        MESH_SERVE_HW)
    policy = BucketPolicy(**C.SERVER_POLICY)
    res["server"] = {
        "rel_err": C.check_serve(srv, NET_REL),
        "mesh_compiles": srv["stats"]["mesh_compiles"],
        "compiles": srv["stats"]["compiles"],
        "buckets": sorted({bucket_shape(x.shape, policy)
                           for x in C.server_stream(MESH_SERVE_HW)})}
    res["paths"] = paths
    return res


def mesh_world_four(dev_type, scale, reps, cache_dir):
    """Phase 14's world of 4 ranks: the collective probe first, then (a)
    and (c) on ``{data: 2, model: 2}``, and (b)'s tp tower on it and
    pipeline on ``{stage: 4}``."""
    import _torch_mesh_cases as C
    import torch

    from repro_torch.launch.mesh import make_mesh
    dev = torch.device(dev_type)
    paths, res = {}, {}
    res["collectives"] = C.collectives(dev_type)["names"]
    axes = {"data": 2, "model": 2}
    mesh = make_mesh((2, 2), ("data", "model"), dev)
    res["alexnet"] = mesh_alexnet(torch, dev, mesh, axes, "data2xmodel2",
                                  paths, scale, reps)
    res["towers"] = mesh_towers(dev, ("bottleneck_data2_model2",), paths) \
        + mesh_towers(dev, ("uniform_stack_stage4",), paths)
    res["pinned"] = mesh_pinned(torch, dev, mesh, axes, "data2xmodel2",
                                paths, scale)
    res["paths"] = paths
    return res


def mesh_phase(dev, paths):
    """Phase 14: the mesh executables and the mesh server on the card,
    as ``run_spmd`` worlds of ranks sharing ``dev`` over gloo (NCCL
    refuses two ranks on one GPU): a functional check of the mesh path,
    not a measurement of multi-GPU scaling.  Adds each rank's paths to
    ``paths`` as ``<path>_r<rank>``."""
    from repro_torch.launch.mesh import stop_spmd
    # the mesh cases are shared with the tests; spawned ranks inherit
    # this path
    sys.path.insert(0, str(ROOT / "tests"))
    card = gpu_line() if dev.type == "cuda" else "cpu"
    try:
        for world, fn in ((4, mesh_world_four), (2, mesh_world_two)):
            mesh_world(dev, world, fn, paths, card)
    finally:  # the fork server and resource tracker must not outlive us
        stop_spmd()


def mesh_world(dev, world, fn, paths, card):
    """One world of phase 14: run ``fn`` on ``world`` ranks, add their
    paths to ``paths`` and print what they found."""
    from repro_torch.launch.mesh import default_backend, run_spmd
    backend = default_backend(dev, world)
    check(backend == "gloo" or dev.type == "cpu",
          f"a world of {world} ranks on one card took {backend}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_plans") as cache:
        ranks = run_spmd(fn, world,
                         args=(dev.type, MESH_SCALE, MESH_REPS, cache),
                         device=dev, timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    tag = f"{backend}, {world} ranks on one card ({card})"
    print(f"  world of {world} ranks: {wall:.1f} s wall, spawn included"
          f" [{tag}]")
    if "collectives" in ranks[0]:
        print(f"  collectives on {dev.type} tensors under {backend}, "
              f"each checked on every rank: "
              f"{', '.join(ranks[0]['collectives'])}")
    for r, res in enumerate(ranks):
        for p, counts in res["paths"].items():
            paths[f"{p}_r{r}"] = counts
    a = ranks[0]["alexnet"]
    print(f"  (a) {a['path']}: dp {a['dp']}, tp {a['tp']}, pp "
          f"{a['pp']} nodes; convs {a['convs']}")
    print(f"      host-clock forward, batch {MESH_BATCH}, {MESH_REPS} reps "
          f"[{tag}]: mesh mean {a['mesh_ms']:.4f} ms (min "
          f"{a['mesh_min_ms']:.4f}, ranks "
          f"{[round(q['alexnet']['mesh_ms'], 4) for q in ranks]}); "
          f"single-device plan alone on the card: mean "
          f"{a['one_ms']:.4f} ms (min {a['one_min_ms']:.4f})")
    for t in ranks[0]["towers"]:
        print(f"  (b) {t['path']}: mode {t['mode']}, dp {t['dp']}, tp "
              f"{t['tp']}, pp {t['pp']} nodes")
    for p in ranks[0]["pinned"]:
        print(f"  (c) {p['path']}: {p['convs']} kernel convs, tp "
              f"{p['tp']}, dp {p['dp']} nodes; launches per rank "
              f"{[q['paths'][p['path']] for q in ranks]}")
    if "server" in ranks[0]:
        s = ranks[0]["server"]
        print(f"  (d) mesh PlanServer, 16 requests over buckets "
              f"{s['buckets']}: {s['mesh_compiles']} of "
              f"{s['compiles']} executables mesh-sharded, answers "
              f"within {s['rel_err']:.3e} of the meshless server's "
              f"largest; a fresh server on its cache solved nothing")
    print("  every compared output agrees on every rank with its "
          "single-device plan and a plain one (SUM2D on the card, or "
          "the same selection on the CPU)")


# ---------------------------------------------------------------------
# phase 15: the LM on a mesh (slice G2)
# ---------------------------------------------------------------------
#: (a): TinyLlama-1.1B's depth, unscaled, and the decode steps after the
#: prompts; (b): the training step's (layers, seq, batch), at full width
#: as 13c's (the float64 evaluation it is held to runs on the CPU)
LM_MESH_LAYERS, LM_MESH_STEPS = 22, 16
LM_MESH_TRAIN = (2, 256, 4)
LM_MESH_TIMEOUT_S = 300.0
#: (c): the all-to-all MoE against the single-device gather dispatch,
#: which compute one function when no pair drops: f32 sums in other
#: orders, 1e-5 of the largest magnitude
MOE_A2A_REL = 1e-5


def lm_mesh_grads(torch, out):
    """(b)'s references on the CPU, into ``out``: the f32 loss and
    gradients and a float64 evaluation, of the parameters the ranks
    draw (seed 0, on the card's generator) and the same batch."""
    import _torch_mesh_lm_cases as C
    from repro_torch.models import ModelRuntime, ShardingPlan
    from repro_torch.runtime.train_loop import loss_and_grads
    cfg, batch = C.card_train_inputs(*LM_MESH_TRAIN)
    p = out["params"]
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["cpu"] = loss_and_grads(cfg, ShardingPlan(), ModelRuntime(), p, b)
    out["f64"] = float64_grads(cfg, p, b)


def lm_mesh_phase(torch, F, dev, paths, attn_rpt):
    """Phase 15: (a) TinyLlama-1.1B unscaled on {data: 2, model: 2}
    under the port's ``select_rules`` (H100 figures), each rank's
    prefill and decode logits within ``SERVE_REL`` of the single-device
    flash run, K6 once per layer and prefill on every rank and never in
    decode; K6 at the shard's shape against its plain version; (b) one
    ``train_step`` at 2 layers of full width on the same mesh, its loss
    and gradients held to float64 as 13c holds them; (c) a Jamba-v0.1 MoE
    layer at full width through ``moe_ffn_alltoall`` on {model: 2}
    against the single-device ``moe_ffn``; (d) ``compressed_psum_tree``
    over the 4 ranks against the CPU's arithmetic; (e) one dry-run cell
    (``python -m repro_torch.launch.dryrun``) on the fake process group.
    The worlds share the card over gloo: a functional check, not a
    measurement of scaling.  Adds each rank's calls to ``paths``."""
    import threading

    # the cases are shared with the tests; spawned ranks inherit this path
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import _torch_mesh_lm_cases as C
    from repro_torch.launch.mesh import run_spmd, stop_spmd
    from repro_torch.models import init_params
    from repro_torch.tree import leaves, unflatten
    card = gpu_line() if dev.type == "cuda" else "cpu"
    tag = f"gloo on one card, not scaling ({card})"
    cfg = C.card_config(LM_MESH_LAYERS)
    work = tempfile.mkdtemp(prefix="lm_mesh")
    try:
        t0 = time.perf_counter()
        single_ms = C.card_single(LM_MESH_LAYERS, LM_MESH_STEPS, work,
                                  dev.type)
        # (b)'s CPU references run beside the world (the ranks are
        # processes of their own)
        tcfg, _ = C.card_train_inputs(*LM_MESH_TRAIN)
        pd = init_params(tcfg, 0, torch.float32, dev)
        ref = {"params": unflatten(pd, [t.cpu() for t in leaves(pd)])}
        del pd
        worker = threading.Thread(target=lm_mesh_grads, args=(torch, ref))
        worker.start()
        t1 = time.perf_counter()
        ranks = run_spmd(C.card_lm_world, 4, args=(
            LM_MESH_LAYERS, LM_MESH_STEPS, work, dev.type, C.CARD_PROMPTS,
            LM_MESH_TRAIN), device=dev, timeout_s=LM_MESH_TIMEOUT_S)
        world_s = time.perf_counter() - t1
        worker.join()
        r0 = ranks[0]
        print(f"  select_rules on {dict(zip(*C.CARD_MESH[::-1]))} (H100 "
              f"figures): prefill {r0['assignment']['prefill']}, decode "
              f"{r0['assignment']['decode']}; rules {r0['rules']}")
        worst = C.check_card_lm(ranks, LM_MESH_LAYERS, dev.type, SERVE_REL)
        for res in ranks:
            for call, counts in res["counts"].items():
                paths[f"mesh_lm_{call}_r{res['rank']}"] = counts
        print(f"  (a) {cfg.name}, {cfg.n_layers} layers, {cfg.n_heads} / "
              f"{cfg.n_kv_heads} heads ({r0['local_heads'][0]} / "
              f"{r0['local_heads'][1]} per rank): prompts "
              f"{list(C.CARD_PROMPTS)} prefilled at batch 1 with K6, then "
              f"{LM_MESH_STEPS} decode steps over 4 slots; every rank's "
              f"logits within {worst:.3e} of the single-device f32 run's "
              f"largest, "
              f"{max(max(q['dist64'].values()) for q in ranks):.3e} of the "
              f"float64 run's (the single-device f32 run "
              f"{max(r0['single64'].values()):.3e}; gate: {SERVE_REL}, or "
              f"twice the f32 run's distance from float64); K6 "
              f"{LM_MESH_LAYERS} launches per prefill on every rank, none "
              f"in decode")
        dec = [v for k, v in r0["ms"].items() if k.startswith("dec")]
        sdec = [v for k, v in single_ms.items() if k.startswith("dec")]
        print(f"      host clock [{tag}]: prefill ms "
              + ", ".join(f"T={t}: {r0['ms'][f'prefill{i}']:.1f} (one "
                          f"device {single_ms[f'prefill{i}']:.1f})"
                          for i, t in enumerate(C.CARD_PROMPTS))
              + f"; decode step mean {np.mean(dec[1:]):.1f} ms (one device "
              f"{np.mean(sdec[1:]):.1f}), first {dec[0]:.1f}")
        # (d)
        worst = C.check_card_compress(ranks)
        print(f"  (d) compressed_psum_tree over 4 ranks of "
              f"{C.CARD_COMPRESS_SHAPE}: every rank within {worst:.3e} of "
              f"the largest of the CPU's arithmetic (gate 1e-6)")
        # (b)
        tr = r0["train"]
        grads = torch.load(pathlib.Path(work) / "grads.pt")
        lc, gc_ = ref["cpu"]
        l64, g64 = ref["f64"]
        lc, l64 = float(lc), float(l64)
        e_cpu, e_mesh = leaf_dists(gc_, g64), leaf_dists(grads, g64)
        gate = max(GRAD_REL, 2 * max(e_cpu))
        l_gate = max(TRAIN_LOSS_REL, 2 * abs(lc - l64) / abs(l64))
        check(abs(tr["loss"] - l64) <= l_gate * abs(l64),
              f"(b) loss {tr['loss']} vs float64 {l64} (CPU {lc})")
        check(max(e_mesh) <= gate, f"(b) gradients {e_mesh} of each "
              f"leaf's largest from float64, beyond {gate:.3e} (the CPU's "
              f"{e_cpu})")
        check(tr["finite"] and abs(tr["step_loss"] - tr["loss"]) <=
              1e-6 * abs(tr["loss"]), f"(b) train_step: {tr}")
        print(f"  (b) train_step at {LM_MESH_TRAIN[0]} layers of full width,"
              f" seq {LM_MESH_TRAIN[1]} x batch {LM_MESH_TRAIN[2]}, "
              f"attn_impl xla: loss {tr['loss']} (CPU {lc}, float64 {l64});"
              f" gradients' worst leaf {max(e_mesh):.3e} of its largest "
              f"from float64 (the CPU's {max(e_cpu):.3e}, gate "
              f"{gate:.3e}); AdamW's update finite, parameters "
              f"{tr['placements']}")
        print(f"  world of 4 ranks: {world_s:.1f} s wall, spawn and (b) "
              f"included [{tag}]")
        # K6 at the shard's shape: each rank's heads of the longest prompt
        t_ = max(C.CARD_PROMPTS)
        hq, hk = r0["local_heads"]
        d = cfg.resolved_head_dim
        gen = torch.Generator(device=dev)
        gen.manual_seed(15)
        q_, k_, v_ = (torch.randn((1, t_, h, d), generator=gen, device=dev)
                      for h in (hq, hk, hk))
        hold_k6(torch, F, attn_rpt, {((1, t_, hq, d), (1, t_, hk, d), True):
                                     (q_, k_, v_, {"scale": d ** -0.5,
                                                   "causal": True,
                                                   "window": 0,
                                                   "softcap": 0.0})},
                "mesh shard", sub="mesh_shard")
        # (c)
        t1 = time.perf_counter()
        moe = run_spmd(C.card_moe_world, 2, args=(work, dev.type,
                                                  C.CARD_MOE),
                       device=dev, timeout_s=LM_MESH_TIMEOUT_S)
        m0 = C.check_card_moe(moe, MOE_A2A_REL)
        print(f"  (c) {m0['cfg']} MoE layer through "
              f"moe_ffn_alltoall on {{model: 2}}: {m0['n_local']} tokens "
              f"per rank, capacity {m0['c']}, two all-to-alls of "
              f"{m0['a2a_bytes'] / 1e6:.1f} MB each; within "
              f"{m0['dist']:.3e} of the single-device moe_ffn's largest "
              f"(gate {MOE_A2A_REL}); {m0['ms']:.1f} ms host clock on rank "
              f"0 [{tag}]; world {time.perf_counter() - t1:.1f} s")
        # (e)
        out = pathlib.Path(work) / "dryrun"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "tinyllama-1.1b", "--shape", "decode_32k", "--out", str(out)],
            capture_output=True, text=True, timeout=300,
            env={**__import__("os").environ, "PYTHONPATH": str(SRC)})
        check(proc.returncode == 0, f"(e) dry-run: {proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout)
        check(rec["n_devices"] == 256 and rec["collective_bytes_per_device"]
              > 0, f"(e) dry-run record {rec}")
        counts = {k: v["count"] for k, v in rec["collectives"].items()
                  if v["count"]}
        print(f"  (e) dry-run tinyllama-1.1b/decode_32k on a fake group of "
              f"{rec['n_devices']} ranks: collectives {counts}"
              f", {rec['flops_per_device']:.4g} flops per device, traced in "
              f"{rec['trace_s']:.1f} s")
        print(f"  phase 15 body {time.perf_counter() - t0:.1f} s")
    finally:  # no process of the phase outlives it
        stop_spmd()
        import shutil
        shutil.rmtree(work, ignore_errors=True)


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
    from repro_torch.kernels import all_launches, kernel_libs
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
                   + winograd_transform_phase(torch, dev)
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
        want = all_launches(cnet.sel)
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
        wall, busy, top, _ = device_profile(torch, lambda: cn(x))
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
    # ---- 11. the LM serving path: TinyLlama-1.1B with K6 in prefill ----
    print(f"== lm: {LM_ARCH} at full width and depth through ServeLoop "
          f"(attn_impl=flash, {LM_MAX_BATCH} slots, max_seq {LM_MAX_SEQ}) "
          f"and its ContinuousScheduler ==")
    t0 = time.perf_counter()
    lm_phase(torch, F, dev, paths,
             next(r for r in reports if r.name == "flash_attention"))
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    # ---- 12. the MoE, SSM and hybrid families, encoder-decoder and VLM ----
    print(f"== families: {JAMBA_ARCH} ({JAMBA_LAYERS} layers) and "
          f"{MAMBA_ARCH} served, {WHISPER_ARCH} and {LLAVA_ARCH} "
          f"({LLAVA_LAYERS} layers) through prefill and decode, K6 in every "
          f"prefill's attention ==")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    families_phase(torch, F, dev, paths,
                   next(r for r in reports if r.name == "flash_attention"))
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    # ---- 13. training: TinyLlama-1.1B, the loop, remat, the checkpoint ----
    print(f"== train: {TRAIN_ARCH} at full width and depth through the "
          f"train CLI and train(), AdamW, remat, the checkpointer; the "
          f"trained checkpoint served with K6 ==")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    training_phase(torch, dev, paths,
                   next(r for r in reports if r.name == "flash_attention"))
    print(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    # ---- 14. the mesh: compile_plan(mesh=) and PlanServer(mesh=) ----
    print("== mesh: compile_plan(mesh=) in its four modes and the mesh "
          "PlanServer, as worlds of ranks sharing the card over gloo ==")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_phase(dev, paths)
    print(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
    # ---- 15. the LM on a mesh: ShardingPlan(mesh=) over DTensor ----
    print(f"== lm mesh: TinyLlama-1.1B on {{data: 2, model: 2}} under "
          f"select_rules, K6 on each rank's heads; a train step; the "
          f"all-to-all MoE; the compressed all-reduce; a dry-run cell ==")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_mesh_phase(torch, F, dev, paths,
                  next(r for r in reports if r.name == "flash_attention"))
    print(f"  phase 15 took {time.perf_counter() - t0:.1f} s")
    for r in reports:
        check(not r.on_path or any(c.get(r.counter) for c in paths.values()),
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
