"""Cost providers for the PBQP formulation, on PyTorch.

Port of the reference's ``core/costs.py``: the paper's §3.1 cost stage.

* :class:`ProfiledCostModel` — measures the execution time of every
  (primitive, scenario) pair and of every direct layout transformation
  on tensors of the real sizes, on the device it is given (the card by
  default), as the paper does.  Results are cached on disk keyed by
  (primitive, scenario), one cache per device type.

* :class:`AnalyticCostModel` — the reference's deterministic roofline
  estimate (flops / effective throughput + bytes / bandwidth with
  per-family efficiency factors), formula for formula, so that costs
  under the same :class:`HardwareSpec` equal the reference's.  The
  kernel-backed ``pallas`` primitives are priced only with
  ``include_kernels=True`` (the reference's ``include_tpu_only``).

:data:`H100_SPEC` describes the port's target card.  Its peak rates are
data-sheet figures; its per-family factors are placeholders until the
calibration slice measures them on the card.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.common import resolve_device, true_f32
from .ioutil import atomic_write_text
from .layouts import LAYOUT_BY_NAME, DTGraph, default_dt_graph
from .primitives import Primitive, convert_layout, extension_token, to_tensor
from .scenario import Scenario

__all__ = ["CostModel", "ProfiledCostModel", "AnalyticCostModel",
           "HardwareSpec", "CPU_SPEC", "H100_SPEC",
           "COST_MODEL_SCHEMA", "FUSED_TRANSFORM_DISCOUNT", "time_callable",
           "MeasureCache", "measure_primitive", "measure_fused_primitive",
           "measure_transform", "prim_cost_key", "transform_cost_key",
           "fused_cost_key", "collective_cost_key", "ring_ag_bytes",
           "all_gather_time", "reduce_scatter_time", "all_reduce_time",
           "all_to_all_time", "send_time", "collective_time",
           "COLLECTIVE_KINDS"]

#: bump when the *meaning* of costs changes (units, conventions, embedding)
#: — persisted plan caches keyed on older schemas are invalidated.  Kept
#: equal to the reference's.
COST_MODEL_SCHEMA = 3

#: analytic estimate of how much of a materialized DT round trip a fused
#: prologue/epilogue still pays (the reference's figure).
FUSED_TRANSFORM_DISCOUNT = 0.25


class CostModel:
    """Interface: primitive cost + DT graph with transform costs."""

    def primitive_cost(self, prim: Primitive, scn: Scenario) -> float:
        raise NotImplementedError

    def transform_cost(self, src: str, dst: str,
                       shape_chw: Tuple[int, int, int], dtype) -> float:
        raise NotImplementedError

    # -------------------------------------------------------------
    # fused-edge pricing (per image; the PBQP edge builder scales by
    # the net's minibatch exactly as it does materialized DT costs)
    # -------------------------------------------------------------
    def fused_in_cost(self, prim: Primitive, scn: Scenario,
                      l_src: str) -> float:
        """Extra cost of ``prim`` reading ``l_src``-layout input in its
        prologue instead of its native ``l_in`` (no materialized DT).

        Default heuristic: a fused prologue is one remapped pass over
        the tensor, a fixed fraction of the materialized round trip.
        Capability (``l_src in prim.fusable_in``) is the *selection*
        layer's concern; this prices the transform assuming it fuses.
        """
        if l_src == prim.l_in:
            return 0.0
        return FUSED_TRANSFORM_DISCOUNT * self.transform_cost(
            l_src, prim.l_in, scn.in_shape_chw, scn.dtype)

    def fused_out_cost(self, prim: Primitive, scn: Scenario,
                       l_dst: str) -> float:
        """Extra cost of ``prim`` emitting ``l_dst`` in its epilogue."""
        if l_dst == prim.l_out:
            return 0.0
        return FUSED_TRANSFORM_DISCOUNT * self.transform_cost(
            prim.l_out, l_dst, scn.out_shape_chw, scn.dtype)

    # -------------------------------------------------------------
    # collective pricing (the transform kind of the distributed world:
    # resharding between device placements / sharding rules)
    # -------------------------------------------------------------
    def hardware_spec(self) -> "HardwareSpec":
        """The hardware this model prices; drives collective costs.

        Defaults to the generic CPU spec — models that know their
        target (:class:`AnalyticCostModel`) override this.
        """
        return CPU_SPEC

    def collective_cost(self, kind: str, nbytes: float, n: int) -> float:
        """Seconds for one ``kind`` collective of ``nbytes`` (global
        tensor bytes) over ``n`` chips.  Analytic ring-model default."""
        return collective_time(self.hardware_spec(), kind, nbytes, n)

    def dt_graph(self) -> DTGraph:
        """The library's DT graph priced by this model's transform_cost."""
        g = default_dt_graph()
        out = DTGraph()
        for (s, t) in g.direct_edges:
            out.add_transform(
                s, t,
                lambda shape, dtype, s=s, t=t:
                    self.transform_cost(s, t, shape, dtype))
        return out

    # -------------------------------------------------------------
    def version(self) -> str:
        """Cache-version fingerprint of this cost model.

        Any change that could alter a primitive's cost (model class,
        hardware spec, schema) must change this string: the serving plan
        cache (repro/serving/plan_cache.py) keys persisted PBQP solutions
        on it, so a stale cost model can never serve a stale plan.

        The registry extension token is folded in for every model: a
        solve's choice space is the registry, so installing/removing an
        autotuned variant catalog (``primitives.register_extension``)
        must rotate every cached plan key even though no individual cost
        changed.
        """
        return _digest(f"schema{COST_MODEL_SCHEMA}", type(self).__name__,
                       f"ext={extension_token()}", self._version_fields())

    def _version_fields(self) -> str:
        """Subclass hook: stringify everything costs depend on."""
        return ""


def _digest(*parts: str) -> str:
    h = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
    return h


# ----------------------------------------------------------------------
# measurement discipline (shared by ProfiledCostModel and the measure_*
# helpers)
# ----------------------------------------------------------------------
def _sync(args) -> None:
    """Wait for the device work queued on the args' device, if any."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)
            return
        if isinstance(a, dict):
            for v in a.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    torch.cuda.synchronize(v.device)
                    return


def time_callable(fn, args, *, reps: int = 3, min_time: float = 5e-3,
                  warmup: int = 1) -> float:
    """Median-of-reps wall time of a callable (seconds).

    ``warmup`` untimed calls absorb first-touch effects (kernel builds,
    cuDNN / cuFFT plans); each of the ``reps`` timed repetitions then
    loops the call until at least ``min_time`` seconds elapse and
    records the mean per-call time.  On the card every call ends in
    ``torch.cuda.synchronize()``, so the clock sees device time; on the
    CPU ``perf_counter`` alone.  Library calls run in true f32 (TF32
    off), as ``CompiledNet`` runs them.
    """
    with true_f32():
        for _ in range(max(warmup, 1)):
            fn(*args)
        _sync(args)
        times = []
        for _ in range(reps):
            n = 0
            t0 = time.perf_counter()
            el = 0.0
            while el < min_time:
                fn(*args)
                _sync(args)
                n += 1
                el = time.perf_counter() - t0
            times.append(el / n)
    return float(np.median(times))


def prim_cost_key(name: str, scn: Scenario) -> str:
    """Cache/profile entry key for one (primitive, scenario) pair."""
    return f"prim::{name}::{scn.key()}"


def transform_cost_key(src: str, dst: str,
                       shape_chw: Tuple[int, int, int]) -> str:
    """Cache/profile entry key for one direct layout transform."""
    return f"dt::{src}->{dst}::{'x'.join(map(str, shape_chw))}"


def fused_cost_key(kind: str, name: str, layout: str, scn: Scenario) -> str:
    """Cache/profile entry key for one fused (primitive, layout) pair.

    ``kind`` is ``"in"`` (prologue reads ``layout``) or ``"out"``
    (epilogue emits ``layout``); the stored value is the whole fused
    invocation time.
    """
    if kind not in ("in", "out"):
        raise ValueError(f"kind must be 'in' or 'out', got {kind!r}")
    return f"fuse{kind}::{name}::{layout}::{scn.key()}"


class MeasureCache:
    """Seed-0 draws and packed weights shared by a run of measurements.

    A calibration sweep measures every primitive of a scenario bucket,
    natively and once per fused layout, at batch 1 and 8, on the same
    draws; packing the weights (``prim.prepare``: FFT and Winograd weight
    transforms in numpy) then takes more host time than the measurements
    themselves.  This keeps the newest draws and packings, so each
    (primitive, bucket) is packed once.  The values are what an uncached
    measurement makes, and packing stays outside the timed region.
    """

    #: entries kept: one bucket's primitives
    SIZE = 64

    def __init__(self) -> None:
        self._draws: "OrderedDict[Scenario, tuple]" = OrderedDict()
        self._packed: "OrderedDict[tuple, Dict[str, torch.Tensor]]" = \
            OrderedDict()

    @staticmethod
    def _get(table: OrderedDict, key, make):
        if key in table:
            table.move_to_end(key)
        else:
            table[key] = make()
            while len(table) > MeasureCache.SIZE:
                table.popitem(last=False)
        return table[key]

    def draws(self, scn: Scenario):
        """Weights, bias and logical (N)CHW input, drawn in that order
        from ``default_rng(0)``."""
        def make():
            rng = np.random.default_rng(0)
            w = (rng.normal(size=scn.weight_shape) * 0.1).astype(np.float32)
            b = rng.normal(size=(scn.m,)).astype(np.float32)
            x = rng.normal(size=scn.in_shape_chw if scn.n == 1
                           else scn.in_shape_nchw).astype(np.float32)
            return w, b, x
        return self._get(self._draws, scn, make)

    def packed(self, prim: Primitive, scn: Scenario, device):
        """``prim.prepare`` of the scenario's weights, on ``device``
        (packing does not depend on the batch)."""
        def make():
            w, b, _ = self.draws(scn)
            return {k: v.to(device) for k, v in
                    prim.prepare(scn, w.copy(), b.copy()).items()}
        return self._get(self._packed,
                         (prim.name, scn.with_(n=1), str(device)), make)


def _synth(prim: Primitive, scn: Scenario, layout: str, device,
           cache: Optional[MeasureCache]):
    """Packed weights and an input in ``layout`` at the scenario's real
    sizes, on ``device`` (single image for n == 1, else batched)."""
    cache = cache or MeasureCache()
    lay = LAYOUT_BY_NAME[layout]
    _, _, x = cache.draws(scn)
    x = lay.to_memory(x) if scn.n == 1 else \
        np.stack([lay.to_memory(xi) for xi in x])
    return (to_tensor(x).to(device, copy=True),
            cache.packed(prim, scn, device))


def measure_primitive(prim: Primitive, scn: Scenario, *, reps: int = 3,
                      min_time: float = 5e-3, device=None,
                      cache: Optional[MeasureCache] = None) -> float:
    """On-device wall time of one (primitive, scenario) pair (seconds).

    Weights are packed once via ``prim.prepare`` (deployment-time work,
    excluded from the measurement; ``cache`` shares it between the
    measurements of a sweep); for ``scn.n > 1`` the whole batched
    invocation is timed, as ``compile_plan(batch=n)`` runs it.
    """
    xin, packed = _synth(prim, scn, prim.l_in, resolve_device(device),
                         cache)
    return time_callable(prim.make(scn), (xin, packed), reps=reps,
                         min_time=min_time)


def measure_fused_primitive(prim: Primitive, scn: Scenario, *,
                            l_in: Optional[str] = None,
                            l_out: Optional[str] = None,
                            reps: int = 3, min_time: float = 5e-3,
                            device=None,
                            cache: Optional[MeasureCache] = None) -> float:
    """On-device wall time of one *fused* invocation (seconds): the input
    in the fused ``l_in`` layout, the callable
    ``prim.make_fused(scn, l_in, l_out)``."""
    xin, packed = _synth(prim, scn, l_in or prim.l_in,
                         resolve_device(device), cache)
    return time_callable(prim.make_fused(scn, l_in=l_in, l_out=l_out),
                         (xin, packed), reps=reps, min_time=min_time)


def measure_transform(src: str, dst: str,
                      shape_chw: Tuple[int, int, int], *, reps: int = 3,
                      min_time: float = 5e-3, device=None) -> float:
    """On-device wall time of one direct layout transform (seconds)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape_chw).astype(np.float32)
    xin = to_tensor(LAYOUT_BY_NAME[src].to_memory(x)).to(
        resolve_device(device))
    return time_callable(lambda a: convert_layout(a, src, dst), (xin,),
                         reps=reps, min_time=min_time)


class ProfiledCostModel(CostModel):
    """Measured costs on ``device`` (the card unless told otherwise).

    The kernel primitives are measured like every other: on the card
    they run their CUDA kernels, on the CPU their plain versions.  The
    on-disk cache defaults to ``~/.cache/repro_torch_profile_<device
    type>.json`` (``$REPRO_TORCH_PROFILE_CACHE`` overrides), apart from
    the reference's cache.
    """

    def __init__(self, cache_path: Optional[str] = None, *,
                 device=None, reps: int = 3, min_time: float = 5e-3,
                 exclude_tags: Tuple[str, ...] = (),
                 verbose: bool = False):
        self.device = resolve_device(device)
        self.reps = reps
        self.min_time = min_time
        self.exclude_tags = exclude_tags
        self.verbose = verbose
        self.cache_path = pathlib.Path(
            cache_path or os.environ.get(
                "REPRO_TORCH_PROFILE_CACHE",
                pathlib.Path.home() / ".cache" /
                f"repro_torch_profile_{self.device.type}.json"))
        self._cache: Dict[str, float] = {}
        if self.cache_path.exists():
            self._cache = json.loads(self.cache_path.read_text())
        self._dirty = 0

    # -------------------------------------------------------------
    def _save(self):
        self.cache_path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(self.cache_path, json.dumps(self._cache))
        self._dirty = 0

    def flush(self):
        if self._dirty:
            self._save()

    def _version_fields(self) -> str:
        # the measurements ARE the cost model: hash them, so re-profiling
        # can never serve plans that were optimal only for old numbers
        content = hashlib.sha256(
            json.dumps(sorted(self._cache.items())).encode()).hexdigest()[:16]
        return (f"profile={content}|reps={self.reps}"
                f"|min_time={self.min_time}|excl={sorted(self.exclude_tags)}"
                f"|device={self.device.type}")

    def _record(self, key: str, t: float) -> float:
        self._cache[key] = t
        self._dirty += 1
        if self._dirty >= 20:
            self._save()
        return t

    def primitive_cost(self, prim: Primitive, scn: Scenario) -> float:
        if any(t in prim.tags for t in self.exclude_tags):
            return float("inf")
        key = prim_cost_key(prim.name, scn)
        if key in self._cache:
            return self._cache[key]
        t = measure_primitive(prim, scn, reps=self.reps,
                              min_time=self.min_time, device=self.device)
        if self.verbose:
            print(f"  profiled {prim.name} on {scn.key()}: {t*1e3:.3f} ms")
        return self._record(key, t)

    def transform_cost(self, src: str, dst: str,
                       shape_chw: Tuple[int, int, int], dtype) -> float:
        from .layouts import transform_feasible
        if not transform_feasible(src, dst, shape_chw):
            return float("inf")
        key = transform_cost_key(src, dst, shape_chw)
        if key in self._cache:
            return self._cache[key]
        return self._record(key, measure_transform(
            src, dst, shape_chw, reps=self.reps, min_time=self.min_time,
            device=self.device))

    # -------------------------------------------------------------
    def _fused_cost(self, kind: str, prim: Primitive, scn: Scenario,
                    layout: str) -> float:
        """Measured fused-edge delta: fused invocation − native, >= 0,
        per image (the selection layer scales by the minibatch)."""
        if any(t in prim.tags for t in self.exclude_tags):
            return float("inf")
        from .layouts import transform_feasible
        native = prim.l_in if kind == "in" else prim.l_out
        shape = scn.in_shape_chw if kind == "in" else scn.out_shape_chw
        if layout == native:
            return 0.0
        if not transform_feasible(layout, native, shape):
            return float("inf")
        scn1 = scn.with_(n=1)
        key = fused_cost_key(kind, prim.name, layout, scn1)
        if key not in self._cache:
            kw = {"l_in": layout} if kind == "in" else {"l_out": layout}
            t = measure_fused_primitive(prim, scn1, reps=self.reps,
                                        min_time=self.min_time,
                                        device=self.device, **kw)
            if self.verbose:
                print(f"  profiled fuse-{kind} {prim.name} <- {layout} on "
                      f"{scn1.key()}: {t*1e3:.3f} ms")
            self._record(key, t)
        return max(0.0, self._cache[key] - self.primitive_cost(prim, scn1))

    def fused_in_cost(self, prim: Primitive, scn: Scenario,
                      l_src: str) -> float:
        return self._fused_cost("in", prim, scn, l_src)

    def fused_out_cost(self, prim: Primitive, scn: Scenario,
                       l_dst: str) -> float:
        return self._fused_cost("out", prim, scn, l_dst)


# ----------------------------------------------------------------------
@dataclass
class HardwareSpec:
    name: str
    peak_flops: float          # f32 FLOP/s
    mem_bw: float              # B/s
    #: per-chip interconnect bandwidth (B/s, one direction): ICI links on
    #: a TPU pod, shared-memory "fabric" between fake CPU devices.  0
    #: means no fabric — every collective prices infinite, so selection
    #: can never pick a sharded choice on fabric-less hardware.
    link_bw: float = 0.0
    #: fraction of peak a family's GEMM-ish inner loop typically reaches
    family_eff: Dict[str, float] = field(default_factory=dict)
    #: per-*invocation* setup seconds (buffer allocation, GEMM/FFT
    #: planning, tile-transform dispatch) — paid once per call, so it
    #: amortizes over the minibatch.  This is the term that makes the
    #: optimal primitive flip with N: GEMM-based methods pay a large
    #: setup that a batch spreads out, direct loops barely any.
    family_setup: Dict[str, float] = field(default_factory=dict)


CPU_SPEC = HardwareSpec(
    name="cpu-generic",
    peak_flops=1.0e11,
    mem_bw=2.0e10,
    link_bw=1.0e10,            # fake-device "fabric": memcpy through RAM
    family_eff={"direct": 0.30, "im2": 0.55, "kn2": 0.50,
                "winograd": 0.45, "fft": 0.35, "pallas": 0.0},
    family_setup={"direct": 1e-6, "im2": 2e-5, "kn2": 1.5e-5,
                  "winograd": 3e-5, "fft": 4e-5, "pallas": 0.0},
)

#: NVIDIA H100 SXM5 (data sheet): 67 TFLOP/s f32 on the CUDA cores (the
#: rate of the port's f32-FMA kernels; the tensor cores' TF32 is not
#: used, for true-f32 parity), 3.35 TB/s HBM3, NVLink 900 GB/s of which
#: 450 GB/s each way.  The per-family efficiency and setup factors are
#: the reference's TPU figures carried over as PLACEHOLDERS: nothing has
#: measured them on the card yet (the calibration slice will).
H100_SPEC = HardwareSpec(
    name="h100-sxm",
    peak_flops=67e12,
    mem_bw=3.35e12,
    link_bw=450e9,
    family_eff={"direct": 0.45, "im2": 0.65, "kn2": 0.55,
                "winograd": 0.55, "fft": 0.25, "pallas": 0.70},
    family_setup={"direct": 2e-6, "im2": 5e-6, "kn2": 5e-6,
                  "winograd": 8e-6, "fft": 1e-5, "pallas": 3e-6},
)


# ----------------------------------------------------------------------
# collective pricing (shared by sharding selection, the placement axis
# of layout selection, and CalibratedCostModel's fallback path)
# ----------------------------------------------------------------------
def ring_ag_bytes(nbytes: float, n: int) -> float:
    """Ring all-gather over ``n`` chips moves (n-1)/n of the tensor per
    link (same bytes for its mirror image, reduce-scatter)."""
    return float(nbytes) * (n - 1) / max(n, 1)


def all_gather_time(spec: HardwareSpec, nbytes: float, n: int) -> float:
    """Ring all-gather seconds for an ``nbytes`` *global* tensor."""
    if n <= 1:
        return 0.0
    if spec.link_bw <= 0:
        return float("inf")
    return ring_ag_bytes(nbytes, n) / spec.link_bw


def reduce_scatter_time(spec: HardwareSpec, nbytes: float, n: int) -> float:
    """Ring reduce-scatter: byte-symmetric with the all-gather."""
    return all_gather_time(spec, nbytes, n)


def all_reduce_time(spec: HardwareSpec, nbytes: float, n: int) -> float:
    """Ring all-reduce = reduce-scatter + all-gather."""
    return 2.0 * all_gather_time(spec, nbytes, n)


def all_to_all_time(spec: HardwareSpec, nbytes: float, n: int) -> float:
    """All-to-all: every chip ships ~its whole shard across the fabric
    (the MoE dispatch/combine pattern)."""
    if n <= 1:
        return 0.0
    if spec.link_bw <= 0:
        return float("inf")
    return float(nbytes) / spec.link_bw


def send_time(spec: HardwareSpec, nbytes: float, n: int) -> float:
    """Point-to-point activation transfer (the pipeline stage-boundary
    hop): the whole tensor crosses one link.  ``n`` is the number of
    participants — a 1-wide group is a no-op transfer and must price
    0.0 so degenerate meshes stay exactly rep-equivalent."""
    if n <= 1:
        return 0.0
    if spec.link_bw <= 0:
        return float("inf")
    return float(nbytes) / spec.link_bw


COLLECTIVE_KINDS = {
    "all_gather": all_gather_time,
    "reduce_scatter": reduce_scatter_time,
    "all_reduce": all_reduce_time,
    "all_to_all": all_to_all_time,
    "send": send_time,
}


def collective_time(spec: HardwareSpec, kind: str, nbytes: float,
                    n: int) -> float:
    """Analytic time of one collective over ``n`` chips (seconds)."""
    try:
        fn = COLLECTIVE_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown collective kind {kind!r}; "
                         f"one of {sorted(COLLECTIVE_KINDS)}") from None
    return fn(spec, nbytes, n)


def collective_cost_key(kind: str, nbytes: int, n: int) -> str:
    """Cache/profile entry key for one measured collective.

    ``nbytes`` should be bucketed (pow2) by the caller so one pod sweep
    covers every payload size serving produces; stored value is seconds
    for the whole collective over ``n`` participants.
    """
    if kind not in COLLECTIVE_KINDS:
        raise ValueError(f"unknown collective kind {kind!r}; "
                         f"one of {sorted(COLLECTIVE_KINDS)}")
    return f"coll::{kind}::b{int(nbytes)}::n{int(n)}"


#: per-grid-step dispatch cost of a Pallas kernel (seconds): each tile
#: of the grid pays a fetch/issue overhead, so undersized tiles on large
#: problems price slower — the term that bounds how small a useful
#: autotuned block can be.
PALLAS_GRID_STEP_S = 2e-8


def _tile_waste(dim: int, b: int) -> float:
    """Flop inflation from padding ``dim`` up to a multiple of ``b``."""
    if dim <= 0:
        return 1.0
    return (-(-dim // b) * b) / dim


def _tile_steps(dim: int, b: int) -> int:
    return max(1, -(-dim // b))


def _clamp_block(b: int, dim: int) -> int:
    """The block size the kernel wrappers actually run: requested block
    clamped to the (>=8) problem dim — mirrors ``min(b, max(8, dim))``
    in the reference's Pallas wrappers."""
    return min(int(b), max(8, int(dim)))


def _lane_eff(b: int) -> float:
    """MXU efficiency of a tile whose minor (lane) extent is ``b``."""
    return 1.0 if b % 128 == 0 else (0.9 if b % 8 == 0 else 0.7)


def _sublane_eff(b: int) -> float:
    return 1.0 if b % 8 == 0 else 0.75


class AnalyticCostModel(CostModel):
    """Roofline estimate of one (possibly batched) invocation:

        t = max(N*flops / (eff * peak), (N*act_bytes + w_bytes) / bw)
            + setup

    with per-family algorithmic flop counts (Winograd/FFT discounts,
    im2col Toeplitz traffic, ...).  Activation traffic scales with the
    minibatch N (= ``scn.n``); weight traffic and the per-invocation
    ``setup`` do not — the two asymmetries that make primitive selection
    batch-dependent."""

    def __init__(self, spec: HardwareSpec = CPU_SPEC,
                 include_kernels: bool = False):
        self.spec = spec
        self.include_kernels = include_kernels

    def _version_fields(self) -> str:
        s = self.spec
        eff = ",".join(f"{k}={v}" for k, v in sorted(s.family_eff.items()))
        setup = ",".join(f"{k}={v}"
                         for k, v in sorted(s.family_setup.items()))
        return (f"spec={s.name}|flops={s.peak_flops}|bw={s.mem_bw}"
                f"|link={s.link_bw}|{eff}"
                f"|setup={setup}|kernels={self.include_kernels}")

    def hardware_spec(self) -> HardwareSpec:
        return self.spec

    def _alg_flops_bytes(self, prim: Primitive, scn: Scenario):
        """(total flops, per-image activation bytes, weight bytes)."""
        el = 4  # f32
        act_bytes = el * (np.prod(scn.in_shape_chw) +
                          np.prod(scn.out_shape_chw))
        w_bytes = el * np.prod(scn.weight_shape)
        f = float(scn.flops)  # whole batch (scn.macs includes n)
        fam = prim.family
        if fam == "winograd":
            # m^2 outputs per alpha^2 multiplies (2-D); 1-D variants save
            # less.  Extract tile size from the name (wino{1,2}d_f{m}x{k}).
            m_ = int(prim.name.split("_f")[1][0])
            a = m_ + scn.k - 1
            if "2d" in prim.name:
                f = f * (a * a) / (m_ * m_ * scn.k * scn.k)
                f += 2.0 * el * np.prod(scn.in_shape_nchw)  # transforms
            else:
                f = f * a / (m_ * scn.k)
            act_bytes *= 2.5  # tile workspace traffic
            w_bytes *= 2.5
        elif fam == "fft":
            c, h, w = scn.in_shape_chw
            npix = (h + scn.k) * (w + scn.k)
            f = scn.n * (10.0 * npix * np.log2(max(npix, 2))
                         * (scn.c + scn.m) + 8.0 * npix * scn.c * scn.m)
            act_bytes *= 3.0
            w_bytes *= 3.0
        elif fam == "im2":
            act_bytes += el * scn.k * scn.k * np.prod(scn.in_shape_chw)
            if "split" in prim.name:
                act_bytes *= 0.6
                w_bytes *= 0.6
        elif fam == "kn2":
            act_bytes += el * scn.k * scn.k * np.prod(scn.out_shape_chw)
        elif fam == "direct":
            if "sum2d" in prim.name:
                f *= 4.0   # per-channel dispatch overhead
            if "shift" in prim.name:
                act_bytes += el * scn.k * scn.k * np.prod(scn.out_shape_chw)
        elif fam == "pallas":
            # the Pallas kernels inherit their algorithmic cousins'
            # traffic/flop shapes: the im2col GEMM materializes a
            # K^2-inflated Toeplitz matrix through HBM, Winograd trades
            # a flop discount for transform workspace traffic, and the
            # direct/pointwise kernels stream the VMEM-resident strip
            # with no extra HBM traffic.
            if "im2col" in prim.name:
                act_bytes += el * scn.k * scn.k * np.prod(scn.in_shape_chw)
            elif "wino" in prim.name:
                m_ = int(prim.name.split("_f")[1][0])
                a = m_ + scn.k - 1
                f = f * (a * a) / (m_ * m_ * scn.k * scn.k)
                f += 2.0 * el * np.prod(scn.in_shape_nchw)
                act_bytes *= 2.5
                w_bytes *= 2.5
        return f, float(act_bytes), float(w_bytes)

    def _pallas_tile_terms(self, prim: Primitive, scn: Scenario):
        """(flop waste, MXU alignment efficiency, extra setup seconds)
        of a Pallas kernel's tiling at this scenario.

        This is the reference's TPU tiling model, kept formula for
        formula so that costs equal the reference's under the same
        spec; it does not describe the CUDA kernels' 64 x 64 tiles
        (a placeholder until calibration measures the card).

        Generated variants carry their block sizes in ``prim.params``;
        hand-written entries price at the wrappers' 128-defaults.  Both
        go through the same clamping the ops wrappers apply, so the
        model prices the tiles the kernel actually runs: padding waste
        (dims rounded up to tile multiples burn real MXU cycles on
        zeros), lane/sublane alignment (tiles off the (8, 128) register
        tiling stall the MXU), and per-grid-step dispatch (the
        software-pipeline depth cost of slicing a problem into many
        tiny tiles).
        """
        p = dict(prim.params)
        name = prim.name
        ohow = scn.out_h * scn.out_w
        if "pw_gemm" in name or "im2col" in name:
            kdim = scn.c if "pw_gemm" in name else scn.c * scn.k * scn.k
            bm = _clamp_block(p.get("bm", 128), scn.m)
            bn = _clamp_block(p.get("bn", 128), ohow)
            bk = _clamp_block(p.get("bk", 128), kdim)
            waste = (_tile_waste(scn.m, bm) * _tile_waste(ohow, bn)
                     * _tile_waste(kdim, bk))
            align = _lane_eff(bn) * _lane_eff(bk) * _sublane_eff(bm)
            steps = (_tile_steps(scn.m, bm) * _tile_steps(ohow, bn)
                     * _tile_steps(kdim, bk))
        elif "wino" in name:
            m_ = int(name.split("_f")[1][0])
            a = m_ + scn.k - 1
            ntiles = -(-scn.out_h // m_) * -(-scn.out_w // m_)
            bn = _clamp_block(p.get("bn", 128), ntiles)
            bc = _clamp_block(p.get("bc", 128), scn.c)
            waste = _tile_waste(ntiles, bn) * _tile_waste(scn.c, bc)
            align = _lane_eff(bn) * _sublane_eff(bc)
            steps = a * a * _tile_steps(ntiles, bn) * _tile_steps(scn.c, bc)
        elif "direct" in name:
            bm = _clamp_block(p.get("bm", 128), scn.m)
            kk = scn.k * scn.k
            waste = _tile_waste(scn.m, bm)
            align = _lane_eff(bm)
            steps = _tile_steps(scn.m, bm) * kk
            if p.get("unroll", 1):
                if kk >= 25:  # 5x5 fully unrolled: code-size pressure
                    align *= 0.95
            else:  # rolled tap loop: per-tap control flow
                steps += 4 * kk
        else:
            return 1.0, 1.0, 0.0
        return waste, align, PALLAS_GRID_STEP_S * steps * scn.n

    def primitive_cost(self, prim: Primitive, scn: Scenario) -> float:
        if "kernel" in prim.tags and not self.include_kernels:
            return float("inf")
        eff = self.spec.family_eff.get(prim.family, 0.3)
        if eff <= 0:
            return float("inf")
        f, act_b, w_b = self._alg_flops_bytes(prim, scn)
        setup = self.spec.family_setup.get(prim.family, 0.0)
        if prim.family == "pallas":
            waste, align, extra = self._pallas_tile_terms(prim, scn)
            f *= waste
            eff *= align
            setup += extra
        return max(f / (eff * self.spec.peak_flops),
                   (scn.n * act_b + w_b) / self.spec.mem_bw) + setup

    def transform_cost(self, src, dst, shape_chw, dtype) -> float:
        """Cost of transforming ONE image; the PBQP edge builder scales
        by the net's minibatch (see ``core.selection._build``)."""
        from .layouts import transform_feasible
        if not transform_feasible(src, dst, shape_chw):
            return float("inf")
        nbytes = 4 * int(np.prod(shape_chw))
        return 2 * nbytes / (0.25 * self.spec.mem_bw)
