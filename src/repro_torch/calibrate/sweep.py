"""Calibration sweep: plan and run on-device measurements.

Port of the reference's ``calibrate/sweep.py``: the same plan, item for
item and key for key, with two differences.  Every measurement runs on
the device ``plan_sweep`` is given (the card unless told otherwise), and
the kernel primitives are excluded by their tag ``kernel`` where the
reference excludes ``tpu-only``.

Two phases, so coverage is inspectable before any timing happens:

* :func:`plan_sweep` enumerates every measurement a profile should hold
  — one :class:`SweepItem` per applicable (primitive, scenario-bucket)
  pair, per feasible direct layout transform at each bucketed tensor
  shape, and per standalone kernel microbenchmark (``benchmark_entry``
  in each of the six :mod:`repro_torch.kernels` packages).  This
  is what ``launch/calibrate.py --dry-run`` prints.

* :func:`run_sweep` executes the items against a
  :class:`~repro_torch.calibrate.profile.HardwareProfile`, skipping keys the
  profile already holds — interrupting a sweep loses at most
  ``save_every`` measurements, and re-running the CLI resumes where it
  stopped.

Scenario grids are *bucket* grids: the same canonicalization
(:func:`repro_torch.serving.bucketing.bucket_scenario`) the
:class:`~repro_torch.calibrate.model.CalibratedCostModel` applies at lookup
time is applied at plan time, so every measured key is reachable from a
live scenario.  :func:`scenarios_from_net` plans the exact buckets one
network needs — the cheap way to calibrate for a known workload.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.costs import (
    MeasureCache, fused_cost_key, measure_fused_primitive, measure_primitive,
    measure_transform, prim_cost_key, transform_cost_key,
)
from ..core.layouts import default_dt_graph, transform_feasible
from ..core.primitives import primitives_for
from ..core.scenario import Scenario
from ..serving.bucketing import BucketPolicy, bucket_scenario, bucket_shape
from .profile import HardwareProfile

__all__ = ["SweepItem", "scenario_grid", "scenarios_from_net",
           "plan_sweep", "run_sweep", "GRIDS"]


@dataclass(frozen=True)
class SweepItem:
    """One planned measurement: a profile key plus how to produce it."""

    kind: str    # "prim" | "dt" | "kernel"
    key: str     # HardwareProfile entry key
    label: str   # human-readable (family:name @ scenario)
    #: (reps, min_time) -> seconds; only called by run_sweep, so planning
    #: (and --dry-run) never allocates tensors or compiles anything
    measure: Callable[[int, float], float]


# ----------------------------------------------------------------------
# scenario grids
# ----------------------------------------------------------------------
#: named grids for the CLI; (channels, spatial sizes, ks, strides, m-mults)
GRIDS: Dict[str, Tuple[Sequence[int], Sequence[int], Sequence[int],
                       Sequence[int], Sequence[int]]] = {
    "tiny": ((8,), (16,), (3,), (1,), (2,)),
    "small": ((8, 16), (16, 32), (1, 3), (1,), (1, 2)),
    "default": ((8, 16, 32, 64), (16, 32, 64), (1, 3, 5), (1, 2), (1, 2)),
}


def scenario_grid(name: str = "default", *,
                  policy: Optional[BucketPolicy] = None,
                  batches: Sequence[int] = (1,)) -> List[Scenario]:
    """The named bucket grid (deduplicated, canonicalized).

    ``batches`` adds a minibatch axis: every spatial/channel bucket is
    emitted once per batch bucket, so one sweep can price both the
    latency (N=1) and throughput (N>1) serving paths — batched entries
    time the whole-batch invocation (see
    :func:`repro_torch.core.costs.measure_primitive`).
    """
    try:
        channels, sizes, ks, strides, m_mults = GRIDS[name]
    except KeyError:
        raise ValueError(f"unknown grid {name!r}; one of {sorted(GRIDS)}")
    policy = policy or BucketPolicy()
    out, seen = [], set()
    for c in channels:
        for hw in sizes:
            for k in ks:
                for s in strides:
                    for mm in m_mults:
                        for n in batches:
                            scn = bucket_scenario(
                                Scenario(c=c, h=hw, w=hw, stride=s, k=k,
                                         m=c * mm, n=n), policy)
                            if scn.key() not in seen:
                                seen.add(scn.key())
                                out.append(scn)
    return out


def scenarios_from_net(net, *, policy: Optional[BucketPolicy] = None,
                       batches: Sequence[int] = (1,)) -> List[Scenario]:
    """The bucketed scenarios of one network's conv layers (one per
    batch bucket in ``batches``)."""
    policy = policy or BucketPolicy()
    out, seen = [], set()
    for node in net.conv_nodes():
        for n in batches:
            scn = bucket_scenario(node.scn.with_(n=n), policy)
            if scn.key() not in seen:
                seen.add(scn.key())
                out.append(scn)
    return out


# ----------------------------------------------------------------------
# planning
# ----------------------------------------------------------------------
def _kernel_benchmarks():
    """The six kernel packages' ``benchmark_entry`` hooks (lazy import).
    Each launches one hand-written CUDA kernel on the card."""
    from ..kernels import (
        conv_direct, conv_im2col, flash_attention, layout_transform,
        matmul, winograd_gemm,
    )
    return [("conv_direct", conv_direct.benchmark_entry),
            ("conv_im2col", conv_im2col.benchmark_entry),
            ("winograd_gemm", winograd_gemm.benchmark_entry),
            ("matmul", matmul.benchmark_entry),
            ("flash_attention", flash_attention.benchmark_entry),
            ("layout_transform", layout_transform.benchmark_entry)]


#: layouts fused-pair measurements cover by default: the layouts
#: primitives natively produce/consume — the ones fused edges can
#: actually carry in a selected plan (sweeping all 7 would mostly time
#: pairs no optimum ever uses)
FUSE_SWEEP_LAYOUTS = ("CHW", "HWC", "HCW", "HWC8")


def plan_sweep(scenarios: Sequence[Scenario], *,
               families: Optional[Sequence[str]] = None,
               exclude_tags: Sequence[str] = ("kernel",),
               dt: bool = True, kernels: bool = False, fused: bool = True,
               fuse_layouts: Sequence[str] = FUSE_SWEEP_LAYOUTS,
               policy: Optional[BucketPolicy] = None,
               device=None) -> List[SweepItem]:
    """Enumerate the measurements a profile over ``scenarios`` needs.

    ``exclude_tags`` defaults to skipping the ``kernel`` primitives — on
    the CPU only their plain versions run, whose timings price no
    kernel, and a CPU profile must never price one.  ``kernels`` adds
    the standalone kernel microbenchmarks (the CLI enables them on an
    sm_90 card, where the kernels run).  ``device`` is where every item
    is measured (the card by default); planning touches no device.

    ``fused`` plans one measurement per (primitive, fusable layout)
    pair — the whole fused invocation via
    :func:`~repro_torch.core.costs.measure_fused_primitive`, keyed
    ``fuse{in,out}::…`` — so :class:`~repro_torch.calibrate.model.
    CalibratedCostModel` can serve *measured* fused-edge deltas instead
    of the analytic discount.  Only single-image scenarios plan fused
    pairs (deltas are per image; the selection layer scales by batch).

    Batched scenarios (``scn.n > 1``) plan one *prim* measurement per
    (primitive, scenario, batch-bucket) — the key carries the batch via
    ``Scenario.key()``.  Layout-transform (*dt*) measurements stay
    per-image: transform cost is linear in the batch, so the selection
    layer scales the single-image number instead of re-measuring it at
    every N.
    """
    policy = policy or BucketPolicy()
    items: List[SweepItem] = []
    seen = set()
    cache = MeasureCache()  # the items' shared draws and packed weights

    def add(item: SweepItem) -> None:
        if item.key not in seen:
            seen.add(item.key)
            items.append(item)

    shapes = set()
    for raw in scenarios:
        scn = bucket_scenario(raw, policy)
        shapes.add(bucket_shape(scn.in_shape_chw, policy))
        shapes.add(bucket_shape(scn.out_shape_chw, policy))
        for p in primitives_for(scn, families=families,
                                exclude_tags=exclude_tags):
            add(SweepItem(
                "prim", prim_cost_key(p.name, scn),
                f"{p.family}:{p.name} @ {scn.key()}",
                lambda reps, min_time, p=p, scn=scn:
                    measure_primitive(p, scn, reps=reps,
                                      min_time=min_time, device=device,
                                      cache=cache)))
            if fused and scn.n == 1:
                for kind, caps, native, shape in (
                        ("in", p.fusable_in, p.l_in, scn.in_shape_chw),
                        ("out", p.fusable_out, p.l_out, scn.out_shape_chw)):
                    for lay in caps:
                        if lay == native or lay not in fuse_layouts:
                            continue
                        if not transform_feasible(lay, native, shape):
                            continue
                        kw = {"l_in": lay} if kind == "in" \
                            else {"l_out": lay}
                        add(SweepItem(
                            "fuse", fused_cost_key(kind, p.name, lay, scn),
                            f"fuse-{kind}:{p.name} {lay} @ {scn.key()}",
                            lambda reps, min_time, p=p, scn=scn, kw=kw:
                                measure_fused_primitive(
                                    p, scn, reps=reps, min_time=min_time,
                                    device=device, cache=cache, **kw)))
        if kernels:
            for kname, entry in _kernel_benchmarks():
                builder = entry(scn, device=device)
                if builder is None:
                    continue
                add(SweepItem(
                    "kernel", f"kernel::{kname}::{scn.key()}",
                    f"kernel:{kname} @ {scn.key()}",
                    lambda reps, min_time, b=builder:
                        _measure_kernel(b, reps, min_time)))

    if dt:
        for (s, t) in default_dt_graph().direct_edges:
            for shape in sorted(shapes):
                if not transform_feasible(s, t, shape):
                    continue
                add(SweepItem(
                    "dt", transform_cost_key(s, t, shape),
                    f"dt:{s}->{t} @ {'x'.join(map(str, shape))}",
                    lambda reps, min_time, s=s, t=t, shape=shape:
                        measure_transform(s, t, shape, reps=reps,
                                          min_time=min_time,
                                          device=device)))
    return items


def _measure_kernel(builder, reps: int, min_time: float) -> float:
    from ..core.costs import time_callable
    fn, args = builder()
    return time_callable(fn, args, reps=reps, min_time=min_time)


# ----------------------------------------------------------------------
# execution
# ----------------------------------------------------------------------
def run_sweep(profile: HardwareProfile, items: Sequence[SweepItem], *,
              reps: Optional[int] = None,
              min_time: Optional[float] = None,
              save_path=None, save_every: int = 20,
              max_entries: Optional[int] = None,
              progress: Optional[Callable[[int, int, SweepItem, float],
                                          None]] = None,
              measure: Optional[Callable[[SweepItem], float]] = None
              ) -> Dict[str, int]:
    """Measure every item the profile does not already hold.

    Resumable by construction: covered keys are skipped, and the profile
    is saved every ``save_every`` measurements (plus once at the end)
    when ``save_path`` is given.  ``measure`` overrides how an item is
    timed (tests inject a stub; the default calls ``item.measure`` with
    the profile's recorded reps/min_time discipline).
    Returns ``{"measured", "skipped", "remaining"}``.
    """
    reps = profile.reps if reps is None else reps
    min_time = profile.min_time if min_time is None else min_time
    todo = [it for it in items if it.key not in profile]
    skipped = len(items) - len(todo)
    capped = todo if max_entries is None else todo[:max_entries]
    measured = 0
    for i, item in enumerate(capped):
        t = (measure(item) if measure is not None
             else item.measure(reps, min_time))
        profile.put(item.key, t)
        measured += 1
        if progress is not None:
            progress(i, len(capped), item, t)
        if save_path is not None and measured % save_every == 0:
            profile.save(save_path)
    if save_path is not None and measured:
        profile.save(save_path)
    return {"measured": measured, "skipped": skipped,
            "remaining": len(todo) - measured}
